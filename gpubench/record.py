"""What a run records from the benchmark's own side of the program's
calls: spans of the program's layers, each network call's kind and batch,
a sample of the network's outputs, and when each frame's work finished on
the device.

Nothing here changes a path of the program. ``Probe`` is handed to
``SLAMSystem.run(viewer=...)``: the run loop calls ``update`` after every
frame or window and ``wait_if_paused`` before, and ``paused`` is always
False, so the loop takes the path it takes without a viewer. ``update``
records a CUDA event on the current stream and returns; a thread of the
benchmark waits on the events, so the program's thread never waits for the
device on the probe's account. ``NetworkShim`` is the ``model_module``: it
forwards the four calls of the model interface to
``models.oracle_timing`` and records them; while a sampled call runs it
keeps a copy of the network's outputs, which ``oracle_timing`` hands to
its ``_total`` and then drops.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch


class Recorder:
    """Spans on the host clock, frames taken and completed, and the
    network's calls, each tagged with the phase of the run."""

    def __init__(self, profile_ranges=False):
        self.spans = []            # (phase, name, t0, t1, extra)
        self.calls = []            # (phase, kind, batch, t0, t1)
        self.profile_ranges = profile_ranges
        self.index = 0             # frames of the window taken so far
        self.pending = []          # (scan, frame, due, taken) since update
        self.frames = []           # (scan, frame, due, taken, done)
        self.scan = -1
        # called as each frame is taken (the window's profiler starts so)
        self.on_take = None
        # "setup", "window" (the measured window) or "after" (what follows
        # its close)
        self.phase = "setup"

    @contextlib.contextmanager
    def span(self, name, **extra):
        rf = (torch.profiler.record_function(name) if self.profile_ranges
              else contextlib.nullcontext())
        with rf:
            t0 = time.perf_counter()
            try:
                yield extra
            finally:
                self.spans.append((self.phase, name, t0, time.perf_counter(),
                                   extra))

    def next_index(self):
        k = self.index
        self.index += 1
        return k

    def taken(self, frame, due):
        if self.on_take is not None:
            self.on_take()
        self.pending.append((self.scan, frame, due, time.perf_counter()))


class Probe:
    """The run loop's viewer: marks the end of each frame's or window's
    work with a CUDA event (``blocking``: the waiting thread sleeps) and
    lets ``Waiter`` time it."""

    paused = False

    def __init__(self, rec, waiter):
        self.rec = rec
        self.waiter = waiter

    def wait_if_paused(self):
        return None

    def update(self, system, force=False):
        rec = self.rec
        if not rec.pending:
            return
        batch, rec.pending = rec.pending, []
        if torch.cuda.is_available() and system.device.type == "cuda":
            ev = torch.cuda.Event(blocking=True)
            ev.record()
        else:
            ev = None
        self.waiter.put((ev, batch))


class Waiter:
    """A thread that waits for each probe event in turn and stamps its
    frames with the host time at which the event completed."""

    def __init__(self, rec):
        self.rec = rec
        self.q = queue.Queue()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def put(self, item):
        self.q.put(item)

    def _loop(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            ev, batch = item
            if ev is not None:
                ev.synchronize()
            t = time.perf_counter()
            self.rec.frames.extend(b + (t,) for b in batch)

    def close(self, timeout=120.0):
        self.q.put(None)
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError("the probe's waiting thread did not finish")


KINDS = ("encode", "inference_mono", "inference_asymmetric",
         "inference_symmetric")


class Sampler:
    """A reservoir of ``k`` calls a kind, drawn from the seed, over the
    calls of the window."""

    def __init__(self, seed, k):
        self.rng = np.random.default_rng([seed % 2 ** 63, 13])
        self.k = k
        self.seen = {kind: 0 for kind in KINDS}
        self.kept = {kind: [] for kind in KINDS}

    def slot(self, kind):
        """The reservoir slot the next call of ``kind`` takes, or None."""
        n = self.seen[kind]
        self.seen[kind] += 1
        if n < self.k:
            return n
        j = int(self.rng.integers(n + 1))
        return j if j < self.k else None

    def keep(self, kind, slot, record):
        kept = self.kept[kind]
        if slot < len(kept):
            kept[slot] = record
        else:
            kept.append(record)


class NetworkShim:
    """``model_module`` for ``SLAMSystem``: each of the four calls goes to
    ``models.oracle_timing`` under a span and is recorded with its batch.
    Any other attribute is refused and remembered in ``refused``."""

    def __init__(self, target, rec, sampler=None):
        self._target = target
        self._rec = rec
        self._sampler = sampler
        self._capture = None
        self.refused = []
        self._orig_total = target._total

    def install(self):
        """Route ``oracle_timing._total`` through the shim, which keeps the
        network's outputs of a sampled call; ``uninstall`` undoes it."""
        shim = self

        def total(*reals):
            if shim._capture is not None:
                shim._capture["outputs"] = [r.detach().clone() for r in reals]
            return shim._orig_total(*reals)

        self._target._total = total

    def uninstall(self):
        self._target._total = self._orig_total

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        self.__dict__.setdefault("refused", []).append(name)
        raise AttributeError(f"the benchmark's model_module has no {name!r}: "
                             "an uncounted network call")

    def _call(self, kind, batch, fn, inputs, *args):
        rec = self._rec
        slot = None
        if rec.phase == "window" and self._sampler is not None:
            slot = self._sampler.slot(kind)
        if slot is not None:
            self._capture = {"kind": kind, "scan": rec.scan,
                             "inputs": inputs(), "outputs": None}
        t0 = time.perf_counter()
        try:
            with rec.span("net." + kind, batch=batch):
                out = fn(*args)
        finally:
            cap, self._capture = self._capture, None
        rec.calls.append((rec.phase, kind, batch, t0, time.perf_counter()))
        if cap is not None:
            self._sampler.keep(kind, slot, cap)
        return out

    def encode(self, params, img, cfg):
        return self._call("encode", img.shape[0], self._target.encode,
                          lambda: {"img": img.detach().clone()},
                          params, img, cfg)

    def inference_mono(self, params, feat, pos, cfg, ds=1):
        return self._call("inference_mono", feat.shape[0],
                          self._target.inference_mono,
                          lambda: {"feat1": feat.detach().clone(), "ds": ds},
                          params, feat, pos, cfg, ds)

    def inference_asymmetric(self, params, feat_f, pos_f, feat_k, pos_k, cfg):
        return self._call("inference_asymmetric", feat_f.shape[0],
                          self._target.inference_asymmetric,
                          lambda: {"feat1": feat_f.detach().clone(),
                                   "feat2": feat_k.detach().clone()},
                          params, feat_f, pos_f, feat_k, pos_k, cfg)

    def inference_symmetric(self, params, feat_i, pos_i, feat_j, pos_j, cfg):
        return self._call("inference_symmetric", feat_i.shape[0],
                          self._target.inference_symmetric,
                          lambda: {"feat1": feat_i.detach().clone(),
                                   "feat2": feat_j.detach().clone()},
                          params, feat_i, pos_i, feat_j, pos_j, cfg)
