"""Spans of the program's work, the host's reads of the device and a
profiler trace.

Counterpart of ``mast3r_slam_tpu/utils/timing.py``. ``span(name, ...)``
marks one piece of the program's work (``with span("ba.solve") as sp:``),
and ``host_read(site, *tensors)`` copies tensors to the host inside a span
``sync.<site>`` (``host_write`` the other way), so that every wait of the
host for the device is both timed and counted.

Spans are recorded while a ``torch.profiler`` is enabled, or inside a
``recording()`` block. Otherwise ``span`` reads one flag and returns a
shared object that does nothing. A recorded span holds its name, start and
end (``time.perf_counter_ns``), the span it nests in on its own thread,
the thread, the request it serves (the dataset ``frame`` id, or in the
backend the keyframe index ``kf``; a span given neither takes its
parent's) and a few attributes (``Span.attrs``). One anchor pair of
``(perf_counter_ns, time_ns)`` readings, taken at import and again as each
``recording()`` block starts, lets ``to_unix_ns`` map a stamp onto the unix
clock, which ``torch.profiler``'s events use; NTP slews both clocks alike,
so the pair holds until the wall clock is stepped. The program hands
nothing to the profiler: a profiler range is mirrored onto the device's
timeline, where a trace reader would take it for device work.

``ProfilerTrace`` records a ``torch.profiler`` trace of a block and writes
it, with the program's spans of the block, as one Chrome trace.
"""

from __future__ import annotations

import json
import pathlib
import threading
import time

import numpy as np
import torch

# the flag that torch.profiler sets while it records; read on every span
_profiler = torch.autograd.profiler

MAX_SPANS = 1_000_000


class Span:
    """One recorded span; ``t1`` is None while it is open. ``parent`` is
    the span it nests in on its thread (or None)."""

    __slots__ = ("name", "t0", "t1", "parent", "thread", "frame", "kf",
                 "attrs")

    def __init__(self, name, t0, parent, thread, frame, kf):
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.parent = parent
        self.thread = thread
        self.frame = frame
        self.kf = kf
        self.attrs = None

    def set(self, key, value):
        """An attribute of the work, such as ``iters`` or ``did``."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter_ns()
        _REC.close(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, frame={self.frame}, kf={self.kf}, "
                f"attrs={self.attrs})")


class _Off:
    """What ``span`` returns while nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, key, value):
        pass


_OFF = _Off()


class _Thread(threading.local):
    def __init__(self):
        self.stack = []
        self.id = threading.get_native_id()


def _anchor():
    return time.perf_counter_ns(), time.time_ns()


class _Recorder:
    def __init__(self):
        self.spans = []         # at most MAX_SPANS; later ones are not kept
        self.depth = 0          # open recording() blocks
        self.anchor = _anchor()
        self.local = _Thread()

    def open(self, name, frame, kf, n, batch):
        if len(self.spans) >= MAX_SPANS:
            return _OFF
        t = time.perf_counter_ns()
        local = self.local
        stack = local.stack
        parent = stack[-1] if stack else None
        if frame is None and kf is None and parent is not None:
            frame, kf = parent.frame, parent.kf
        sp = Span(name, t, parent, local.id, frame, kf)
        if n is not None:
            sp.set("n", n)
        if batch is not None:
            sp.set("batch", batch)
        stack.append(sp)
        self.spans.append(sp)
        return sp

    def close(self, sp):
        # an exception may have left inner spans open above it
        stack = self.local.stack
        while stack and stack.pop() is not sp:
            pass


_REC = _Recorder()


def span(name, frame=None, kf=None, n=None, batch=None):
    """A context manager around one piece of the program's work: a
    recorded ``Span`` while a profiler is enabled or a ``recording()``
    block is open, else one shared object that does nothing. ``frame`` /
    ``kf``: the request served; ``n``, ``batch``: attributes known at the
    start (``Span.set`` adds others)."""
    if _REC.depth or _profiler._is_profiler_enabled:
        return _REC.open(name, frame, kf, n, batch)
    return _OFF


_SYNC_NAMES = {}


def _sync(site):
    name = _SYNC_NAMES.get(site)
    if name is None:
        name = _SYNC_NAMES.setdefault(site, "sync." + site)
    return span(name)


def host_read(site, *tensors, wait=None):
    """``tensors`` copied to the host as numpy arrays (the array alone for
    one tensor), after ``wait`` (a ``torch.cuda.Event``) has completed
    where one is given: one wait of the host for the device, recorded as
    the span ``sync.<site>``."""
    with _sync(site):
        if wait is not None:
            wait.synchronize()
        out = [t.cpu().numpy() for t in tensors]
    return out[0] if len(out) == 1 else tuple(out)


def host_write(site, *arrays, device):
    """``arrays`` (numpy) copied to ``device`` as tensors (the tensor alone
    for one array). A copy from pageable host memory to a CUDA device
    first waits for the device's stream, so it is recorded as the span
    ``sync.<site>``."""
    with _sync(site):
        out = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for a in arrays]
    return out[0] if len(out) == 1 else tuple(out)


class recording:
    """``with recording() as rec:`` records spans inside the block whether
    or not a profiler runs; ``rec.spans`` are the spans recorded since the
    block began (every thread's)."""

    def __init__(self):
        self.start = self.stop = None

    def __enter__(self):
        _REC.anchor = _anchor()
        self.start = len(_REC.spans)
        _REC.depth += 1
        return self

    def __exit__(self, exc_type, exc, tb):
        _REC.depth -= 1
        self.stop = len(_REC.spans)
        return False

    @property
    def spans(self):
        return _REC.spans[self.start:self.stop]


def spans():
    """Every span recorded in this process, in the order they began."""
    return _REC.spans


def to_unix_ns(t):
    """A ``perf_counter_ns`` stamp on the unix clock (ns)."""
    pc, unix = _REC.anchor
    return unix + (t - pc)


# the program's spans get a process row of their own in an exported trace,
# so that they nest apart from the profiler's host events; a number above
# any Linux pid (pid_max is at most 2**22)
_TRACE_PID = 1 << 23


def chrome_events(span_list, base_ns=0):
    """Complete events (Chrome trace format, microseconds after
    ``base_ns`` on the unix clock) of the closed spans in ``span_list``,
    with metadata naming their process row and threads."""
    events = [{"ph": "M", "name": "process_name", "pid": _TRACE_PID,
               "tid": 0, "args": {"name": "mast3r_slam_tpu_torch spans"}}]
    threads = set()
    for s in span_list:
        if s.t1 is None:
            continue
        args = dict(s.attrs or {})
        if s.frame is not None:
            args["frame"] = s.frame
        if s.kf is not None:
            args["kf"] = s.kf
        threads.add(s.thread)
        events.append({"ph": "X", "cat": "program", "name": s.name,
                       "pid": _TRACE_PID, "tid": s.thread,
                       "ts": (to_unix_ns(s.t0) - base_ns) / 1e3,
                       "dur": (s.t1 - s.t0) / 1e3, "args": args})
    events += [{"ph": "M", "name": "thread_name", "pid": _TRACE_PID,
                "tid": t, "args": {"name": f"thread {t}"}}
               for t in sorted(threads)]
    return events


class ProfilerTrace:
    """``with ProfilerTrace(logdir):`` records a ``torch.profiler`` trace
    of the block (CPU, and CUDA where a GPU is visible) and the program's
    spans, and writes both to ``logdir/trace.json`` (Chrome trace format,
    one clock; open it in Perfetto or ``chrome://tracing``). ``prof`` holds
    the profiler afterwards, for ``key_averages()``."""

    def __init__(self, logdir):
        self.logdir = pathlib.Path(logdir)
        self.prof = None
        self.rec = recording()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.rec.__enter__()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.rec.__exit__(*exc)
        self.logdir.mkdir(parents=True, exist_ok=True)
        path = self.logdir / "trace.json"
        self.prof.export_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        doc["traceEvents"] += chrome_events(
            self.rec.spans, int(doc.get("baseTimeNanoseconds", 0)))
        path.write_text(json.dumps(doc))
        return False
