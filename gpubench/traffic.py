"""The one traffic generator: a mix is a JSON file of parameters,
``gpubench/traffic/<name>.json``, read by ``load`` and turned into scans.

Keys of a mix:

- ``orbit_frames``: poses of bench.py's orbit (``reference/scene.py``);
- ``scan_frames``: frames of one scan, which sweeps the orbit forth and
  back (``scene.make_scan``), so that later legs revisit the map;
- ``warm_frames``: frames of the set-up's warm scan;
- ``kf_every``: the tracker's keyframe cadence (0: the algorithm's own);
- ``desc_freq``, ``step_scale``: the oracle's descriptor frequency and the
  orbit's step;
- ``phase``: [lo, hi], the range each scan's start phase is drawn from;
- ``arrival``: ``"closed"`` (the next frame as soon as the system takes
  it) or ``{"rate_hz": r}`` (frame k of the window is due at k / r seconds
  after the window opens, whether or not the system has taken the earlier
  ones; nothing is dropped);
- ``tracking_window`` (optional): the frames a tracking dispatch that this
  kind of user runs with, in place of the configuration's.

Every scan of a run is drawn from the run's seed: its phase and the order
of the frame pool. One scan fills the window; should it end first, the
next follows with a system of its own.
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np

from .reference import scene

ROOT = pathlib.Path(__file__).resolve().parent


class WindowClosed(Exception):
    """Raised by a scan's dataset when the window has closed."""


def load(name):
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


class Clock:
    """The window's schedule: ``open`` starts it; ``due(k)`` is when frame k
    of the window is due (None in a closed loop); ``closes`` is the time
    the window ends."""

    def __init__(self, mix, seconds):
        arr = mix["arrival"]
        self.rate = None if arr == "closed" else float(arr["rate_hz"])
        self.seconds = float(seconds)
        self.t0 = None

    def open(self):
        self.t0 = time.perf_counter()

    @property
    def closes(self):
        return self.t0 + self.seconds

    def due(self, k):
        return None if self.rate is None else self.t0 + k / self.rate


class Scans:
    """The scans of one run: ``scan(c)`` gives scan c's poses (float32,
    (n, 8)) and its dataset."""

    def __init__(self, mix, seed, h, w):
        self.mix = mix
        self.orbit = int(mix["orbit_frames"])
        self.h, self.w = h, w
        rng = np.random.default_rng([seed % 2 ** 63, 11])
        self.pool = scene.frame_pool(rng, 2 * self.orbit, h, w)
        self.rng = np.random.default_rng([seed % 2 ** 63, 12])

    def scan(self, c, n=None, clock=None, counter=None):
        """Scan ``c`` of ``n`` frames (default ``scan_frames``)."""
        n = int(self.mix["scan_frames"]) if n is None else int(n)
        lo, hi = self.mix["phase"]
        phase = float(lo + (hi - lo) * self.rng.random())
        order = self.rng.permutation(len(self.pool))
        traj = scene.make_scan(n, self.orbit, phase,
                               float(self.mix["step_scale"]))
        frames = [self.pool[order[i % len(order)]] for i in range(n)]
        ds = ScanDataset(frames, max(self.h, self.w), clock, counter)
        ds.phase = phase
        return traj, ds


class ScanDataset:
    """In-memory dataset of one scan for ``SLAMSystem.run``
    (``img_size``, ``len``, ``[i]`` -> (timestamp, uint8 frame)). Frame i
    carries its id in two pixels. With a ``clock``, taking a frame first
    waits until it is due, and raises ``WindowClosed`` for a frame due
    after the window (in a closed loop: taken after it). ``counter``
    (``Recorder``) numbers the frames of the window and hears each one
    taken."""

    def __init__(self, frames, img_size, clock=None, counter=None):
        self.frames = frames
        self.img_size = img_size
        self.clock = clock
        self.counter = counter

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        clock = self.clock
        due = None
        if clock is not None:
            k = self.counter.next_index()
            due = clock.due(k)
            now = time.perf_counter()
            if (due if due is not None else now) >= clock.closes:
                raise WindowClosed
            if due is not None and due > now:
                time.sleep(due - now)
        if self.counter is not None:
            self.counter.taken(i, due)
        return float(i), scene.stamp(self.frames[i], i)
