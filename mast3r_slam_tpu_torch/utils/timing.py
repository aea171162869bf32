"""Timing utilities: per-stage accumulating timers and a profiler trace.

Counterpart of ``mast3r_slam_tpu/utils/timing.py``. A stage's time is the
host's clock around work that, with ``sync``, ends in a
``torch.cuda.synchronize`` of every visible CUDA device (PyTorch returns
before the device has finished). ``ProfilerTrace`` records a ``torch.profiler`` trace
of the host and, where there is one, the GPU, and writes it as a Chrome
trace into a directory.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict

import torch


def device_sync():
    """Wait for the work queued on every visible CUDA device (a backend may
    sit on another GPU than the frontend); without a GPU there is nothing
    to wait for."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


class Timer:
    """Accumulating per-stage timer; ``sync`` waits for every GPU at both
    ends of a stage."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = {}

    def tic(self, name: str = "default"):
        if self.sync:
            device_sync()
        self._t0[name] = time.perf_counter()

    def toc(self, name: str = "default"):
        if self.sync:
            device_sync()
        dt = time.perf_counter() - self._t0[name]
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    @contextlib.contextmanager
    def section(self, name: str):
        self.tic(name)
        yield
        self.toc(name)

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            avg = self.totals[name] / max(n, 1)
            lines.append(f"{name}: {self.totals[name]:.3f}s total, "
                         f"{avg * 1000:.1f}ms avg over {n}")
        return "\n".join(lines)


_GLOBAL = Timer()


def tic(name: str = "default"):
    _GLOBAL.tic(name)


def toc(name: str = "default"):
    return _GLOBAL.toc(name)


class ProfilerTrace:
    """``with ProfilerTrace(logdir):`` records a ``torch.profiler`` trace of
    the block (CPU, and CUDA where a GPU is visible) and writes it to
    ``logdir/trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``). ``prof`` holds the profiler afterwards, for
    ``key_averages()``."""

    def __init__(self, logdir):
        self.logdir = pathlib.Path(logdir)
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.logdir / "trace.json"))
        return False
