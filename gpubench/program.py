"""The program's own spans, for the per-layer metrics that rest on them.

``mast3r_slam_tpu_torch.utils.timing`` records spans while a profiler
runs, so a traced run holds the program's spans of the traced part of the
window. They are read in-process and clipped to that part: from the
profiler's start (``ctx.trace_t0``) for ``ctx.window_s`` seconds (to the
window's close where the run has no device trace). A program that records
no spans gives None, and so does each metric that reads them.
"""

from __future__ import annotations

import threading

from . import trace


def traced(ctx):
    """(spans, lo, hi): the program's closed spans that overlap the traced
    part [lo, hi] (``perf_counter`` ns), or None."""
    if ctx.trace_t0 is None:
        return None
    try:
        from mast3r_slam_tpu_torch.utils import timing
    except ImportError:
        return None
    if not hasattr(timing, "spans"):
        return None
    lo = int(ctx.trace_t0 * 1e9)
    end = ctx.trace_t0 + ctx.window_s if ctx.window_s > 0 else ctx.t1
    hi = int(end * 1e9)
    spans = [s for s in timing.spans()
             if s.t1 is not None and s.t1 > lo and s.t0 < hi]
    return (spans, lo, hi) if spans else None


def main_thread():
    return threading.main_thread().native_id


def on_main(spans, test):
    """[(t0, t1)] of the main thread's spans whose name passes ``test``."""
    main = main_thread()
    return [(s.t0, s.t1) for s in spans if s.thread == main and test(s.name)]


def share(ctx, test):
    """Share of the traced part, in %, inside the main thread's spans
    whose name passes ``test``, or None where there is none."""
    got = traced(ctx)
    if got is None:
        return None
    spans, lo, hi = got
    inside = on_main(spans, test)
    if not inside:
        return None
    return 100.0 * seconds(inside, lo, hi) / ((hi - lo) * 1e-9)


def seconds(intervals, lo, hi):
    """Seconds of [lo, hi] (ns) covered by ``intervals`` (ns)."""
    return sum(b - a for a, b in trace.merge(intervals, lo, hi)) * 1e-9


def started(spans, name, lo, hi):
    """The spans ``name`` that began inside [lo, hi]."""
    return [s for s in spans if s.name == name and lo <= s.t0 < hi]


def subtract(a, b):
    """The parts of the merged intervals ``a`` outside the merged ``b``."""
    out, j = [], 0
    for lo, hi in a:
        t = lo
        while j < len(b) and b[j][1] <= t:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > t:
                out.append((t, b[k][0]))
            t = max(t, b[k][1])
            k += 1
        if t < hi:
            out.append((t, hi))
    return out
