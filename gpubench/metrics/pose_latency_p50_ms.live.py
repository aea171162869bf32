"""The median over the frames tracked in the traced part of the window of
the time from a frame's take (the benchmark hands it to the program) to
the moment its pose and verdict are on the host (the end of the tracker's
``sync.track_stats`` span), in ms: the tracking step's own latency,
without the time a frame waited in the queue. A span is joined to the
benchmark's frame of the same id taken last before the span began.

Not listed in ``BENCHMARK.json`` yet: ``gpubench/tests/test_gpubench_run.py``
pins the live cell's per-layer set, and widening it comes first."""

import numpy as np

from gpubench import program


def read(ctx):
    got = program.traced(ctx)
    if got is None:
        return None
    spans, lo, hi = got
    taken = {}
    for _, frame, _, t_taken, _ in ctx.frames:
        taken.setdefault(frame, []).append(t_taken)
    lat = []
    for s in program.started(spans, "sync.track_stats", lo, hi):
        before = [t for t in taken.get(s.frame, ()) if t * 1e9 <= s.t0]
        if before:
            lat.append(s.t1 * 1e-9 - max(before))
    return 1e3 * float(np.median(lat)) if lat else None
