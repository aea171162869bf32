"""The program's waits for the device (``sync.*`` spans) begun in the
traced part of the window, per frame the run loop ran there (a
``run.frame`` span's one frame, a ``run.window`` span's frames)."""

from gpubench import program


def read(ctx):
    got = program.traced(ctx)
    if got is None:
        return None
    spans, lo, hi = got
    syncs = sum(1 for s in spans
                if s.name.startswith("sync.") and lo <= s.t0 < hi)
    frames = sum((s.attrs or {}).get("frames", 0)
                 for name in ("run.frame", "run.window")
                 for s in program.started(spans, name, lo, hi))
    return syncs / frames if frames else None
