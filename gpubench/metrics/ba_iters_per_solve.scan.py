"""Gauss-Newton iterations (``ba.iter`` spans) per global bundle
adjustment (``ba.solve`` span) of the solves begun and ended in the traced
part of the window."""

from gpubench import program


def read(ctx):
    got = program.traced(ctx)
    if got is None:
        return None
    spans, lo, hi = got
    solves = {id(s) for s in program.started(spans, "ba.solve", lo, hi)
              if s.t1 <= hi}
    if not solves:
        return None
    iters = sum(1 for s in spans
                if s.name == "ba.iter" and id(s.parent) in solves)
    return iters / len(solves)
