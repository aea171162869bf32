"""Share of the window's wall time spent inside ``backend_step`` calls,
in %."""


def read(ctx):
    t = ctx.span_seconds("backend_step")
    return None if t is None else 100.0 * t / ctx.seconds
