"""Wall ms of ``make_frame`` and ``process_frame`` (the per-frame path:
encode, the tracker's window body, its one read) a tracked frame, over the
window."""


def read(ctx):
    spans = ctx.window_spans(("make_frame", "process_frame"))
    n = sum(1 for s in spans if s[1] == "process_frame")
    if not n:
        return None
    return 1e3 * sum(s[3] - s[2] for s in spans) / n
