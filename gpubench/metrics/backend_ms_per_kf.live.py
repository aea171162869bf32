"""Wall ms of the ``backend_step`` calls that did work (one a keyframe, or
a relocalization), over the window, per such call."""


def read(ctx):
    spans = [s for s in ctx.window_spans(("backend_step",)) if s[4].get("did")]
    if not spans:
        return None
    return 1e3 * sum(s[3] - s[2] for s in spans) / len(spans)
