"""Network FLOPs of the window's calls (counted from their kinds and
batches, ``reference/work.py``) over the window's seconds, as a share of
the H100's dense bf16 peak, in %."""

from gpubench.reference import work


def read(ctx):
    flops = sum(work.call_flops(ctx.m, kind, b)
                for phase, kind, b, _, _ in ctx.calls if phase == "window")
    if not flops:
        return None
    return 100.0 * flops / ctx.seconds / work.PEAK_BF16_FLOPS
