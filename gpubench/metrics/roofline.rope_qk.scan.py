"""``rope_qk``'s share of its roofline over the traced part of the window,
in %: the least time its launches' bytes need at the H100's 3.35 TB/s (the
launches and their bytes derived from the network calls made while the
profiler ran, ``reference/work.py``), over the summed device time of its
kernels. Nothing when the trace's launches are not the ones the calls
imply."""

from gpubench.reference import work


def read(ctx):
    if ctx.device is None:
        return None
    launches, nbytes = 0, 0
    for _, kind, b, _, _ in ctx.traced_calls():
        for n, per in work.rope_launches(ctx.m, kind, b):
            launches += n
            nbytes += n * per
    ks = [t1 - t0 for name, t0, t1 in ctx.device if "rope_qk" in name]
    if not ks or len(ks) != launches:
        ctx.note(f"roofline.rope_qk: {len(ks)} kernels in the trace, "
                 f"{launches} implied by the calls")
        return None
    return 100.0 * nbytes / work.PEAK_HBM_BYTES / sum(ks)
