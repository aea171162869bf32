"""Share of the traced part of the window in which the device ran nothing
while the program's main thread was inside the network (a ``mast3r.*``
span) and not waiting for the device (a ``sync.*`` span), in %: the time
the host spends enqueuing the network's kernels faster than it keeps the
device fed. The spans are mapped onto the profiler's clock through the
program's clock anchor (``timing.to_unix_ns``)."""

from gpubench import program, trace


def read(ctx):
    if ctx.device is None or ctx.window_s <= 0:
        return None
    got = program.traced(ctx)
    if got is None:
        return None
    from mast3r_slam_tpu_torch.utils import timing

    spans, lo, hi = got
    net = trace.merge(program.on_main(spans,
                                      lambda n: n.startswith("mast3r.")),
                      lo, hi)
    waits = trace.merge(program.on_main(spans,
                                        lambda n: n.startswith("sync.")),
                        lo, hi)
    host = [(timing.to_unix_ns(a) * 1e-9, timing.to_unix_ns(b) * 1e-9)
            for a, b in program.subtract(net, waits)]
    if not host:
        return None
    busy = trace.merge([(a, b) for _, a, b in ctx.device],
                       host[0][0], host[-1][1])
    idle = sum(b - a for a, b in program.subtract(host, busy))
    return 100.0 * idle / ctx.window_s
