"""Share of the traced part of the window in which no kernel, copy or fill
ran on the device, in %."""


def read(ctx):
    if ctx.device is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
