"""Seconds from the process's start to the window's open: imports, the
kernels' build on a checkout's first run, weights and codebook made on the
device, the warm scan, and the window's scan and system."""


def read(ctx):
    return ctx.setup_s
