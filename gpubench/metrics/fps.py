"""Frames whose work had completed on the device when the window closed,
over the window's seconds: all the work and all the time of the window."""


def read(ctx):
    done = sum(1 for f in ctx.frames if f[4] <= ctx.t1)
    return done / ctx.seconds if done else None
