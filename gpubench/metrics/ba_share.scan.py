"""Share of the traced part of the window inside the backend's global
bundle adjustment (the program's ``ba.solve`` spans), in %."""

from gpubench import program


def read(ctx):
    return program.share(ctx, lambda n: n == "ba.solve")
