"""Share of the traced part of the window in which the program's main
thread waited for the device (inside a ``sync.*`` span of
``mast3r_slam_tpu_torch.utils.timing.host_read`` / ``host_write``), in %."""

from gpubench import program


def read(ctx):
    return program.share(ctx, lambda n: n.startswith("sync."))
