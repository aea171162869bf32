"""The 95th percentile over the window's frames of each frame's latency,
from the time it was due on the camera's clock to the time its work had
completed on the device, in ms."""

import numpy as np


def read(ctx):
    lat = [f[4] - f[2] for f in ctx.frames if f[2] is not None]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
