"""Which device runs the SLAM backend (``runtime.backend_device``).

Counterpart of ``mast3r_slam_tpu/parallel/backend_device.py::
pick_backend_device`` (:130). The JAX package can move the factor graph's
work to a second device beside the frontend's (its ``BackendMirror``); the
port has the same rule over its visible devices and runs on one device:
placing the backend on a second GPU is ROADMAP.md queue 1 item 7, so
``SLAMSystem`` raises only when the rule names one.
"""

from __future__ import annotations

import torch


def pick_backend_device(spec, device="cuda"):
    """Resolve ``runtime.backend_device`` to a device, or None.

    The local devices of a run on ``device``: every visible CUDA device on
    ``cuda``, the one CPU device on ``cpu``. ``"none"`` / 0 / False -> None
    (one device). ``"auto"`` / True -> the second local device when there
    is one, else None. An integer -> that device index, which must differ
    from 0 and exist (``ValueError`` otherwise, with the JAX package's
    message).
    """
    if spec is None or spec is False or spec in ("none", "None", "") \
            or (spec == 0 and not isinstance(spec, bool)):
        return None
    dev = torch.device(device)
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    # `is True` (not ==): the integer index 1 must not match the bool
    if spec == "auto" or spec is True:
        return devs[1] if len(devs) > 1 else None
    i = int(spec)
    if i <= 0 or i >= len(devs):
        raise ValueError(
            f"backend_device={spec!r} but only {len(devs)} local devices")
    return devs[i]
