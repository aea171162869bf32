"""Run the SLAM backend on its own device (``runtime.backend_device``).

Counterpart of ``mast3r_slam_tpu/parallel/backend_device.py``. The factor
graph (edge decode, matching and global bundle adjustment) reads the
keyframe store through a ``BackendMirror`` on the backend device, with its
own copy of the model parameters and its edge buffers there; the frontend
keeps tracking on its device. ``sync()`` copies the rows changed since the
last sync and every pose forward; ``update_T_WCs`` pushes the solved poses
back.

The mirror owns its buffers, also when the backend device is the
frontend's: ``Tensor.to`` would return the frontend's own tensor there, and
the frontend fuses into that store in place, so a missing ``sync()`` would
go unseen.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from ..slam.frame import _avg_confs
from .mesh import normalize_device

__all__ = ["BackendMirror", "params_to", "pick_backend_device"]

_FIELDS = ("X", "C", "N", "feat", "pos")


def _device_of(store) -> torch.device:
    """The device of a keyframe store (``backend_device.py:118``)."""
    return normalize_device(store.T_WC.device)


class BackendMirror:
    """Backend-device copy of the keyframe fields the factor graph reads
    (``backend_device.py:40``): the ``KeyframeStore`` surface of
    ``slam/factor_graph.py`` (``X``, ``T_WC``, ``feat``, ``pos``,
    ``average_confs(rows)``, ``h``, ``w``, ``K``, ``capacity``, ``len``,
    ``update_T_WCs``). The frontend store stays the source of truth for
    everything but the poses, which a solve writes back."""

    def __init__(self, keyframes, device):
        self.main = keyframes
        self.device = normalize_device(device)
        self.capacity = keyframes.capacity
        self.h, self.w = keyframes.h, keyframes.w
        self.remirror()

    def remirror(self):
        """Copy the whole store: at creation and after a checkpoint is
        loaded into the frontend store (``checkpoint.py:138``)."""
        own = lambda t: t.to(self.device, copy=True)
        for name in _FIELDS + ("T_WC",):
            setattr(self, name, own(getattr(self.main, name)))
        self._mirror_n = self.main.n_size

    # -- KeyframeStore surface ------------------------------------------------

    @property
    def K(self):
        K = self.main.K
        return None if K is None else K.to(self.device)

    @property
    def n_size(self):
        return self.main.n_size

    def __len__(self):
        return self.main.n_size

    def average_confs(self, rows: Optional[int] = None):
        """C / N of the first ``rows`` rows (default: all), as
        ``KeyframeStore.average_confs``."""
        rows = self.capacity if rows is None else rows
        return _avg_confs(self.C[:rows], self.N[:rows])

    def update_T_WCs(self, T_WCs):
        """Adopt solved poses (the leading ``T_WCs.shape[0]`` rows) here and
        push them to the frontend store: the backend's one write back."""
        self.T_WC[:T_WCs.shape[0]] = T_WCs
        self.main.update_T_WCs(T_WCs.to(_device_of(self.main)))

    # -- forward sync ---------------------------------------------------------

    def sync(self):
        """Copy the rows changed since the last sync, and every pose.

        The changed rows are those appended since then plus the previous
        latest row, into which the frontend goes on fusing until the next
        promotion; they are one range, so one copy a field. The poses are
        KB-sized and copied whole: the frontend appends keyframe poses and
        relocalization seeds them."""
        n = self.main.n_size
        start = max(0, min(self._mirror_n - 1, n - 1))
        if n > start:
            for name in _FIELDS:
                getattr(self, name)[start:n].copy_(
                    getattr(self.main, name)[start:n])
        self.T_WC.copy_(self.main.T_WC)
        self._mirror_n = n

    def seed_pose(self, idx: int, T):
        """Write pose row ``idx`` on both stores (relocalization seeding)
        without a full sync."""
        self.T_WC[idx] = T.to(self.device)
        self.main.T_WC[idx] = T.to(_device_of(self.main))


def params_to(params, device):
    """The model parameters on ``device``: a module, a tensor, or a dict of
    them (the oracles' parameters). On the device they already live on, the
    same objects (the backend only reads them); elsewhere a copy."""
    device = normalize_device(device)
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, torch.nn.Module):
        first = next(iter(params.parameters()), None)
        if first is None or normalize_device(first.device) == device:
            return params
        return copy.deepcopy(params).to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params


def pick_backend_device(spec, device="cuda", local_devices=None):
    """Resolve ``runtime.backend_device`` to a device, or None
    (``backend_device.py:130``).

    The local devices: ``local_devices`` when given (a list, which may
    repeat a device: ``[cpu, cpu]`` reaches the mirror on the CPU), else
    every visible CUDA device for a run on ``cuda`` and the one CPU device
    on ``cpu``. ``"none"`` / 0 / False -> None (one device). ``"auto"`` /
    True -> the second local device when there is one, else None. An
    integer -> that device index, which must differ from 0 and exist
    (``ValueError`` otherwise, with the JAX package's message).
    """
    if spec is None or spec is False or spec in ("none", "None", "") \
            or (spec == 0 and not isinstance(spec, bool)):
        return None
    if local_devices is not None:
        devs = [normalize_device(d) for d in local_devices]
    else:
        dev = torch.device(device)
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" else [dev])
    # `is True` (not ==): the integer index 1 must not match the bool
    if spec == "auto" or spec is True:
        return devs[1] if len(devs) > 1 else None
    i = int(spec)
    if i <= 0 or i >= len(devs):
        raise ValueError(
            f"backend_device={spec!r} but only {len(devs)} local devices")
    return devs[i]
