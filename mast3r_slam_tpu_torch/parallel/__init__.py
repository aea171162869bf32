"""Placement across devices on one host: the backend on its own device
(``backend_device``), the device list (``mesh``) and the sharded global
bundle adjustment (``dist_ba``, ``schur``). Multi-host runs and
data-parallel tracking are ROADMAP.md queue 1 items 4 and 5."""

from . import backend_device, dist_ba, mesh, schur

__all__ = ["backend_device", "dist_ba", "mesh", "schur"]
