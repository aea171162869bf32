"""Placement across devices and processes: the backend on its own device
(``backend_device``), the device mesh with the process group of a
multi-host run (``mesh``), the sharded global bundle adjustment
(``dist_ba``, ``schur``) and data-parallel tracking with the sharded edge
decode (``dp_tracking``, imported on its own: it builds on
``slam.system``, which imports this package). Every module of the JAX
package's ``parallel/`` has its counterpart here."""

from . import backend_device, dist_ba, mesh, schur

__all__ = ["backend_device", "dist_ba", "mesh", "schur"]
