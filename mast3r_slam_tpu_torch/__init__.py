"""PyTorch/CUDA port of the dense SLAM system ``mast3r_slam_tpu``.

The package mirrors the layout of ``mast3r_slam_tpu`` (the JAX reference)
module for module. It imports ``torch`` and never ``jax`` or anything of
the JAX package. Entry points run on the GPU (``device="cuda"``) unless the
caller passes ``device="cpu"``, which selects the plain PyTorch versions of
the hand-written CUDA kernels (``csrc/``).

It does what the JAX package does: the tracking frontend (windowed or
frame by frame), the backend with loop closure and relocalization, the run
loop and the CLI, the backend across devices and processes
(``parallel/``), data-parallel tracking and training (``distill``).
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
