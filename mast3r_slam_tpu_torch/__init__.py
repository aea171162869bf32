"""PyTorch/CUDA port of the dense SLAM system ``mast3r_slam_tpu``.

The package mirrors the layout of ``mast3r_slam_tpu`` (the JAX reference)
module for module. It imports ``torch`` and never ``jax`` or anything of
the JAX package. Entry points run on the GPU (``device="cuda"``) unless the
caller passes ``device="cpu"``, which selects the plain PyTorch versions of
the hand-written CUDA kernels (``csrc/``).

First slice: the per-frame tracking frontend (encode, asymmetric decode and
heads, matcher, confidence gate, Sim(3) Gauss-Newton, pointmap fusion).
What the slice leaves out raises ``NotImplementedError``; see ROADMAP.md.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
