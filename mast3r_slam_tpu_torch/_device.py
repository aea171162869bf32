"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and no
    GPU is visible. The port never falls back to the CPU on its own: the
    CPU runs only when the caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def exact_fp32():
    """Make fp32 mean fp32: cuDNN convolutions default to TF32 (about three
    decimal digits), and so may matmuls under some settings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
