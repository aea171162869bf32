"""Building blocks of the network: compute-dtype linear/conv calls and the
torch-semantics resize helpers.

Counterpart of ``mast3r_slam_tpu/models/layers.py``. Weights live in
``nn.Linear`` / ``nn.Conv2d`` / ``nn.ConvTranspose2d`` modules named after
the reference checkpoint; these helpers run them the JAX way: operands in
the compute dtype, fp32 result, fp32 bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv


def linear(mod: nn.Linear, x, dtype=None):
    """x @ W^T in ``dtype`` (default: x's), fp32 result plus fp32 bias."""
    w = mod.weight
    if dtype is not None:
        x = x.to(dtype)
        w = w.to(dtype)
    else:
        w = w.to(x.dtype)
    y = F.linear(x, w).float()
    if mod.bias is not None:
        y = y + mod.bias.float()
    return y


def layernorm(mod: nn.LayerNorm, x):
    """LayerNorm in fp32, result in x's dtype."""
    y = F.layer_norm(x.float(), mod.normalized_shape, mod.weight.float(),
                     mod.bias.float(), mod.eps)
    return y.to(x.dtype)


class Mlp(nn.Module):
    """Two-layer GELU MLP (``fc1``, ``fc2``)."""

    def __init__(self, din, hidden, dout=None):
        super().__init__()
        self.fc1 = nn.Linear(din, hidden)
        self.fc2 = nn.Linear(hidden, dout or din)

    def run(self, x, dtype=None):
        h = F.gelu(linear(self.fc1, x, dtype), approximate="none")
        return linear(self.fc2, h, dtype)


def conv2d(mod: nn.Conv2d, x, dtype=None, stride=1, padding=None):
    """NCHW conv in ``dtype``; fp32 result plus fp32 bias. ``padding``
    defaults to k // 2 (what JAX "SAME" gives at stride 1). A CUDA fp32
    conv with no gradient recorded runs ``ops/conv.py``'s 3xTF32 kernel
    (channels_last result); the rest runs ``F.conv2d``."""
    w = mod.weight
    if dtype is not None:
        x = x.to(dtype)
        w = w.to(dtype)
    else:
        w = w.to(x.dtype)
    if padding is None:
        padding = w.shape[-1] // 2
    if conv.takes_kernel(x.device, x.dtype, torch.is_grad_enabled()):
        bias = None if mod.bias is None else mod.bias.float()
        return conv.conv2d_3xtf32(x, w, bias, stride, padding)
    y = F.conv2d(x, w, stride=stride, padding=padding).float()
    if mod.bias is not None:
        y = y + mod.bias.float()[:, None, None]
    return y


def conv_transpose2d(mod: nn.ConvTranspose2d, x, stride, dtype=None):
    """Kernel == stride transposed conv (weight (in, out, s, s), no flip:
    out[y*s+dy, x*s+dx] = sum_i in[y, x, i] w[i, o, dy, dx]); the JAX
    (s, s, in, out) layout maps to it by a transpose only."""
    w = mod.weight
    if dtype is not None:
        x = x.to(dtype)
        w = w.to(dtype)
    y = F.conv_transpose2d(x, w, stride=stride).float()
    if mod.bias is not None:
        y = y + mod.bias.float()[:, None, None]
    return y


def interpolate_bilinear(x, out_hw, align_corners: bool = True):
    """NCHW bilinear resize with torch ``F.interpolate`` semantics."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def pixel_shuffle(x, r: int):
    """NCHW pixel shuffle (torch semantics: channel = c*r*r + dy*r + dx)."""
    return F.pixel_shuffle(x, r)
