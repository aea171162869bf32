"""2-D rotary position embedding (``mast3r_slam_tpu/models/rope.py``).

The head dim splits in half: the first half rotates by the token's y, the
second by its x; within a half, feature i pairs with feature i + d/4.
Plain PyTorch on the slice's path.
"""

from __future__ import annotations

import torch


def rope_tables(positions, d: int, base: float, dtype):
    """(cos, sin), each (b, 1, n, d), of 2-D RoPE at head dim ``d``. The
    encoder and decoder build them once per forward pass and reuse them in
    every block."""
    half = d // 2
    inv_freq = 1.0 / (base ** (torch.arange(0, half, 2, dtype=torch.float32,
                                            device=positions.device) / half))

    def ang(p):
        a = p[..., None].to(torch.float32) * inv_freq
        return torch.cat([a, a], dim=-1)

    a = torch.cat([ang(positions[..., 0]), ang(positions[..., 1])], dim=-1)
    return torch.cos(a)[:, None].to(dtype), torch.sin(a)[:, None].to(dtype)


def apply_rope(tokens, tables):
    """``rope_2d`` with precomputed ``rope_tables``; the same per-element
    arithmetic."""
    cos, sin = tables
    q = tokens.shape[-1] // 4
    x = tokens
    rot = torch.cat([-x[..., q:2 * q], x[..., :q],
                     -x[..., 3 * q:], x[..., 2 * q:3 * q]], dim=-1)
    return x * cos + rot * sin


def rope_2d(tokens, positions, base: float = 100.0):
    """tokens (b, heads, n, d), d % 4 == 0; positions (b, n, 2) (y, x)."""
    d = tokens.shape[-1]
    assert d % 4 == 0, "RoPE2D needs head dim divisible by 4"
    return apply_rope(tokens, rope_tables(positions, d, base, tokens.dtype))
