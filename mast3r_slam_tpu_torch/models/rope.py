"""2-D rotary position embedding (``mast3r_slam_tpu/models/rope.py``).

The head dim splits in half: the first half rotates by the token's y, the
second by its x; within a half, feature i pairs with feature i + d/4.

``rope_qk`` is what the attention code calls: q and k rotated and cast to
the attention dtype. For CUDA tensors it is one launch of the hand-written
kernel ``csrc/rope_qk.cu`` (replaces ``rope_2d``, ``rope.py:33``, applied to
q and k, ``vit.py:57-59``); for CPU tensors it runs the plain version,
``apply_rope`` plus the cast. Nothing else falls back.
"""

from __future__ import annotations

import torch

from ..ops import _kernels


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


def rope_qk_plain(q, k, q_tables, k_tables, out_dtype=torch.float32):
    """``apply_rope`` on q and on k, then the cast."""
    return (apply_rope(q, q_tables).to(out_dtype),
            apply_rope(k, k_tables).to(out_dtype))


def _table_stride(tables, b, n, d, name):
    """Checks a (cos, sin) pair of ``rope_tables``, each (bt, 1, n, d) or
    (bt, n, d) dense fp32 with bt = 1 or b; returns the batch stride."""
    c, s = tables
    for t in (c, s):
        if (not t.is_cuda or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape[-2:]) != (n, d)
                or t.numel() not in (n * d, b * n * d)):
            raise ValueError(f"{name}: expected dense CUDA fp32 tables of "
                             f"{n} tokens x {d} for batch 1 or {b}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if c.shape != s.shape:
        raise ValueError(f"{name}: cos and sin shapes differ")
    return 0 if c.numel() == n * d else n * d


def rope_qk(q, k, q_tables, k_tables, out_dtype=torch.float32):
    """2-D RoPE of q (b, heads, nq, d) and k (b, heads, nk, d), fp32 views
    with a dense feature axis (any other strides), by the ``rope_tables`` of
    their positions; returns dense (b, heads, n, d) tensors of ``out_dtype``
    (fp32 or bf16)."""
    if q.device.type == "cpu":
        return rope_qk_plain(q, k, q_tables, k_tables, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rope_qk: out_dtype must be fp32 or bf16, got "
                         f"{out_dtype}")
    b, heads, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, heads, nk, d) or d % 4:
        raise ValueError(f"rope_qk: q {tuple(q.shape)} and k {tuple(k.shape)}"
                         " must share batch, heads and a head dim % 4 == 0")
    if (not k.is_cuda or q.dtype != torch.float32
            or k.dtype != torch.float32):
        raise ValueError(f"rope_qk: expected CUDA fp32 q and k, got "
                         f"{q.dtype} on {q.device}, {k.dtype} on {k.device}")
    qs, ks = q.stride(), k.stride()
    if qs[3] != 1 or ks[3] != 1:
        raise ValueError("rope_qk: the feature axis of q and k must be dense")
    tbq = _table_stride(q_tables, b, nq, d, "rope_qk q tables")
    tbk = _table_stride(k_tables, b, nk, d, "rope_qk k tables")
    q_out = torch.empty((b, heads, nq, d), dtype=out_dtype, device=q.device)
    k_out = torch.empty((b, heads, nk, d), dtype=out_dtype, device=q.device)
    tensors = (q, k, *q_tables, *k_tables, q_out, k_out)
    strides = (qs[0], qs[1], qs[2], ks[0], ks[1], ks[2])
    vec4 = int(d % 16 == 0 and not any(s % 4 for s in strides)
               and not any(t.data_ptr() % 16 for t in tensors))
    _kernels.launch("rope_qk", *tensors, *strides, tbq, tbk, b, heads, nq, nk,
                    d, int(out_dtype == torch.bfloat16), vec4)
    return q_out, k_out
