"""fp32 convolution on the tensor cores in split TF32 (3xTF32).

``models/layers.py::conv2d`` sends a convolution here when
``takes_kernel`` holds: a CUDA tensor, float32, no gradient being
recorded (the rule ``models/graphs.py::eager`` uses for the network's
graphs). Everything else (the CPU, training under autograd, bf16 operands)
stays on ``F.conv2d``. For a CUDA tensor ``conv2d_3xtf32`` launches the
hand-written kernel ``csrc/conv2d_3xtf32.cu`` or raises; nothing falls
back. It replaces no Pallas kernel: the JAX package leaves its
convolutions to XLA.

The arithmetic (the kernel's source says how it runs): each fp32 operand v
is split into hi = tf32(v), rounded to nearest with ties away from zero,
and lo = tf32(v - hi), which the tensor cores round toward zero; each
product is hi*hi + hi*lo + lo*hi summed in fp32; lo*lo, about 2^-22 of a
product, is left out. The tensor cores sum each
chunk of 32 channels, and the chunks' sums are added with fp32 adds (the
tensor cores round toward zero: over a whole K that drifts). Its error
against an exact convolution is that of fp32 (plain TF32, one product of
rounded operands, is about a thousand times worse).
``conv2d_3xtf32_plain`` repeats the splits and the three products with
``F.conv2d`` for the tests.

Layouts: the kernel reads x and writes y channels-last (NCHW tensors in
``torch.channels_last`` memory format: the DPT's tokens arrive that way,
and the convolutions' outputs stay so through the DPT's elementwise ops
and resizes) and reads the weight as (N, R, S, C), which is the weight in
channels_last memory format (``MASt3R.store_compute_dtypes`` keeps the
heads' fp32 conv weights so on CUDA). Other layouts are converted here, a
copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _kernels

BM, BK = 128, 32            # the kernel's pixels a block and K chunk
TILES_N = (128, 64, 32, 16)
# resident blocks a multiprocessor by channel tile (the kernel's
# __launch_bounds__, which its shared memory allows)
BLOCKS_PER_SM = {128: 1, 64: 1, 32: 1, 16: 2}


def takes_kernel(device, dtype, grad_enabled) -> bool:
    """The routing rule of ``layers.conv2d``: the kernel for a CUDA
    float32 convolution with no gradient recorded, ``F.conv2d`` for the
    rest (no backward kernel exists; bf16 keeps cuDNN's tensor-core path)."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and not grad_enabled)


def tf32_round(x):
    """fp32 -> the nearest tf32 value (10 mantissa bits), ties away from
    zero, as fp32 with the low 13 bits cleared: the kernel's bit operation
    (inf stays inf, NaN stays NaN or becomes a signed zero)."""
    u = x.contiguous().view(torch.int32)
    return torch.bitwise_and(u + 0x1000, -0x2000).view(     # 0xffffe000
        torch.float32).reshape(x.shape)


def tf32_trunc(x):
    """fp32 -> tf32 toward zero: what the tensor cores read of an fp32
    operand (its top 19 bits)."""
    u = x.contiguous().view(torch.int32)
    return torch.bitwise_and(u, -0x2000).view(torch.float32).reshape(x.shape)


def split_tf32(x):
    """(hi, lo) as the tensor cores use them: hi = tf32_round(x), lo =
    tf32_trunc(x - hi); |hi + lo - x| <= 2^-21 |x|. A non-finite x gives a
    NaN lo."""
    hi = tf32_round(x)
    return hi, tf32_trunc(x - hi)


def conv2d_3xtf32_plain(x, w, bias=None, stride=1, padding=0):
    """The kernel's arithmetic with ``F.conv2d``: the three products of
    the split operands (lo hi, hi lo, hi hi), each an exact product summed
    in fp32, added in that order, then the bias. Call it with TF32 off
    (``_device.exact_fp32``) on CUDA."""
    xh, xl = split_tf32(x.float())
    wh, wl = split_tf32(w.float())

    def conv(a, b):
        return F.conv2d(a, b, stride=stride, padding=padding)

    y = conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    if bias is not None:
        y = y + bias.float()[:, None, None]
    return y


def tile_n(n):
    """The kernel's channel tile for ``n`` output channels: the largest of
    ``TILES_N`` that divides n, else 16 with the last tile masked."""
    return next((t for t in TILES_N if n % t == 0), TILES_N[-1])


def plan(m, n, c, r, s, sms):
    """(bn, per_split, splits) for an (m pixels, n channels, K = r s c)
    product on ``sms`` multiprocessors. Where the output tiles fill under
    half the resident blocks, K is split into ranges of ``per_split``
    chunks of 32 channels (at least 4 a range), so that the small maps at
    batch 1 use the card; ``splits`` ranges, none empty."""
    bn = tile_n(n)
    tiles = math.ceil(m / BM) * math.ceil(n / bn)
    nk = r * s * math.ceil(c / BK)
    slots = sms * BLOCKS_PER_SM[bn]
    per = nk
    if 2 * tiles <= slots:
        per = math.ceil(nk / max(1, min(slots // tiles, nk // 4)))
    return bn, per, math.ceil(nk / per)


def _out_size(size, k, stride, padding):
    return (size + 2 * padding - k) // stride + 1


def conv2d_3xtf32(x, w, bias=None, stride=1, padding=0):
    """``F.conv2d(x, w, stride=stride, padding=padding)`` plus ``bias``
    in 3xTF32: x (B, C, H, W) float32, w (N, C, R, S) float32, bias (N,)
    float32 or None; one ``stride`` and one ``padding`` for both axes.
    Returns (B, N, Ho, Wo) float32 in channels_last memory format. On the
    CPU it runs ``conv2d_3xtf32_plain``; on CUDA one launch (counted under
    ``conv2d_3xtf32``), or ValueError for what the kernel does not take."""
    if x.device.type != "cuda":
        return conv2d_3xtf32_plain(x, w, bias, stride, padding)
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32 or t.dim() != 4:
            raise ValueError(f"conv2d_3xtf32: {name} must be 4-D float32, "
                             f"got {t.dtype} {tuple(t.shape)}")
    b, c, h, wd = x.shape
    n, cw, r, s = w.shape
    if cw != c or c % 4:
        raise ValueError(f"conv2d_3xtf32: x has {c} channels, w {cw}; "
                         "they must agree and be a multiple of 4")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (n,)):
        raise ValueError("conv2d_3xtf32: bias must be float32 of shape "
                         f"({n},), got {bias.dtype} {tuple(bias.shape)}")
    if not (isinstance(stride, int) and isinstance(padding, int)
            and stride >= 1 and padding >= 0):
        raise ValueError(f"conv2d_3xtf32: stride {stride!r} and padding "
                         f"{padding!r} must be ints, >= 1 and >= 0")
    ho = _out_size(h, r, stride, padding)
    wo = _out_size(wd, s, stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"conv2d_3xtf32: a {r}x{s} kernel leaves no "
                         f"output of a {h}x{wd} map")
    x = x.contiguous(memory_format=torch.channels_last)
    w = w.contiguous(memory_format=torch.channels_last)
    if bias is not None:
        bias = bias.contiguous()
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"conv2d_3xtf32: {name} must be 16-byte "
                             "aligned")
    y = torch.empty((b, n, ho, wo), device=x.device, dtype=torch.float32,
                    memory_format=torch.channels_last)
    m = b * ho * wo
    if m == 0:
        return y
    bn, per, splits = plan(m, n, c, r, s, _kernels.sm_count(x.device.index))
    ws = (torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
          if splits > 1 else None)
    _kernels.launch("conv2d_3xtf32", x, w, bias, y, ws, b, h, wd, c, n, r,
                    s, stride, padding, ho, wo, bn, per, splits)
    return y
