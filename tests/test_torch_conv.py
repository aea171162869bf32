"""The 3xTF32 convolution (``ops/conv.py``) on the CPU: its plain version's
arithmetic against float64 and float32 convolutions, the TF32 split, the
routing rule of ``layers.conv2d``, the kernel's tiling plan, and the DPT's
conv calls that the kernel takes. The kernel itself runs on the GPU only
(``tests/test_torch_kernels_cuda.py -k conv2d_3xtf32``)."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mast3r_slam_tpu_torch.models import dpt, layers, mast3r
from mast3r_slam_tpu_torch.ops import conv
from mast3r_slam_tpu_torch.utils import kernel_cases


def _rel_rms(a, ref):
    return float((a.double() - ref).norm() / ref.norm())


def _case(c, n, k, hw=(19, 23), b=2, bias=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, *hw, generator=g)
    w = (torch.rand(n, c, k, k, generator=g) * 2 - 1) / math.sqrt(c * k * k)
    bv = (torch.rand(n, generator=g) * 2 - 1) * 0.02 if bias else None
    return x, w, bv


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_plain_3xtf32_is_fp32_accurate(k, stride, bias):
    """Against float64: within 2x of F.conv2d in float32, and at least 100x
    below plain TF32 (one product of operands rounded to TF32)."""
    c = 256 if k == 1 else 64          # K = 256 / 576: a DPT-like depth
    x, w, bv = _case(c, 48, k, bias=bias)
    pad = k // 2
    ref = F.conv2d(x.double(), w.double(),
                   None if bv is None else bv.double(), stride=stride,
                   padding=pad)
    got = conv.conv2d_3xtf32_plain(x, w, bv, stride, pad)
    fp32 = F.conv2d(x, w, bv, stride=stride, padding=pad)
    tf32 = F.conv2d(conv.tf32_round(x), conv.tf32_round(w), bv,
                    stride=stride, padding=pad)
    e, e32, etf = (_rel_rms(t, ref) for t in (got, fp32, tf32))
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert e <= 2.0 * e32, (e, e32)
    assert 100.0 * e <= etf, (e, etf)
    assert _rel_rms(got, fp32.double()) <= 4.0 * e32


def test_tf32_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                   # a TF32 step at 1
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 0.0, -0.0, float("inf"),
                      float("-inf"), torch.finfo(torch.float32).max],
                     dtype=torch.float32)
    got = conv.tf32_round(x)
    want = torch.tensor([one, one + ulp, -(one + ulp), one, one + ulp, 0.0,
                         -0.0, float("inf"), float("-inf"), float("inf")],
                        dtype=torch.float32)
    assert torch.equal(got, want)
    assert torch.isnan(conv.tf32_round(torch.tensor([float("nan")])))[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_hi_lo(seed):
    """hi and lo carry at most 11 significant bits; hi is the nearest TF32
    value and hi + lo is x within 2^-21 of |x| (lo rounded toward zero)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        (rng.standard_normal(4096) * 10.0 ** rng.uniform(-20, 20, 4096))
        .astype(np.float32))
    hi, lo = conv.split_tf32(x)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -21).all())
    assert bool(((x.double() - hi.double()).abs()
                 <= hi.double().abs() * 2.0 ** -11).all())
    assert torch.equal(conv.tf32_trunc(torch.tensor([1.0 + 2.0 ** -11,
                                                     -(1.0 + 2.0 ** -11)])),
                       torch.tensor([1.0, -1.0]))
    hi_inf, lo_inf = conv.split_tf32(torch.tensor([float("inf"), 1.5]))
    assert hi_inf[0] == float("inf") and torch.isnan(lo_inf[0])


@pytest.mark.parametrize("device,dtype,grad,want", [
    ("cuda", torch.float32, False, True),
    ("cuda:1", torch.float32, False, True),
    ("cpu", torch.float32, False, False),
    ("cuda", torch.float32, True, False),
    ("cuda", torch.bfloat16, False, False),
    ("cuda", torch.float64, False, False),
])
def test_routing_rule(device, dtype, grad, want):
    assert conv.takes_kernel(torch.device(device), dtype, grad) is want


@pytest.mark.parametrize("dtype,grad", [(torch.float32, False),
                                        (torch.float32, True),
                                        (torch.bfloat16, False)])
def test_layers_conv2d_keeps_f_conv2d_off_cuda(monkeypatch, dtype, grad):
    """On the CPU, under autograd and in bf16, layers.conv2d is F.conv2d
    plus the fp32 bias, bit for bit, and never calls the kernel's
    wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(conv, "conv2d_3xtf32", refuse)
    mod = torch.nn.Conv2d(8, 16, 3, padding=1)
    x = torch.randn(2, 8, 9, 11)
    with torch.set_grad_enabled(grad):
        got = layers.conv2d(mod, x, dtype=dtype)
        want = F.conv2d(x.to(dtype), mod.weight.to(dtype),
                        padding=1).float() + mod.bias.float()[:, None, None]
    assert torch.equal(got, want)
    assert got.requires_grad == grad


def test_layers_conv2d_routes_cuda_fp32_to_kernel(monkeypatch):
    """With the rule saying yes, layers.conv2d hands x, the weight, the
    fp32 bias, stride and padding to the wrapper and returns its result."""
    seen = []

    def fake(x, w, bias, stride, padding):
        seen.append((x, w, bias, stride, padding))
        return torch.zeros(1)

    monkeypatch.setattr(conv, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(conv, "conv2d_3xtf32", fake)
    mod = torch.nn.Conv2d(8, 16, 3, stride=2, padding=1)
    x = torch.randn(1, 8, 9, 11)
    out = layers.conv2d(mod, x, dtype=torch.float32, stride=2, padding=1)
    assert out.shape == (1,)
    (sx, sw, sb, st, pad), = seen
    assert sx is x and sw is mod.weight and torch.equal(sb, mod.bias)
    assert (st, pad) == (2, 1)


def test_wrapper_on_cpu_is_the_plain_version():
    x, w, bv = _case(16, 8, 3, hw=(7, 9))
    assert torch.equal(conv.conv2d_3xtf32(x, w, bv, 2, 1),
                       conv.conv2d_3xtf32_plain(x, w, bv, 2, 1))


@pytest.mark.parametrize("n,bn", [(256, 128), (768, 128), (128, 128),
                                  (384, 128), (192, 64), (96, 32), (48, 16),
                                  (4, 16)])
def test_tile_n(n, bn):
    assert conv.tile_n(n) == bn


@pytest.mark.parametrize("b", [1, 2, 8])
def test_plan_at_every_dpt_conv(b):
    """Every conv of a ViT-L head_forward: a tile from the kernel's set,
    K ranges of whole chunks covering K with none empty, and a grid that
    fills at most the resident blocks twice over where K is split."""
    cfg = mast3r.MASt3RConfig(head_dtype="float32")
    for (bb, c, h, w), (n, _, r, s), stride, pad, _ in \
            kernel_cases.dpt_conv_shapes(cfg, b):
        ho = (h + 2 * pad - r) // stride + 1
        wo = (w + 2 * pad - s) // stride + 1
        m = bb * ho * wo
        bn, per, splits = conv.plan(m, n, c, r, s, 132)
        nk = r * s * math.ceil(c / conv.BK)
        assert bn in conv.TILES_N and c % 4 == 0
        assert (splits - 1) * per < nk <= splits * per
        tiles = math.ceil(m / conv.BM) * math.ceil(n / bn)
        if splits > 1:
            assert per >= 4
            assert tiles * splits <= 132 * conv.BLOCKS_PER_SM[bn]


def test_plan_splits_small_maps_only():
    # the 12 x 16 level at batch 1 (layer4_rn: K = 9 x 768): split K
    assert conv.plan(192, 256, 768, 3, 3, 132) == (128, 7, 31)
    # the full-resolution head conv: one range
    assert conv.plan(196608, 128, 128, 3, 3, 132) == (128, 36, 1)


@pytest.mark.parametrize("b", [1, 2])
def test_dpt_conv_shapes_of_vitl512(b):
    """30 convs a head_forward, 186 GFLOP at b = 1, the shapes the kernel's
    GPU tests and records run."""
    cfg = mast3r.MASt3RConfig(head_dtype="float32")
    shapes = kernel_cases.dpt_conv_shapes(cfg, b)
    assert len(shapes) == 30
    flops = 0
    for (bb, c, h, w), (n, cw, r, s), stride, pad, _ in shapes:
        assert bb == b and cw == c
        ho = (h + 2 * pad - r) // stride + 1
        wo = (w + 2 * pad - s) // stride + 1
        flops += 2 * bb * ho * wo * n * c * r * s
    assert flops == b * 186_252_263_424
    assert shapes[-1][1] == (4, 128, 1, 1)       # the final fp32 1x1 conv
    assert sum(1 for sh in shapes if sh[2] == 2) == 1


def test_dpt_conv_calls_match_tiny_forward(monkeypatch):
    """The traced calls are those a real CPU head_forward makes."""
    cfg = mast3r.TINY
    traced = kernel_cases.dpt_conv_shapes(cfg, 1)
    seen = []
    conv2d = dpt.conv2d

    def record(mod, x, dtype=None, stride=1, padding=None):
        w = mod.weight
        seen.append((tuple(x.shape), tuple(w.shape), stride,
                     w.shape[-1] // 2 if padding is None else padding,
                     mod.bias is not None))
        return conv2d(mod, x, dtype=dtype, stride=stride, padding=padding)

    model = mast3r.init_params(cfg, device="cpu")
    n_dec = cfg.dec_depth
    grid = (cfg.img_size[0] // cfg.patch_size,
            cfg.img_size[1] // cfg.patch_size)
    n = grid[0] * grid[1]
    g = torch.Generator().manual_seed(0)
    toks = [torch.randn(1, n, cfg.enc_embed_dim, generator=g)] + [
        torch.randn(1, n, cfg.dec_embed_dim, generator=g)
        for _ in range(n_dec)]
    monkeypatch.setattr(dpt, "conv2d", record)
    dpt.head_forward(model.downstream_head1, toks, grid, cfg.patch_size,
                     cfg.desc_dim, (0, n_dec * 2 // 4, n_dec * 3 // 4,
                                    n_dec), cfg.head_compute_dtype)
    assert seen == traced
