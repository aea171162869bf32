"""MASt3R two-view pointmap model: config, module, init and inference.

Counterpart of ``mast3r_slam_tpu/models/mast3r.py``. ``MASt3R`` is an
``nn.Module`` whose parameter names are those of the released checkpoint
(``mast3r_slam_tpu/models/convert.py::export_state_dict``, :363), so a
reference ``state_dict`` loads with ``load_state_dict``. The inference
functions keep the JAX signatures with the module in place of the
parameter pytree, and NHWC outputs.

Weights of the transformer live in the compute dtype (``cfg.dtype``) and
those of the head in ``cfg.head_dtype`` (the last head conv stays fp32);
biases and norms stay fp32. The JAX package casts per call to the same
effect. A trainable model (``init_params(..., trainable=True)``) keeps
every weight in fp32, as JAX's ``init_params`` does, and the layers cast
per call; ``encode_body`` and ``decode_pair_body`` are the grad-enabled
forward passes that ``encode`` and ``decode_pair`` run under
``torch.no_grad()``, on CUDA replayed from a graph of their call's shapes
(``models/graphs.py``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch import nn

from .._device import exact_fp32, resolve_device
from ..utils import timing
from . import dpt, graphs, vit


class MASt3RConfig(NamedTuple):
    img_size: tuple = (384, 512)      # (h, w), landscape
    patch_size: int = 16
    enc_depth: int = 24
    enc_embed_dim: int = 1024
    enc_num_heads: int = 16
    dec_depth: int = 12
    dec_embed_dim: int = 768
    dec_num_heads: int = 12
    mlp_ratio: int = 4
    rope_base: float = 100.0
    desc_dim: int = 24
    feature_dim: int = 256            # DPT fusion width
    last_dim: int = 128               # head penultimate width
    layer_dims: tuple = (96, 192, 384, 768)
    dtype: str = "bfloat16"           # transformer compute dtype
    head_dtype: str = "float32"       # DPT/MLP head compute dtype

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def head_compute_dtype(self):
        return getattr(torch, self.head_dtype)

    @property
    def num_patches(self):
        return (self.img_size[0] // self.patch_size) * (
            self.img_size[1] // self.patch_size)


TINY = MASt3RConfig(
    img_size=(64, 96), enc_depth=2, enc_embed_dim=64, enc_num_heads=4,
    dec_depth=4, dec_embed_dim=48, dec_num_heads=4, desc_dim=8,
    feature_dim=32, last_dim=16, layer_dims=(16, 16, 16, 48), dtype="float32",
)


class MASt3R(nn.Module):
    """AsymmetricMASt3R inference modules, reference-named."""

    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        ed, dd = cfg.enc_embed_dim, cfg.dec_embed_dim
        self.patch_embed = vit.PatchEmbed(cfg.patch_size, ed)
        self.enc_blocks = nn.ModuleList(
            [vit.EncoderBlock(ed, cfg.mlp_ratio) for _ in range(cfg.enc_depth)])
        self.enc_norm = nn.LayerNorm(ed, eps=1e-6)
        self.decoder_embed = nn.Linear(ed, dd)
        self.dec_blocks = nn.ModuleList(
            [vit.DecoderBlock(dd, cfg.mlp_ratio) for _ in range(cfg.dec_depth)])
        self.dec_blocks2 = nn.ModuleList(
            [vit.DecoderBlock(dd, cfg.mlp_ratio) for _ in range(cfg.dec_depth)])
        self.dec_norm = nn.LayerNorm(dd, eps=1e-6)
        self.downstream_head1 = dpt.Head(cfg)
        self.downstream_head2 = dpt.Head(cfg)
        self.cfg = cfg

    @torch.no_grad()
    def store_compute_dtypes(self):
        """Keep matmul/conv weights in their compute dtype (biases, norms
        and the final head conv stay fp32). On CUDA the heads' fp32 conv
        weights are kept channels_last: (N, R, S, C) in memory, the layout
        ``ops/conv.py``'s kernel reads, so no call copies them."""
        cdt, hdt = self.cfg.compute_dtype, self.cfg.head_compute_dtype
        trunk = [self.patch_embed, self.enc_blocks, self.decoder_embed,
                 self.dec_blocks, self.dec_blocks2]
        heads = [self.downstream_head1, self.downstream_head2]
        for group, dt in ((trunk, cdt), (heads, hdt)):
            for part in group:
                for m in part.modules():
                    if isinstance(m, (nn.Linear, nn.Conv2d,
                                      nn.ConvTranspose2d)):
                        m.weight.data = m.weight.data.to(dt)
        for h in heads:
            last = h.dpt.head[4]
            last.weight.data = last.weight.data.float()
            for m in h.modules():
                if (isinstance(m, nn.Conv2d) and m.weight.is_cuda
                        and m.weight.dtype == torch.float32):
                    m.weight.data = m.weight.data.contiguous(
                        memory_format=torch.channels_last)
        return self


@torch.no_grad()
def _init_module(model: MASt3R, cfg: MASt3RConfig, g: torch.Generator):
    """Same distributions as the JAX init (``mast3r.py:76-96``): xavier
    uniform linears (the patch embed counts as a (ps*ps*3, E) linear),
    U(+-sqrt(1/fan_in)) convs, zero biases, unit norms."""
    pe = model.patch_embed.proj
    for m in model.modules():
        if isinstance(m, nn.Linear):
            b = math.sqrt(6.0 / (m.in_features + m.out_features))
            m.weight.uniform_(-b, b, generator=g)
        elif m is pe:
            din = pe.weight[0].numel()
            b = math.sqrt(6.0 / (din + pe.weight.shape[0]))
            m.weight.uniform_(-b, b, generator=g)
        elif isinstance(m, nn.ConvTranspose2d):   # (in, out, s, s)
            fan_in = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
            b = math.sqrt(1.0 / fan_in)
            m.weight.uniform_(-b, b, generator=g)
        elif isinstance(m, nn.Conv2d):            # (out, in, kh, kw)
            b = math.sqrt(1.0 / m.weight[0].numel())
            m.weight.uniform_(-b, b, generator=g)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()


def build(cfg: MASt3RConfig, device="cuda") -> MASt3R:
    """An uninitialized model on ``device`` (fill it with
    ``load_state_dict``)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = MASt3R(cfg)
    return model.eval().requires_grad_(False).store_compute_dtypes()


def init_params(cfg: MASt3RConfig, generator: torch.Generator = None,
                device="cuda", trainable: bool = False) -> MASt3R:
    """Randomly initialized model; ``generator`` must live on ``device``
    (default: seed 0). ``trainable``: fp32 weights that require gradients
    (for training); else weights in their compute dtypes, frozen."""
    dev = resolve_device(device)
    g = generator
    if g is None:
        g = torch.Generator(device=dev).manual_seed(0)
    if g.device.type != dev.type:
        raise ValueError(f"generator on {g.device}, model on {dev}")
    with torch.device(dev):
        model = MASt3R(cfg)
    _init_module(model, cfg, g)
    if trainable:
        return model.requires_grad_(True)
    return model.eval().requires_grad_(False).store_compute_dtypes()


def normalize_frames(img):
    """Raw uint8 pixels -> ImgNorm float32 (no-op on float inputs)."""
    if img.dtype == torch.uint8:
        img = (img.to(torch.float32) / 255.0 - 0.5) / 0.5
    return img


def encode_body(model: MASt3R, img, cfg: MASt3RConfig):
    """(b, h, w, 3) uint8 or ImgNorm float -> (feat (b, n, ed), pos (b, n, 2)),
    differentiable in the weights."""
    exact_fp32()
    with timing.span("mast3r.encoder"):
        feat, pos, _ = vit.encode(model, normalize_frames(img), cfg,
                                  cfg.compute_dtype)
    return feat, pos


@torch.no_grad()
def encode(model: MASt3R, img, cfg: MASt3RConfig):
    """``encode_body`` for inference: no gradients, through
    ``graphs.run``."""
    with timing.span("mast3r.encode", batch=img.shape[0]) as sp:
        return graphs.run(model, ("encode", cfg),
                          lambda x: encode_body(model, x, cfg), (img,), sp)


def _grid(cfg):
    return (cfg.img_size[0] // cfg.patch_size,
            cfg.img_size[1] // cfg.patch_size)


def decode_pair_body(model: MASt3R, feat1, pos1, feat2, pos2,
                     cfg: MASt3RConfig):
    """Two-view decode + heads, batched over the leading dim, differentiable
    in the weights and features. Returns (res1, res2) dicts of NHWC
    pts3d/conf/desc/desc_conf."""
    exact_fp32()
    grid = _grid(cfg)
    L = cfg.dec_depth
    hooks = (0, L * 2 // 4, L * 3 // 4, L)
    with timing.span("mast3r.decoder"):
        out1, out2 = vit.decode(model, feat1, pos1, feat2, pos2, cfg,
                                cfg.compute_dtype)
    hdt = cfg.head_compute_dtype
    with timing.span("mast3r.head"):
        res1 = dpt.head_forward(model.downstream_head1, out1, grid,
                                cfg.patch_size, cfg.desc_dim, hooks, hdt)
    with timing.span("mast3r.head"):
        res2 = dpt.head_forward(model.downstream_head2, out2, grid,
                                cfg.patch_size, cfg.desc_dim, hooks, hdt)
    return res1, res2


@torch.no_grad()
def decode_pair(model: MASt3R, feat1, pos1, feat2, pos2, cfg: MASt3RConfig,
                span=None):
    """``decode_pair_body`` for inference: no gradients, through
    ``graphs.run``; ``span``, the caller's, gets the attribute ``graph``."""
    return graphs.run(model, ("decode_pair", cfg),
                      lambda *a: decode_pair_body(model, *a, cfg),
                      (feat1, pos1, feat2, pos2), span)


def downsample_maps(*maps, ds: int = 1):
    """Subsample (b, h, w, ...) maps by stride ``ds``."""
    if ds <= 1:
        return maps
    return tuple(m[:, ::ds, ::ds] for m in maps)


def inference_mono(model, feat, pos, cfg: MASt3RConfig, ds: int = 1):
    """Self-pair decode -> (X (b, n, 3), C (b, n, 1))."""
    b = feat.shape[0]
    with timing.span("mast3r.mono", batch=b) as sp:
        res1, _ = decode_pair(model, feat, pos, feat, pos, cfg, span=sp)
        X, C = downsample_maps(res1["pts3d"], res1["conf"][..., None], ds=ds)
        return X.reshape(b, -1, 3), C.reshape(b, -1, 1)


def inference_asymmetric(model, feat_f, pos_f, feat_k, pos_k, cfg):
    """Frame/keyframe decode -> stacked (X, C, D, Q), leading dim 2 =
    [frame's map, keyframe's map], both in the frame's coordinates."""
    with timing.span("mast3r.asym", batch=feat_f.shape[0]) as sp:
        res1, res2 = decode_pair(model, feat_f, pos_f, feat_k, pos_k, cfg,
                                 span=sp)
        return tuple(torch.cat([res1[k], res2[k]], dim=0)
                     for k in ("pts3d", "conf", "desc", "desc_conf"))


def symmetric_from_decode(decode, params, feat_i, pos_i, feat_j, pos_j, cfg):
    """Both decode directions of edge (i, j) as one ``decode`` batch of 2b:
    decode (i|j) gives (ii, ji), decode (j|i) gives (jj, ij). Returns a
    dict of (b, h, w, ...) maps Xii, Xji, Xjj, Xij and the same for C, D,
    Q."""
    b = feat_i.shape[0]
    res1, res2 = decode(params, torch.cat([feat_i, feat_j]),
                        torch.cat([pos_i, pos_j]),
                        torch.cat([feat_j, feat_i]),
                        torch.cat([pos_j, pos_i]), cfg)
    out = {}
    for c, k in (("X", "pts3d"), ("C", "conf"), ("D", "desc"),
                 ("Q", "desc_conf")):
        out[c + "ii"], out[c + "jj"] = res1[k][:b], res1[k][b:]
        out[c + "ji"], out[c + "ij"] = res2[k][:b], res2[k][b:]
    return out


def inference_symmetric(model, feat_i, pos_i, feat_j, pos_j, cfg):
    """Symmetric two-view decode of a batch of edges (``mast3r.py:311``)."""
    with timing.span("mast3r.sym", batch=feat_i.shape[0]) as sp:
        return symmetric_from_decode(functools.partial(decode_pair, span=sp),
                                     model, feat_i, pos_i, feat_j, pos_j, cfg)
