"""DPT pixelwise head + MASt3R Cat-MLP local-feature head.

Counterpart of ``mast3r_slam_tpu/models/dpt.py``. Internally NCHW (the
convolutions' layout); ``head_forward`` returns NHWC maps like the JAX
package. Module names follow the reference checkpoint
(``downstream_head1.dpt.act_postprocess.0.0``, ``.dpt.scratch.layer1_rn``,
``.dpt.scratch.refinenet1.resConfUnit1.conv1``, ``.dpt.head.0``, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Mlp, conv2d, conv_transpose2d, interpolate_bilinear,
                     pixel_shuffle)


def _c(mod, x, dt, **kw):
    """Conv in compute dtype ``dt`` with fp32 accumulation."""
    return conv2d(mod, x.to(dt), dtype=dt, **kw).to(dt)


class ResidualConvUnit(nn.Module):
    def __init__(self, fd):
        super().__init__()
        self.conv1 = nn.Conv2d(fd, fd, 3, padding=1)
        self.conv2 = nn.Conv2d(fd, fd, 3, padding=1)

    def run(self, x, dt):
        out = _c(self.conv1, F.relu(x), dt)
        out = _c(self.conv2, F.relu(out), dt)
        return out + x


class FusionBlock(nn.Module):
    """FeatureFusionBlock_custom, width_ratio 1, align_corners True."""

    def __init__(self, fd):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(fd)
        self.resConfUnit2 = ResidualConvUnit(fd)
        self.out_conv = nn.Conv2d(fd, fd, 1)

    def run(self, x, res=None, dt=torch.float32):
        if res is not None:
            x = x + self.resConfUnit1.run(res, dt)
        x = self.resConfUnit2.run(x, dt)
        h, w = x.shape[-2:]
        x = interpolate_bilinear(x, (2 * h, 2 * w), align_corners=True)
        return _c(self.out_conv, x, dt)


class Scratch(nn.Module):
    def __init__(self, layer_dims, fd):
        super().__init__()
        for i, ld in enumerate(layer_dims, start=1):
            setattr(self, f"layer{i}_rn",
                    nn.Conv2d(ld, fd, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FusionBlock(fd))


class DPT(nn.Module):
    def __init__(self, cfg, num_channels):
        super().__init__()
        ld = cfg.layer_dims
        fd = cfg.feature_dim
        ed, dd = cfg.enc_embed_dim, cfg.dec_embed_dim
        dims_in = [ed, dd, dd, dd]
        self.act_postprocess = nn.ModuleList([
            nn.ModuleList([nn.Conv2d(dims_in[0], ld[0], 1),
                           nn.ConvTranspose2d(ld[0], ld[0], 4, 4)]),
            nn.ModuleList([nn.Conv2d(dims_in[1], ld[1], 1),
                           nn.ConvTranspose2d(ld[1], ld[1], 2, 2)]),
            nn.ModuleList([nn.Conv2d(dims_in[2], ld[2], 1)]),
            nn.ModuleList([nn.Conv2d(dims_in[3], ld[3], 1),
                           nn.Conv2d(ld[3], ld[3], 3, 2, 1)]),
        ])
        self.scratch = Scratch(ld, fd)
        # reference layout: conv, upsample, conv, relu, conv
        self.head = nn.ModuleList([
            nn.Conv2d(fd, fd // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(fd // 2, cfg.last_dim, 3, padding=1), nn.ReLU(),
            nn.Conv2d(cfg.last_dim, num_channels, 1)])

    def run(self, hook_tokens, grid, dt):
        """4 token maps (b, n, c_i) -> (b, num_channels, H, W) fp32."""
        nh, nw = grid
        layers = []
        for tok in hook_tokens:
            b, n, c = tok.shape
            layers.append(tok.to(dt).reshape(b, nh, nw, c).permute(0, 3, 1, 2))
        a = self.act_postprocess
        l0 = conv_transpose2d(a[0][1], _c(a[0][0], layers[0], dt), 4,
                              dtype=dt).to(dt)
        l1 = conv_transpose2d(a[1][1], _c(a[1][0], layers[1], dt), 2,
                              dtype=dt).to(dt)
        l2 = _c(a[2][0], layers[2], dt)
        # stride-2 conv padded (1, 1) on both sides, as torch's padding=1
        l3 = _c(a[3][1], _c(a[3][0], layers[3], dt), dt, stride=2, padding=1)

        s = self.scratch
        l0 = _c(s.layer1_rn, l0, dt)
        l1 = _c(s.layer2_rn, l1, dt)
        l2 = _c(s.layer3_rn, l2, dt)
        l3 = _c(s.layer4_rn, l3, dt)

        path4 = s.refinenet4.run(l3, dt=dt)[:, :, : l2.shape[2], : l2.shape[3]]
        path3 = s.refinenet3.run(path4, l2, dt=dt)
        path2 = s.refinenet2.run(path3, l1, dt=dt)
        path1 = s.refinenet1.run(path2, l0, dt=dt)

        h = self.head
        x = _c(h[0], path1, dt)
        hh, ww = x.shape[-2:]
        x = interpolate_bilinear(x, (2 * hh, 2 * ww), align_corners=True)
        x = F.relu(_c(h[2], x, dt))
        return conv2d(h[4], x.float())


class Head(nn.Module):
    """Cat-MLP + DPT head (``downstream_head{1,2}``)."""

    def __init__(self, cfg):
        super().__init__()
        idim = cfg.enc_embed_dim + cfg.dec_embed_dim
        out = (cfg.desc_dim + 1) * cfg.patch_size ** 2
        self.dpt = DPT(cfg, num_channels=4)
        self.head_local_features = Mlp(idim, 4 * idim, out)


# Exponent ceiling for the 'exp' activations (dpt.py:100-120): exactly a
# no-op for trained weights, keeps random weights from emitting inf maps
# that would poison the tracker's normal equations.
_EXP_CLAMP = 20.0


def reg_dense_pts3d(xyz):
    d = torch.sqrt(torch.sum(xyz * xyz, dim=-1, keepdim=True))
    return xyz / torch.clamp(d, min=1e-8) * torch.expm1(
        torch.clamp(d, max=_EXP_CLAMP))


def reg_dense_conf(x, vmin: float = 1.0):
    return vmin + torch.exp(torch.clamp(x, max=_EXP_CLAMP))


def head_forward(head: Head, hook_tokens, grid, patch_size: int,
                 desc_dim: int = 24, hooks=(0, 6, 9, 12), dt=torch.float32):
    """Full head: DPT pts3d+conf, MLP descriptors, postprocess
    (``dpt.py:123``). Returns NHWC dict(pts3d, conf, desc, desc_conf)."""
    nh, nw = grid
    dpt_out = head.dpt.run([hook_tokens[h] for h in hooks], grid, dt)
    cat = torch.cat([hook_tokens[0].to(dt), hook_tokens[-1].to(dt)], dim=-1)
    local = head.head_local_features.run(cat, dtype=dt)   # (b, n, c) fp32
    b, n, c = local.shape
    local = local.reshape(b, nh, nw, c).permute(0, 3, 1, 2)
    local = pixel_shuffle(local, patch_size)               # (b, d+1, H, W)
    fmap = torch.cat([dpt_out, local], dim=1).permute(0, 2, 3, 1)
    pts3d = reg_dense_pts3d(fmap[..., 0:3])
    conf = reg_dense_conf(fmap[..., 3], vmin=1.0)
    desc = fmap[..., 4:4 + desc_dim]
    desc = desc / torch.clamp(
        torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True)), min=1e-12)
    desc_conf = reg_dense_conf(fmap[..., 4 + desc_dim], vmin=0.0)
    return {"pts3d": pts3d, "conf": conf, "desc": desc,
            "desc_conf": desc_conf}
