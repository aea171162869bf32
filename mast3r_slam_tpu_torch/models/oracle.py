"""Oracle pointmap predictor: ground-truth geometry in the MASt3R API.

Counterpart of ``mast3r_slam_tpu/models/oracle.py``: the same inference
surface (``encode`` / ``decode_pair`` / ``inference_mono`` /
``inference_asymmetric`` / ``inference_symmetric``) computed by a
closed-form raycast of a synthetic scene (sphere(s) before a background
plane) from a known trajectory. The frame id travels in the encoder
features (token 0, last channel).

``make_params`` draws its random arrays with numpy from ``seed`` (the JAX
package draws them with ``jax.random``, so the two differ for one seed;
``convert.oracle_params_from_jax`` carries JAX-made params across).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import exact_fp32, resolve_device
from ..lie import sim3
from .mast3r import (MASt3RConfig, downsample_maps, normalize_frames,
                     symmetric_from_decode)


def make_params(traj_WC, desc_dim: int = 8, sphere_center=(0.0, 0.0, 4.0),
                sphere_radius: float = 1.5, plane_z: float = 7.0,
                seed: int = 0, pix_noise: float = 0.0,
                desc_freq: float = 2.0, scene: str = "default",
                device="cuda"):
    """Oracle 'weights': trajectory (N, 8), scene, descriptor field."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    params = {
        "traj": torch.as_tensor(traj_WC, dtype=torch.float32).to(dev),
        "desc_proj": f32(rng.standard_normal((3, desc_dim)) * desc_freq),
        "sphere_c": f32(sphere_center),
        "sphere_r": f32(sphere_radius),
        "plane_z": f32(plane_z),
        "pix_noise": float(pix_noise),   # host scalar: no sync to read it
    }
    if scene == "cluttered":
        K = 9
        gx = np.tile(np.linspace(-2.2, 2.2, 3), 3)
        gy = np.repeat(np.linspace(-1.4, 1.4, 3), 3)
        centers = np.stack([gx + 0.35 * rng.standard_normal(K),
                            gy + 0.25 * rng.standard_normal(K),
                            3.0 + 3.2 * rng.uniform(size=K)], axis=-1)
        params["spheres_c"] = f32(centers)
        params["spheres_r"] = f32(0.45 + 0.45 * rng.uniform(size=K))
    return params


def make_frame_image(frame_id: int, h: int, w: int):
    """Input 'image' carrying the frame index (read back by ``encode``)."""
    img = np.zeros((h, w, 3), np.float32)
    img[0, 0, 0] = frame_id / 1024.0
    return img


def _intrinsics(cfg: MASt3RConfig):
    h, w = cfg.img_size
    f = 0.8 * w
    return f, f, w / 2.0, h / 2.0


def _raycast_world(params, T_WC, cfg: MASt3RConfig):
    """World hit points (h*w, 3) of every pixel ray of a camera at T_WC."""
    h, w = cfg.img_size
    fx, fy, cx, cy = _intrinsics(cfg)
    dev = T_WC.device
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev),
                          indexing="ij")
    dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)],
                       -1).reshape(-1, 3)
    t, q, s = sim3.parts(T_WC)
    dir_w = s * sim3.quat_act(q, dirs)
    a = torch.sum(dir_w * dir_w, dim=-1)
    if "spheres_c" in params:
        oc = t[None, :] - params["spheres_c"]               # (K, 3)
        b = 2.0 * dir_w @ oc.T                              # (n, K)
        c = torch.sum(oc * oc, dim=-1) - params["spheres_r"] ** 2
        disc = b * b - 4.0 * a[:, None] * c[None, :]
        sk = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a[:, None])
        ok = (disc > 0) & (sk > 1e-3)
        sk = torch.where(ok, sk, torch.full_like(sk, float("inf")))
        s_sph = torch.min(sk, dim=-1).values
        hit = torch.isfinite(s_sph)
        s_sph = torch.where(hit, s_sph, torch.zeros_like(s_sph))
    else:
        oc = t - params["sphere_c"]
        b = 2.0 * dir_w @ oc
        c = torch.dot(oc, oc) - params["sphere_r"] ** 2
        disc = b * b - 4 * a * c
        hit = disc > 0
        s_sph = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
        hit = hit & (s_sph > 1e-3)
    denom = dir_w[:, 2]
    denom = torch.where(torch.abs(denom) < 1e-6, torch.full_like(denom, 1e-6),
                        denom)
    s_pl = (params["plane_z"] - t[2]) / denom
    s_hit = torch.where(hit, s_sph, s_pl)
    return t + s_hit[:, None] * dir_w


def _descriptors(params, Xw):
    d = torch.sin(Xw @ params["desc_proj"])
    n = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return d / torch.clamp(n, min=1e-9)


def encode(params, img, cfg: MASt3RConfig):
    """Frame id from the image -> id + patch-centre world coordinates as
    the 'encoder features'."""
    img = normalize_frames(img)
    fid = torch.round(img[:, 0, 0, 0] * 1024.0).to(torch.int64)
    return encode_fid(params, fid, cfg)


@torch.no_grad()
def encode_fid(params, fid, cfg: MASt3RConfig):
    exact_fp32()
    b = fid.shape[0]
    h, w = cfg.img_size
    ps = cfg.patch_size
    nh, nw = h // ps, w // ps
    n = nh * nw
    dev = params["traj"].device
    T = params["traj"][fid.to(dev)]
    centers = torch.stack([
        _raycast_world(params, T[i], cfg).reshape(h, w, 3)[
            ps // 2::ps, ps // 2::ps].reshape(n, 3)
        for i in range(b)])
    E = cfg.enc_embed_dim
    reps = -(-E // 3)
    feat = centers.repeat(1, 1, reps)[:, :, :E].contiguous()
    feat[:, 0, -1] = fid.to(dev).to(torch.float32)
    ys = torch.arange(nh, device=dev).repeat_interleave(nw)
    xs = torch.arange(nw, device=dev).repeat(nh)
    pos = torch.stack([ys, xs], -1).expand(b, n, 2)
    return feat, pos


def _frame_pose(params, feat):
    fid = feat[:, 0, -1].to(torch.float32).to(torch.int64)
    return params["traj"][fid]


@torch.no_grad()
def decode_pair(params, feat1, pos1, feat2, pos2, cfg: MASt3RConfig):
    """View 1's pointmap in view 1's frame (head 1) and view 2's pointmap
    in view 1's frame (head 2), with descriptors of the world points."""
    exact_fp32()
    h, w = cfg.img_size
    T1 = _frame_pose(params, feat1)
    T2 = _frame_pose(params, feat2)
    b = T1.shape[0]
    noise = float(params["pix_noise"])
    outs = []
    for i in range(b):
        Xw1 = _raycast_world(params, T1[i], cfg)
        Xw2 = _raycast_world(params, T2[i], cfg)
        T1_inv = sim3.inv(T1[i])
        X11 = sim3.act(T1_inv, Xw1)
        X21 = sim3.act(T1_inv, Xw2)
        if noise:
            g = torch.Generator(device=X11.device)
            X11 = X11 + noise * torch.randn(X11.shape, generator=g.manual_seed(0),
                                            device=X11.device)
            X21 = X21 + noise * torch.randn(X21.shape, generator=g.manual_seed(1),
                                            device=X21.device)
        outs.append((X11, X21, _descriptors(params, Xw1),
                     _descriptors(params, Xw2)))
    X11, X21, D11, D21 = (torch.stack(z) for z in zip(*outs))
    conf = torch.full((b, h, w), 2.5, dtype=torch.float32, device=X11.device)
    res1 = {"pts3d": X11.reshape(b, h, w, 3), "conf": conf,
            "desc": D11.reshape(b, h, w, -1), "desc_conf": conf}
    res2 = {"pts3d": X21.reshape(b, h, w, 3), "conf": conf,
            "desc": D21.reshape(b, h, w, -1), "desc_conf": conf}
    return res1, res2


def inference_mono(params, feat, pos, cfg: MASt3RConfig, ds: int = 1):
    res1, _ = decode_pair(params, feat, pos, feat, pos, cfg)
    b = feat.shape[0]
    X, C = downsample_maps(res1["pts3d"], res1["conf"][..., None], ds=ds)
    return X.reshape(b, -1, 3), C.reshape(b, -1, 1)


def inference_asymmetric(params, feat_f, pos_f, feat_k, pos_k, cfg):
    res1, res2 = decode_pair(params, feat_f, pos_f, feat_k, pos_k, cfg)
    return tuple(torch.cat([res1[k], res2[k]], dim=0)
                 for k in ("pts3d", "conf", "desc", "desc_conf"))


def inference_symmetric(params, feat_i, pos_i, feat_j, pos_j, cfg):
    """Symmetric two-view decode of a batch of edges (``oracle.py:252``)."""
    return symmetric_from_decode(decode_pair, params, feat_i, pos_i, feat_j,
                                 pos_j, cfg)
