"""Frame-to-keyframe Sim(3) tracking by Gauss-Newton.

Counterpart of ``mast3r_slam_tpu/slam/tracker.py``: the ray + distance
residual (uncalibrated) and the pixel + log-depth residual (calibrated),
in the JAX package's component-major layout ((d, N) residuals, (d, 7, N)
Jacobians).

One linearization (act, residual, Jacobian, Huber weight, reduction to the
7x7 normal equations and the cost) is ``gn_step``: on CUDA tensors the
hand-written kernel ``csrc/gn_step.cu``, which replaces the XLA
``_gn_step_t`` (``tracker.py:60``) and the elementwise chain in front of
it; on CPU tensors ``gn_step_plain``, the component-major PyTorch version.

The JAX ``lax.while_loop`` (:171-195) becomes a Python loop split between
the device and the host. Per iteration the device builds the residuals and
reduces them to the 7x7 normal equations; those 57 numbers come to the host
in one copy (the iteration's only sync), where the equilibrated 7x7
Cholesky, the Sim(3) retraction and the convergence test run on the CPU,
and the new pose goes back to the device. The loop stops at convergence
(typically a handful of iterations) instead of running all ``max_iters``
with the pose frozen; ``iters`` counts the iterations run, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import geometry, robust
from .._device import exact_fp32
from ..config import TrackerConfig
from ..lie import sim3
from ..ops import _kernels

__all__ = ["TrackerConfig", "TrackResult", "opt_pose_ray_dist_sim3",
           "opt_pose_calib_sim3", "calib_measurements", "gn_step",
           "gn_step_plain", "CalibProj"]


class TrackResult(NamedTuple):
    T_CkCf: torch.Tensor   # (8,) refined relative pose
    cost: torch.Tensor     # final half-SSE
    iters: int             # iterations executed
    failed: torch.Tensor   # bool: singular or non-finite update met


def _solve7(H, g):
    """Jacobi-equilibrated fp32 Cholesky of the 7x7 system with a 1e-8
    ridge (``tracker.py:81-99``). A failed factorization sets ``ok`` False
    instead of throwing; an all-zero H (no valid matches) also fails."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    d_inv = 1.0 / d
    eye = torch.eye(7, dtype=H.dtype, device=H.device)
    Hs = H * d_inv[:, None] * d_inv[None, :] + 1e-8 * eye
    L, info = torch.linalg.cholesky_ex(Hs)
    tau = torch.cholesky_solve((g * d_inv)[:, None], L)[:, 0] * d_inv
    ok = (info == 0) & torch.all(torch.isfinite(tau)) & (
        torch.max(torch.diagonal(H)) > 0.0)
    return torch.where(ok, tau, torch.zeros_like(tau)), ok


def _normal_eqs_t(sqrt_info_t, r_t, J_t, huber_k):
    """Whitened, Huber-weighted normal equations in component-major layout
    (``tracker.py:60``): r_t (d, N), J_t (d, 7, N) -> (H, g, cost)."""
    whitened_r = sqrt_info_t * r_t
    rsi = sqrt_info_t * torch.sqrt(robust.huber(whitened_r, huber_k))
    A = rsi[:, None, :] * J_t                          # (d, 7, N)
    b = rsi * r_t                                      # (d, N)
    A2 = A.permute(1, 0, 2).reshape(7, -1)
    H = A2 @ A2.T
    g = -(A2 @ b.reshape(-1))
    cost = 0.5 * torch.sum(b * b)
    return H, g, cost


def _act_t(T, Xt):
    t, q, s = sim3.parts(T)
    R = sim3.quat_to_matrix(q)
    return s * (R @ Xt) + t[:, None]


def _ray_dist_t(Yt):
    d = torch.sqrt(torch.sum(Yt * Yt, dim=0))
    r = Yt / d
    return torch.cat([r, d[None]], dim=0), d, r


def _ray_dist_pose_jacobian_t(d, rt):
    di = 1.0 / d
    rx, ry, rz = rt[0], rt[1], rt[2]
    z = torch.zeros_like(d)
    rows = [
        [(1.0 - rx * rx) * di, -rx * ry * di, -rx * rz * di, z, rz, -ry, z],
        [-rx * ry * di, (1.0 - ry * ry) * di, -ry * rz * di, -rz, z, rx, z],
        [-rx * rz * di, -ry * rz * di, (1.0 - rz * rz) * di, ry, -rx, z, z],
        [rx, ry, rz, z, z, z, d],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def _calib_pose_jacobian_t(Yt, K, z_eps):
    fx, fy, cx, cy = geometry.decompose_K(K)
    x, y, zc = Yt[0], Yt[1], Yt[2]
    valid = zc > z_eps
    zi = torch.where(valid, 1.0 / torch.where(valid, zc, torch.ones_like(zc)),
                     torch.zeros_like(zc))
    xz = x * zi
    yz = y * zi
    z = torch.zeros_like(zi)
    one = valid.to(zi.dtype)
    rows = [
        [fx * zi, z, -fx * xz * zi, -fx * xz * yz, fx * (one + xz * xz),
         -fx * yz, z],
        [z, fy * zi, -fy * yz * zi, -fy * (one + yz * yz), fy * xz * yz,
         fy * xz, z],
        [z, z, zi, yz, -xz, z, one],
    ]
    return torch.stack([torch.stack(r) for r in rows])


class CalibProj(NamedTuple):
    """Pinhole projection constants of the calibrated residual, as host
    floats (read once per solve, not per iteration)."""
    fx: float
    fy: float
    cx: float
    cy: float
    w: int
    h: int
    border: int
    z_eps: float


def gn_step_plain(T, Xf, tgt_t, si_t, huber_k, calib: CalibProj = None):
    """Plain version of ``gn_step``: T (8,), Xf (N, 3) frame points,
    tgt_t (d, N) keyframe targets, si_t (d, N) sqrt-information ->
    (57,) [H (49), g (7), cost]."""
    Yt = _act_t(T, Xf.T)
    if calib is None:
        rd_f_t, d, rt = _ray_dist_t(Yt)
        w_t, r_t = si_t, tgt_t - rd_f_t
        J_t = -_ray_dist_pose_jacobian_t(d, rt)
    else:
        c = calib
        x, y, zc = Yt[0], Yt[1], Yt[2]
        valid_z = zc > c.z_eps
        z_safe = torch.where(valid_z, zc, torch.ones_like(zc))
        zi = 1.0 / z_safe
        u = c.fx * x * zi + c.cx
        v = c.fy * y * zi + c.cy
        valid_proj = ((u > c.border) & (u < c.w - 1 - c.border)
                      & (v > c.border) & (v < c.h - 1 - c.border) & valid_z)
        logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(zc))
        w_t, r_t = valid_proj[None] * si_t, tgt_t - torch.stack([u, v, logz])
        K = Yt.new_tensor([[c.fx, 0.0, c.cx], [0.0, c.fy, c.cy],
                           [0.0, 0.0, 1.0]])
        J_t = -_calib_pose_jacobian_t(Yt, K, c.z_eps)
    H, g, cost = _normal_eqs_t(w_t, r_t, J_t, huber_k)
    return torch.cat([H.reshape(-1), g, cost[None]])


def gn_step(T, Xf, tgt_t, si_t, huber_k, calib: CalibProj = None):
    """One Gauss-Newton linearization of the tracker: the 7x7 normal
    equations and the cost as one (57,) tensor [H, g, cost].

    T (8,); Xf (N, 3) frame points; tgt_t (d, N) [ray, dist] targets, or
    [u, v, log z] with ``calib``; si_t (d, N) sqrt-information with the
    match validity folded in."""
    if T.device.type == "cpu":
        return gn_step_plain(T, Xf, tgt_t, si_t, huber_k, calib)
    f32 = torch.float32
    d = 4 if calib is None else 3
    n = Xf.shape[0]
    _kernels.check_cuda(T, "gn_step T", f32, 1, 8)
    _kernels.check_cuda(Xf, "gn_step Xf", f32, 2, 3)
    _kernels.check_cuda(tgt_t, "gn_step targets", f32, 2, n)
    _kernels.check_cuda(si_t, "gn_step sqrt-information", f32, 2, n)
    if tgt_t.shape[0] != d or si_t.shape[0] != d:
        raise ValueError(f"gn_step: expected {d} residual rows, got "
                         f"{tuple(tgt_t.shape)} and {tuple(si_t.shape)}")
    part = torch.empty((264, 36), dtype=f32, device=T.device)
    out = torch.empty((57,), dtype=f32, device=T.device)
    c = calib if calib is not None else CalibProj(1.0, 1.0, 0.0, 0.0, 1, 1,
                                                  0, 0.0)
    _kernels.launch(
        "gn_step", _kernels.ptr(T), _kernels.ptr(Xf), _kernels.ptr(tgt_t),
        _kernels.ptr(si_t), _kernels.ptr(part), _kernels.ptr(out), n,
        int(calib is not None), float(huber_k), c.fx, c.fy, c.cx, c.cy,
        float(c.border), float(c.w - 1 - c.border),
        float(c.h - 1 - c.border), float(c.z_eps))
    return out


def _run_gn(step_fn, T_init, cfg: TrackerConfig):
    """``step_fn(T)`` -> (57,) [H, g, cost] on T's device."""
    dev = T_init.device
    T = T_init
    T_h = T_init.cpu()
    old_cost = torch.tensor(float("inf"))
    cost = old_cost
    failed = False
    it = 0
    while it < cfg.max_iters:
        # the iteration's one device->host copy: H, g and the cost
        hg = step_fn(T).cpu()
        H_h, g_h, cost = hg[:49].reshape(7, 7), hg[49:56], hg[56]
        tau, ok = _solve7(H_h, g_h)
        if bool(ok):
            T_h = sim3.retr(T_h, tau)
            T = T_h.to(dev)
        conv = bool(robust.converged(cfg.rel_error, cfg.delta_norm,
                                     old_cost, cost, tau))
        failed = failed or not bool(ok)
        old_cost = cost
        it += 1
        if conv or not bool(ok):
            break
    return TrackResult(T, cost.to(dev), it,
                       torch.tensor(failed, device=dev))


@torch.no_grad()
def opt_pose_ray_dist_sim3(Xf, Xk, T_CkCf_init, Qk, valid,
                           cfg: TrackerConfig):
    """Ray + distance GN (``tracker.py:199``). Xf (N, 3) frame points at
    the match indices, Xk (N, 3) keyframe points, T (8,), Qk (N, 1)
    confidences, valid (N, 1) bool."""
    exact_fp32()
    sQ = (torch.sqrt(Qk) * valid)[:, 0]
    si_t = torch.stack([sQ / cfg.sigma_ray] * 3 + [sQ / cfg.sigma_dist])
    rd_k_t, _, _ = _ray_dist_t(Xk.T)
    Xf = Xf.contiguous()
    return _run_gn(
        lambda T: gn_step(T, Xf, rd_k_t, si_t, cfg.huber),
        T_CkCf_init, cfg)


@torch.no_grad()
def opt_pose_calib_sim3(Xf, Xk, T_CkCf_init, Qk, valid, meas_k,
                        valid_meas_k, K, img_size, cfg: TrackerConfig):
    """Pixel + log-depth GN (``tracker.py:225``)."""
    exact_fp32()
    sQ = (torch.sqrt(Qk) * valid)[:, 0]
    si_t = torch.stack([sQ / cfg.sigma_pixel] * 2 + [sQ / cfg.sigma_depth])
    # (valid_proj & valid_meas) * si == valid_proj * (valid_meas * si): the
    # keyframe's own validity does not depend on the pose, fold it in once
    si_t = valid_meas_k[:, 0][None] * si_t
    h, w = img_size
    fx, fy, cx, cy = (float(v) for v in
                      torch.stack(geometry.decompose_K(K)).cpu())
    calib = CalibProj(fx, fy, cx, cy, w, h, cfg.pixel_border, cfg.depth_eps)
    Xf = Xf.contiguous()
    meas_k_t = meas_k.T.contiguous()
    return _run_gn(
        lambda T: gn_step(T, Xf, meas_k_t, si_t, cfg.huber, calib),
        T_CkCf_init, cfg)


def calib_measurements(Xk, K, img_size, depth_eps: float):
    """Pixel + log-depth targets of the keyframe (``tracker.py:260``)."""
    uv = geometry.pixel_coords(img_size, dtype=Xk.dtype, device=Xk.device)
    z = Xk[..., 2:3]
    valid = z > depth_eps
    logz = torch.where(valid, torch.log(torch.where(valid, z,
                                                    torch.ones_like(z))),
                       torch.zeros_like(z))
    meas = torch.cat([uv, logz], dim=-1) * valid
    return meas, valid
