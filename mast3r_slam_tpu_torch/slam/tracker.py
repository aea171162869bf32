"""Frame-to-keyframe Sim(3) tracking by Gauss-Newton.

Counterpart of ``mast3r_slam_tpu/slam/tracker.py``: the ray + distance
residual (uncalibrated) and the pixel + log-depth residual (calibrated),
in the JAX package's component-major layout ((d, N) residuals, (d, 7, N)
Jacobians). Plain PyTorch in this slice; the normal-equation reduction is
the next main-path kernel (ROADMAP.md queue 2).

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

__all__ = ["TrackerConfig", "TrackResult", "opt_pose_ray_dist_sim3",
           "opt_pose_calib_sim3", "calib_measurements"]


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


def _run_gn(residual_fn, T_init, cfg: TrackerConfig):
    dev = T_init.device
    T = T_init
    T_h = T_init.cpu()
    old_cost = torch.tensor(float("inf"))
    cost = old_cost
    failed = False
    it = 0
    while it < cfg.max_iters:
        sqrt_info, r, J = residual_fn(T)
        H, g, cost_d = _normal_eqs_t(sqrt_info, r, J, cfg.huber)
        # the iteration's one device->host copy: H, g and the cost
        hg = torch.cat([H.reshape(-1), g, cost_d[None]]).cpu()
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
    Xf_t = Xf.T

    def residual(T):
        Yt = _act_t(T, Xf_t)
        rd_f_t, d, rt = _ray_dist_t(Yt)
        return si_t, rd_k_t - rd_f_t, -_ray_dist_pose_jacobian_t(d, rt)

    return _run_gn(residual, T_CkCf_init, cfg)


@torch.no_grad()
def opt_pose_calib_sim3(Xf, Xk, T_CkCf_init, Qk, valid, meas_k,
                        valid_meas_k, K, img_size, cfg: TrackerConfig):
    """Pixel + log-depth GN (``tracker.py:225``)."""
    exact_fp32()
    sQ = (torch.sqrt(Qk) * valid)[:, 0]
    si_t = torch.stack([sQ / cfg.sigma_pixel] * 2 + [sQ / cfg.sigma_depth])
    Xf_t = Xf.T
    meas_k_t = meas_k.T
    valid_meas = valid_meas_k[:, 0]
    h, w = img_size
    fx, fy, cx, cy = geometry.decompose_K(K)
    border, z_eps = cfg.pixel_border, cfg.depth_eps

    def residual(T):
        Yt = _act_t(T, Xf_t)
        x, y, zc = Yt[0], Yt[1], Yt[2]
        valid_z = zc > z_eps
        z_safe = torch.where(valid_z, zc, torch.ones_like(zc))
        zi = 1.0 / z_safe
        u = fx * x * zi + cx
        v = fy * y * zi + cy
        valid_proj = ((u > border) & (u < w - 1 - border) & (v > border)
                      & (v < h - 1 - border) & valid_z)
        logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(zc))
        pz_t = torch.stack([u, v, logz])
        w_t = (valid_proj & valid_meas)[None] * si_t
        return w_t, meas_k_t - pz_t, -_calib_pose_jacobian_t(Yt, K, z_eps)

    return _run_gn(residual, T_CkCf_init, cfg)


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
