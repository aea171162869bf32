"""Frame-to-keyframe Sim(3) tracking by Gauss-Newton.

Counterpart of ``mast3r_slam_tpu/slam/tracker.py``: the ray + distance
residual (uncalibrated) and the pixel + log-depth residual (calibrated),
in the JAX package's component-major layout ((d, N) residuals, (d, 7, N)
Jacobians).

The whole solve (the JAX ``lax.while_loop`` of ``_run_gn``, :171-195) is
``gn_solve``: on CUDA tensors one launch of the hand-written persistent
kernel ``csrc/gn_step.cu``, which per iteration reduces the residuals to
the 7x7 normal equations, solves them (equilibrated Cholesky), retracts
the pose and tests convergence on the device, and stops at convergence or
failure. Nothing is read to the host: the pose, the cost, the iteration
count and the failed flag stay on the device. On CPU tensors
``gn_solve_plain`` runs the same loop in Python around ``gn_step_plain``
(one linearization in PyTorch, then the 7x7 solve and the retraction on the
host). ``gn_step`` is one linearization ([H, g, cost]); on CUDA tensors it
is the same kernel run for one iteration.
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
           "gn_step_plain", "gn_solve", "gn_solve_plain", "CalibProj"]


class TrackResult(NamedTuple):
    T_CkCf: torch.Tensor   # (8,) refined relative pose
    cost: torch.Tensor     # half-SSE of the last linearization
    iters: torch.Tensor    # 0-d int32: iterations executed
    failed: torch.Tensor   # 0-d bool: singular or non-finite update met


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


_NO_CALIB = CalibProj(1.0, 1.0, 0.0, 0.0, 1, 1, 0, 0.0)
_BLOCKS_PER_SM = 8         # 2048 resident threads / the kernel's 256


def _launch(T, Xf, tgt_t, si_t, huber_k, calib, max_iters, rel_error,
            delta_norm):
    """One launch of ``csrc/gn_step.cu``: up to ``max_iters`` iterations of
    the solve from T. Returns out (66,) [T (8), cost, H (49), g (7), cost]
    (the final pose, the cost and the last linearization), iters (0-d
    int32) and failed (0-d bool), all on the device."""
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
    dev = T.device
    # scratch for the most blocks the card can hold at once; the launcher
    # sizes the grid by the kernel's occupancy
    max_blocks = _BLOCKS_PER_SM * _kernels.sm_count(dev.index)
    part = torch.empty((max_blocks * 36 + 16,), dtype=f32, device=dev)
    out = torch.empty((66,), dtype=f32, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    failed = torch.empty((), dtype=torch.bool, device=dev)
    c = calib if calib is not None else _NO_CALIB
    _kernels.launch(
        "gn_step", T, Xf, tgt_t, si_t, part, out, iters, failed, n,
        int(calib is not None), int(max_iters), max_blocks, float(huber_k),
        float(rel_error), float(delta_norm), c.fx, c.fy, c.cx, c.cy,
        float(c.border), float(c.w - 1 - c.border),
        float(c.h - 1 - c.border), float(c.z_eps))
    return out, iters, failed


def gn_step(T, Xf, tgt_t, si_t, huber_k, calib: CalibProj = None):
    """One Gauss-Newton linearization of the tracker: the 7x7 normal
    equations and the cost as one (57,) tensor [H, g, cost].

    T (8,); Xf (N, 3) frame points; tgt_t (d, N) [ray, dist] targets, or
    [u, v, log z] with ``calib``; si_t (d, N) sqrt-information with the
    match validity folded in."""
    if T.device.type == "cpu":
        return gn_step_plain(T, Xf, tgt_t, si_t, huber_k, calib)
    out, _, _ = _launch(T, Xf, tgt_t, si_t, huber_k, calib, 1, 0.0, 0.0)
    return out[9:]


def gn_solve_plain(T_init, Xf, tgt_t, si_t, cfg: TrackerConfig,
                   calib: CalibProj = None) -> TrackResult:
    """Plain version of ``gn_solve``, on any device: per iteration
    ``gn_step_plain``, then on the host the 7x7 solve, the retraction and
    the convergence test (one device->host copy per iteration)."""
    dev = T_init.device
    T = T_init
    T_h = T_init.cpu()
    old_cost = torch.tensor(float("inf"))
    cost = old_cost
    failed = False
    it = 0
    while it < cfg.max_iters:
        hg = gn_step_plain(T, Xf, tgt_t, si_t, cfg.huber, calib).cpu()
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
    return TrackResult(T, cost.to(dev),
                       torch.tensor(it, dtype=torch.int32, device=dev),
                       torch.tensor(failed, device=dev))


def gn_solve(T_init, Xf, tgt_t, si_t, cfg: TrackerConfig,
             calib: CalibProj = None) -> TrackResult:
    """The tracker's Gauss-Newton solve from T_init (8,) on the residuals
    of ``gn_step``: up to ``cfg.max_iters`` iterations, stopping at
    convergence or at a failed solve. On CUDA tensors one kernel launch
    and no host read."""
    if T_init.device.type == "cpu":
        return gn_solve_plain(T_init, Xf, tgt_t, si_t, cfg, calib)
    out, iters, failed = _launch(T_init.contiguous(), Xf, tgt_t, si_t,
                                 cfg.huber, calib, cfg.max_iters,
                                 cfg.rel_error, cfg.delta_norm)
    return TrackResult(out[:8], out[8], iters, failed)


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
    return gn_solve(T_CkCf_init, Xf.contiguous(), rd_k_t.contiguous(), si_t,
                    cfg)


@torch.no_grad()
def opt_pose_calib_sim3(Xf, Xk, T_CkCf_init, Qk, valid, meas_k,
                        valid_meas_k, K, img_size, cfg: TrackerConfig,
                        intrinsics=None):
    """Pixel + log-depth GN (``tracker.py:225``). ``intrinsics``: K's
    (fx, fy, cx, cy) from ``geometry.host_intrinsics``; without it K is
    read to the host here."""
    exact_fp32()
    sQ = (torch.sqrt(Qk) * valid)[:, 0]
    si_t = torch.stack([sQ / cfg.sigma_pixel] * 2 + [sQ / cfg.sigma_depth])
    # (valid_proj & valid_meas) * si == valid_proj * (valid_meas * si): the
    # keyframe's own validity does not depend on the pose, fold it in once
    si_t = valid_meas_k[:, 0][None] * si_t
    h, w = img_size
    fx, fy, cx, cy = intrinsics or geometry.host_intrinsics(K)
    calib = CalibProj(fx, fy, cx, cy, w, h, cfg.pixel_border, cfg.depth_eps)
    return gn_solve(T_CkCf_init, Xf.contiguous(), meas_k.T.contiguous(),
                    si_t.contiguous(), cfg, calib)


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
