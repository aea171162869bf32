"""Global pose-graph Gauss-Newton over keyframe Sim(3) poses.

Counterpart of ``mast3r_slam_tpu/slam/ba.py``. Once per solve,
``_edge_prep`` gathers keyframe i's points at the match indices (through
the ``gather_rows`` kernel) and, on CUDA, ``_edge_weights`` folds the
pose-independent gates and sqrt(Q) into one weight per point and
``_assembly_plan`` orders the edge blocks' contributions to the dense
system. Per GN iteration:

* ``_edge_system``: the dense 7K x 7K system. On CUDA tensors it is one
  launch of the hand-written kernel ``csrc/ba_edge_terms.cu``
  (``edge_system``): per edge the robustly weighted sums S0 = sum J^T J
  (7x7) and g0 = sum J^T r (7) over the edge's matched points with
  respect to Tij, their conjugation with the inverse adjoint of Ti into
  the [[S, -S], [-S, S]] edge block, and the assembly in edge order. It
  replaces the chunked ``lax.scan`` of matmuls in ``_edge_terms``
  (``ba.py:203-298``) and ``_assemble`` (:394-429). On CPU tensors it is
  ``edge_system_plain``: ``_edge_terms`` with ``ba_edge_terms_plain``
  (per-edge sums), the conjugation in PyTorch, and ``_assemble``.
* ``_solve``: Jacobi equilibration and an fp32 Cholesky on the device (or
  fp64 on the host), as the JAX package computes it outside any kernel.

The plan reads the edge lists once per solve. Every solver, this dense
one and the sharded ones (``parallel/dist_ba.py``, ``parallel/schur.py``),
runs the one Gauss-Newton loop ``gn_loop`` on its own T -> (dx, free):
``max_iters`` iterations predicated on the device (``_predicated_iteration``:
the stop rule a device flag, later iterations leave the poses as they are),
the step norms read once at the end. On CUDA under no_grad with the fp32
solver the dense solve captures one CUDA graph of the iteration at its own
shapes (``models/graphs.py``), before the plan's read, and replays it
``max_iters`` times; the CPU, grad, the ``fp64_host`` solver and the
sharded solvers call the iteration eagerly. Both give the same poses,
iterations and norms, bit for bit.
``ba_edge_terms`` (per-edge S0, g0 for given Tij) stays callable; on CUDA
tensors it runs the same kernel without the conjugation and the
assembly. The JAX package's point chunks, component-major stacks
and power-of-two shape buckets were ways to fit the TPU compiler and are
not carried over.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import geometry, robust
from .._device import exact_fp32
from ..config import BAConfig
from ..lie import sim3
from ..models import graphs
from ..ops import _kernels, gather
from ..utils import timing

__all__ = ["BAConfig", "BAResult", "ba_edge_terms", "ba_edge_terms_plain",
           "edge_system", "edge_system_plain", "gauss_newton_rays",
           "gauss_newton_calib", "gauss_newton_points"]

MODES = ("rays", "calib", "points")
_N_ROWS = {"rays": 4, "calib": 3, "points": 3}
_HUBER_K = 1.345          # robust.huber's default, as ba.py:268 calls it
_BLOCKS_PER_SM = 3        # the kernel's blocks over all edges, per SM


class BAResult(NamedTuple):
    T_WC: torch.Tensor   # (K, 8) updated poses
    iters: int           # GN iterations run, up to the stop rule's
    deltas: tuple = ()   # each of those iterations' step norm
    graph: str = "eager"  # "capture": one CUDA graph replayed the solve


class EdgePre(NamedTuple):
    """Loop-invariant per-edge data (``_edge_prep``): P' = P / stride
    measurement pixels per edge."""
    XCi: torch.Tensor       # (E, P', 4) [X, C] of keyframe i at the match
    XCj: torch.Tensor       # (E, P', 4) [X, C] of keyframe j's pixels
    safe_idx: torch.Tensor  # (E, P') int32 match index, 0 where invalid


class AssemblyPlan(NamedTuple):
    """Which contributions of the 4E edge blocks add into which 7x7 block
    of Hd, in the plain version's order (``_assembly_plan``). Contribution
    c = t E + e is block type t (0: (i, i), 1: (i, j), 2: (j, i), 3: (j, j))
    of edge e; a run is the contributions to one destination block."""
    order: torch.Tensor      # (4E,) int32 contributions by block, then c
    run_of: torch.Tensor     # (4E,) int32 run of contribution c, or -1
    run_start: torch.Tensor  # (4E,) int32 run h's first position in order
    run_len: torch.Tensor    # (4E,) int32 run h's length (0 past the runs)
    run_key: torch.Tensor    # (4E,) int32 run h's block row * K + col
    block_run: torch.Tensor  # (K * K,) int32 run of each block, or -1
    run_count: torch.Tensor  # (4E,) int32 the kernel's counters, zero


class CalibArgs(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    w: int
    h: int


def _gather_points(XC, ii, idx):
    """XCi[e, p] = XC[ii[e], idx[e, p]] as one flat 4-wide row gather
    (``ba.py:72``): XC (K, P, 4) [X, C], ii (E,), idx (E, P') int32."""
    K, P, _ = XC.shape
    flat_idx = (ii[:, None].to(torch.int32) * P + idx).reshape(-1)
    return gather.gather_rows(XC.reshape(K * P, 4), flat_idx).reshape(
        *idx.shape, 4)


def _edge_prep(Xs, Cs, ii, jj, idx, valid_match, stride: int = 1) -> EdgePre:
    """Gathered matched points and confidences (``ba.py:301``). ``stride``
    subsamples the measurement pixels (the j side); the i-side gather
    indices stay full-map indices."""
    XC = torch.cat([Xs, Cs[..., None]], dim=-1)
    XC_j = XC
    if stride > 1:
        idx = idx[:, ::stride]
        valid_match = valid_match[:, ::stride]
        XC_j = XC[:, ::stride]
    safe_idx = torch.where(valid_match, idx.to(torch.int32),
                           torch.zeros((), dtype=torch.int32,
                                       device=idx.device)).contiguous()
    return EdgePre(_gather_points(XC, ii, safe_idx),
                   XC_j[jj.to(torch.int64)].contiguous(), safe_idx)


def _assembly_plan(ii, jj, n_kf: int, K_cap: int, pin: int,
                   out=None) -> AssemblyPlan:
    """The assembly's plan, once per solve (it does not depend on the
    poses): made on the host from one read of the edge lists, as a few
    numpy calls, and uploaded in one copy (into ``out``, a buffer of
    ``_plan_buffer``, where given)."""
    ij = timing.host_read("ba_plan", torch.stack([ii.to(torch.int64),
                                                  jj.to(torch.int64)]))
    return _assembly_plan_host(ij, n_kf, K_cap, pin, ii.device, out)


def _plan_buffer(E: int, K_cap: int, device):
    """An unfilled int32 buffer for the plan of E edges and K_cap poses."""
    return torch.empty((24 * E + K_cap * K_cap,), dtype=torch.int32,
                       device=device)


def _plan_views(buf, E: int) -> AssemblyPlan:
    """The plan's arrays as views of its flat buffer."""
    a = buf[:24 * E].view(6, 4 * E)
    return AssemblyPlan(a[0], a[1], a[2], a[3], a[4], buf[24 * E:], a[5])


def _assembly_plan_host(ij, n_kf: int, K_cap: int, pin: int,
                        device, out=None) -> AssemblyPlan:
    """``_assembly_plan`` from the edge lists already on the host, ij (2, E)
    int64, uploaded to ``device``. The plain version adds the four block
    types in four ``index_put_`` calls, each in edge order, so the
    contributions to one destination block add in the order of c (a stable
    sort keeps it). Blocks of pinned (< pin) and inactive (>= n_kf) poses
    go to the sentinel and are dropped (run -1)."""
    si, sj = np.where((ij >= pin) & (ij < n_kf), ij, K_cap)
    E = si.shape[0]
    n = 4 * E
    rows = np.concatenate([si, si, sj, sj])
    cols = np.concatenate([si, sj, si, sj])
    none = K_cap * K_cap                     # sorts after every block
    key = np.where((rows == K_cap) | (cols == K_cap), none,
                   rows * K_cap + cols)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    kept = skey < none                       # a prefix of the sorted list
    head = kept.copy()
    head[1:] &= skey[1:] != skey[:-1]
    starts = np.flatnonzero(head)
    n_runs = starts.shape[0]
    run = np.cumsum(head) - 1
    packed = np.zeros((6, n), np.int32)      # the (4E,) arrays, run_count 0
    packed[0] = order
    packed[1, order] = np.where(kept, run, -1)
    packed[2, :n_runs] = starts
    packed[3, :n_runs] = np.diff(np.append(starts, np.count_nonzero(kept)))
    packed[4, :n_runs] = skey[starts]
    block_run = np.full(none, -1, np.int32)
    block_run[skey[starts]] = np.arange(n_runs)
    buf = timing.host_write("plan_upload",
                            np.concatenate([packed.ravel(), block_run]),
                            device=device)
    if out is not None:
        buf = out.copy_(buf)
    return _plan_views(buf, E)


def _edge_weights(pre: EdgePre, valid_match, Q, cfg: BAConfig,
                  stride: int = 1):
    """The pose-independent part of the per-point weight, once per solve:
    wq (E, P') = sqrt(Q) where the match is valid and Q and both
    confidences pass their gates (``ba.py:259-267``), else 0. The kernel's
    sqrt-weight sigma_r * wq has the bits of the plain version's
    where(valid, sigma_r * sqrt(Q), 0)."""
    Qs = Q[:, ::stride]
    valid = (valid_match[:, ::stride] & (Qs > cfg.Q_conf)
             & (pre.XCi[..., 3] > cfg.C_conf) & (pre.XCj[..., 3] > cfg.C_conf))
    return torch.where(valid, torch.sqrt(Qs),
                       torch.zeros((), dtype=Q.dtype,
                                   device=Q.device)).contiguous()


def _sigmas(mode, cfg: BAConfig):
    if mode == "rays":
        return [1.0 / cfg.sigma_ray] * 3 + [1.0 / cfg.sigma_dist]
    if mode == "calib":
        return [1.0 / cfg.sigma_pixel] * 2 + [1.0 / cfg.sigma_depth]
    return [1.0 / cfg.sigma_point] * 3


# -- plain version: component-major, as the JAX package writes it ------------


def _act_t_b(T, Xt):
    """Batched Sim3 action on column points: T (E, 8), Xt (E, 3, P)."""
    t, q, s = sim3.parts(T)
    R = sim3.quat_to_matrix(q)
    return s[..., None] * (R @ Xt) + t[..., None]


def _ray_dist_t_b(Yt):
    d = torch.sqrt(torch.sum(Yt * Yt, dim=1))
    r = Yt / d[:, None]
    return torch.cat([r, d[:, None]], dim=1), d, r


def _stack_rows(rows):
    """[[comp (E, P)] * 7] * r -> (E, r, 7, P)."""
    return torch.stack([torch.stack(row, dim=1) for row in rows], dim=1)


def _ray_jac_t_b(d, r):
    di = 1.0 / d
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    z = torch.zeros_like(d)
    return _stack_rows([
        [(1.0 - rx * rx) * di, -rx * ry * di, -rx * rz * di, z, rz, -ry, z],
        [-rx * ry * di, (1.0 - ry * ry) * di, -ry * rz * di, -rz, z, rx, z],
        [-rx * rz * di, -ry * rz * di, (1.0 - rz * rz) * di, ry, -rx, z, z],
        [rx, ry, rz, z, z, z, d],
    ])


def _point_jac_t_b(Yt):
    x, y, zc = Yt[:, 0], Yt[:, 1], Yt[:, 2]
    z = torch.zeros_like(x)
    one = torch.ones_like(x)
    return _stack_rows([
        [one, z, z, z, zc, -y, x],
        [z, one, z, -zc, z, x, y],
        [z, z, one, y, -x, z, zc],
    ])


def _calib_jac_t_b(Yt, fx, fy, z_eps):
    x, y, zc = Yt[:, 0], Yt[:, 1], Yt[:, 2]
    valid = zc > z_eps
    zi = torch.where(valid, 1.0 / torch.where(valid, zc, torch.ones_like(zc)),
                     torch.zeros_like(zc))
    xz = x * zi
    yz = y * zi
    z = torch.zeros_like(zi)
    one = valid.to(zi.dtype)
    return _stack_rows([
        [fx * zi, z, -fx * xz * zi,
         -fx * xz * yz, fx * (one + xz * xz), -fx * yz, z],
        [z, fy * zi, -fy * yz * zi,
         -fy * (one + yz * yz), fy * xz * yz, fy * xz, z],
        [z, z, zi, yz, -xz, z, one],
    ])


def _residual(mode, Tij, Xj_t, Xi_t, safe_idx, cfg, calib):
    """err (E, r, P), J_theta (E, r, 7, P), extra_valid (E, P) or None
    (``ba.py:327``, ``:347``, ``:367``)."""
    Y = _act_t_b(Tij, Xj_t)
    if mode == "rays":
        rd_i, _, _ = _ray_dist_t_b(Xi_t)
        rd_j, d, r = _ray_dist_t_b(Y)
        return rd_j - rd_i, _ray_jac_t_b(d, r), None
    if mode == "points":
        return Y - Xi_t, _point_jac_t_b(Y), None
    c = calib
    border, z_eps = cfg.pixel_border, cfg.depth_eps
    u_t = (safe_idx % c.w).to(Y.dtype)
    v_t = torch.div(safe_idx, c.w, rounding_mode="floor").to(Y.dtype)
    x, y, zc = Y[:, 0], Y[:, 1], Y[:, 2]
    valid_z = zc > z_eps
    z_safe = torch.where(valid_z, zc, torch.ones_like(zc))
    z_inv = 1.0 / z_safe
    u = c.fx * x * z_inv + c.cx
    v = c.fy * y * z_inv + c.cy
    valid_proj = ((u > border) & (u < c.w - 1 - border)
                  & (v > border) & (v < c.h - 1 - border) & valid_z)
    logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(zc))
    zi = Xi_t[:, 2]
    valid_zi = zi > z_eps
    log_zi = torch.where(
        valid_zi, torch.log(torch.where(valid_zi, zi, torch.ones_like(zi))),
        torch.zeros_like(zi))
    err = torch.stack([u - u_t, v - v_t, logz - log_zi], dim=1)
    return err, _calib_jac_t_b(Y, c.fx, c.fy, z_eps), valid_proj & valid_zi


def ba_edge_terms_plain(mode, Tij, pre: EdgePre, valid_match, Q, edge_mask,
                        stride, cfg: BAConfig, calib: CalibArgs = None):
    """Plain version of ``ba_edge_terms`` (``ba.py:252-285`` without the
    chunk scan)."""
    vm = valid_match[:, ::stride]
    Qs = Q[:, ::stride]
    Xi_t = pre.XCi[..., 0:3].transpose(1, 2)
    Xj_t = pre.XCj[..., 0:3].transpose(1, 2)
    Ci, Cj = pre.XCi[..., 3], pre.XCj[..., 3]
    err, J_theta, extra = _residual(mode, Tij, Xj_t, Xi_t, pre.safe_idx, cfg,
                                    calib)
    valid = vm & (Qs > cfg.Q_conf) & (Ci > cfg.C_conf) & (Cj > cfg.C_conf)
    if extra is not None:
        valid = valid & extra
    sigma = Q.new_tensor(_sigmas(mode, cfg))[None, :, None]
    sqrt_w = torch.where(valid[:, None, :],
                         sigma * torch.sqrt(Qs)[:, None, :],
                         torch.zeros((), dtype=Q.dtype, device=Q.device))
    w = robust.huber(sqrt_w * err, _HUBER_K) * sqrt_w * sqrt_w
    w = w * edge_mask[:, None, None]
    rw = torch.sqrt(w)
    A = rw[:, :, None, :] * J_theta                       # (E, r, 7, P)
    E = A.shape[0]
    A2 = A.permute(0, 2, 1, 3).reshape(E, 7, -1)          # (E, 7, r P)
    S0 = A2 @ A2.transpose(1, 2)
    g0 = (A2 @ (rw * err).reshape(E, -1, 1))[..., 0]
    return S0, g0


# -- the kernel's wrapper -----------------------------------------------------

_COUNTERS: dict = {}      # device -> int32 counters, zero between launches


def _counters(dev, n):
    """The kernel's per-edge counters: zeroed once, and left zero by every
    launch (its last blocks reset them). One stream at a time."""
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < n:
        c = torch.zeros((max(n, 64),), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = c
    return c


def _check_mode(mode, calib):
    if mode not in MODES:
        raise ValueError(f"ba_edge_terms: unknown mode {mode!r}")
    if mode == "calib" and calib is None:
        raise ValueError("ba_edge_terms: mode 'calib' needs calib")


def _launch(mode, T, ii, jj, pre: EdgePre, wq, edge_mask, cfg: BAConfig,
            calib, plan: AssemblyPlan = None, K_cap=0):
    """One launch of ``csrc/ba_edge_terms.cu``. Without ``plan`` (raw): T
    is (E, 8) Tij and the outputs are S0 (E, 7, 7), g0 (E, 7). With it, T
    is (K_cap, 8) T_WCs and the outputs are the edge blocks (E, 14, 14),
    (E, 14) and the assembled Hd (7 K_cap, 7 K_cap), gd (7 K_cap)."""
    _check_mode(mode, calib)
    f32, i32 = torch.float32, torch.int32
    raw = plan is None
    E, Pp = pre.safe_idx.shape
    dev = T.device
    _kernels.check_cuda(T, "ba_edge_terms poses", f32, 2, 8)
    _kernels.check_cuda(pre.XCi, "ba_edge_terms XCi", f32, 3, 4)
    _kernels.check_cuda(pre.XCj, "ba_edge_terms XCj", f32, 3, 4)
    _kernels.check_cuda(pre.safe_idx, "ba_edge_terms safe_idx", i32, 2)
    _kernels.check_cuda(wq, "ba_edge_terms weights", f32, 2, Pp)
    _kernels.check_cuda(edge_mask, "ba_edge_terms edge_mask", f32, 1, E)
    if (pre.XCi.shape[:2] != (E, Pp) or pre.XCj.shape[:2] != (E, Pp)
            or wq.shape[0] != E or (raw and T.shape[0] != E)):
        raise ValueError("ba_edge_terms: edge/point counts disagree")
    if pre.XCi.data_ptr() % 16 or pre.XCj.data_ptr() % 16:
        raise ValueError("ba_edge_terms: point buffers must be 16-byte "
                         "aligned")
    if raw:
        ii = jj = pre.safe_idx                 # not read
        Hout = torch.empty((E, 7, 7), dtype=f32, device=dev)
        gout = torch.empty((E, 7), dtype=f32, device=dev)
        Hd = gd = Hout                         # not written
        plan_args = [None] * 7
    else:
        ii = ii.to(i32).contiguous()
        jj = jj.to(i32).contiguous()
        if ii.shape != (E,) or jj.shape != (E,) or T.shape[0] != K_cap:
            raise ValueError("ba_edge_terms: edge/pose counts disagree")
        for name in AssemblyPlan._fields:
            want = K_cap * K_cap if name == "block_run" else 4 * E
            _kernels.check_cuda(getattr(plan, name),
                                f"ba_edge_terms plan {name}", i32, 1, want)
        Hout = torch.empty((E, 14, 14), dtype=f32, device=dev)
        gout = torch.empty((E, 14), dtype=f32, device=dev)
        Hd = torch.empty((7 * K_cap, 7 * K_cap), dtype=f32, device=dev)
        gd = torch.empty((7 * K_cap,), dtype=f32, device=dev)
        plan_args = list(plan)
    if E == 0:
        if not raw:
            Hd.zero_()
            gd.zero_()
        return (Hout, gout) if raw else (Hout, gout, Hd, gd)
    spread = -(-_BLOCKS_PER_SM * _kernels.sm_count(dev.index) // E)
    bpe = max(1, min(spread, -(-Pp // 256)))
    part = torch.empty((E, bpe, 35), dtype=f32, device=dev)
    count = _counters(dev, E)
    sig = _sigmas(mode, cfg) + [0.0]
    c = calib if calib is not None else CalibArgs(1.0, 1.0, 0.0, 0.0, 1, 1)
    border = cfg.pixel_border
    _kernels.launch(
        "ba_edge_terms", T, ii, jj, pre.XCi, pre.XCj, pre.safe_idx, wq,
        edge_mask, part, count, *plan_args, Hout, gout, Hd, gd, E, Pp, bpe,
        int(raw), MODES.index(mode), int(c.w), int(K_cap), sig[0], sig[1],
        sig[2], sig[3], _HUBER_K, c.fx, c.fy, c.cx, c.cy, float(border),
        float(c.w - 1 - border), float(c.h - 1 - border),
        float(cfg.depth_eps))
    return (Hout, gout) if raw else (Hout, gout, Hd, gd)


def ba_edge_terms(mode, Tij, pre: EdgePre, valid_match, Q, edge_mask, stride,
                  cfg: BAConfig, calib: CalibArgs = None):
    """Per-edge S0 (E, 7, 7) and g0 (E, 7) with respect to Tij.

    mode: "rays", "calib" (needs ``calib``) or "points". Tij (E, 8);
    ``pre`` from ``_edge_prep`` at the same ``stride``; valid_match (E, P)
    bool and Q (E, P) at full width (read at every ``stride``-th column);
    edge_mask (E,)."""
    if Tij.device.type == "cpu":
        _check_mode(mode, calib)
        return ba_edge_terms_plain(mode, Tij, pre, valid_match, Q, edge_mask,
                                   stride, cfg, calib)
    if pre.safe_idx.shape[1] != len(range(0, Q.shape[1], stride)):
        raise ValueError("ba_edge_terms: edge/point counts disagree")
    wq = _edge_weights(pre, valid_match, Q, cfg, stride)
    return _launch(mode, Tij, None, None, pre, wq, edge_mask, cfg, calib)


def edge_system(mode, T_WCs, pre: EdgePre, wq, ii, jj, edge_mask, n_kf: int,
                K_cap: int, pin: int, cfg: BAConfig,
                calib: CalibArgs = None, plan: AssemblyPlan = None):
    """The iteration's whole linear system in one kernel launch (CUDA
    tensors only): edge blocks H (E, 14, 14), g (E, 14) and the assembled
    Hd (7 K_cap, 7 K_cap), gd (7 K_cap). ``pre``, ``wq`` and ``plan`` from
    ``_edge_prep``, ``_edge_weights`` at ``cfg.point_stride`` and
    ``_assembly_plan`` (made here when not given)."""
    if plan is None:
        plan = _assembly_plan(ii, jj, n_kf, K_cap, pin)
    return _launch(mode, T_WCs, ii, jj, pre, wq, edge_mask, cfg, calib, plan,
                   K_cap)


def edge_system_plain(mode, T_WCs, Xs, Cs, ii, jj, idx, valid_match, Q,
                      edge_mask, n_kf: int, K_cap: int, pin: int,
                      cfg: BAConfig, pre: EdgePre = None,
                      calib: CalibArgs = None):
    """Plain version of ``edge_system``, on any device: ``_edge_terms``
    with ``ba_edge_terms_plain``, then ``_assemble``."""
    H, g = _edge_terms(mode, T_WCs, Xs, Cs, ii, jj, idx, valid_match, Q,
                       edge_mask, cfg, pre, calib, ba_edge_terms_plain)
    return (H, g) + _assemble(H, g, ii, jj, n_kf, K_cap, pin)


# -- per-edge blocks, assembly, solve -----------------------------------------


def _adj_inv_matrix(T):
    """The 7x7 matrix M with M v == sim3.apply_adj_inv_T(T, v): T (E, 8)
    (``ba.py:180``). The inverse-adjoint map is linear per edge, so the
    per-point accumulation runs on the raw relative-pose Jacobian and is
    conjugated once per edge."""
    t, q, s = sim3.parts(T)
    R = sim3.quat_to_matrix(q)
    s_inv = (1.0 / s)[..., None]
    E = T.shape[0]
    z31 = T.new_zeros((E, 3, 1))
    top = torch.cat([s_inv * R, torch.zeros_like(R), z31], dim=-1)
    mid = torch.cat([s_inv * (sim3.skew(t) @ R), R, z31], dim=-1)
    tR = (t[:, None, :] @ R)                               # (E, 1, 3)
    bot = torch.cat([s_inv * tR, T.new_zeros((E, 1, 3)),
                     T.new_ones((E, 1, 1))], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def _edge_terms(mode, T_WCs, Xs, Cs, ii, jj, idx, valid_match, Q, edge_mask,
                cfg: BAConfig, pre: EdgePre = None, calib: CalibArgs = None,
                terms=ba_edge_terms):
    """(E, 14, 14) edge Hessians and (E, 14) gradients; rows/cols 0:7 are
    pose i, 7:14 pose j (``ba.py:203``). ``terms`` computes the per-edge
    S0, g0."""
    iil, jjl = ii.to(torch.int64), jj.to(torch.int64)
    Ti = T_WCs[iil]
    Tij = sim3.rel(Ti, T_WCs[jjl]).contiguous()
    if pre is None:
        pre = _edge_prep(Xs, Cs, ii, jj, idx, valid_match,
                         stride=cfg.point_stride)
    S0, g0 = terms(mode, Tij, pre, valid_match, Q, edge_mask,
                   cfg.point_stride, cfg, calib)
    M = _adj_inv_matrix(Ti)
    S = M @ S0 @ M.transpose(1, 2)
    gj = (M @ g0[..., None])[..., 0]
    H = torch.cat([torch.cat([S, -S], dim=-1),
                   torch.cat([-S, S], dim=-1)], dim=-2)
    return H, torch.cat([-gj, gj], dim=-1)


def _calib_args(K_mat, img_size) -> CalibArgs:
    """Intrinsics as host floats: one read per solve."""
    return CalibArgs(*geometry.host_intrinsics(K_mat), int(img_size[1]),
                     int(img_size[0]))


def _edge_terms_rays(T_WCs, Xs, Cs, ii, jj, idx, valid_match, Q, edge_mask,
                     cfg: BAConfig, pre=None):
    """Ray + distance residual (``ba.py:320``)."""
    return _edge_terms("rays", T_WCs, Xs, Cs, ii, jj, idx, valid_match, Q,
                       edge_mask, cfg, pre)


def _edge_terms_points(T_WCs, Xs, Cs, ii, jj, idx, valid_match, Q, edge_mask,
                       cfg: BAConfig, pre=None):
    """3D point-difference residual (``ba.py:340``)."""
    return _edge_terms("points", T_WCs, Xs, Cs, ii, jj, idx, valid_match, Q,
                       edge_mask, cfg, pre)


def _edge_terms_calib(T_WCs, Xs, Cs, K_mat, ii, jj, idx, valid_match, Q,
                      edge_mask, img_size, cfg: BAConfig, pre=None):
    """Pixel + log-depth residual (``ba.py:358``)."""
    return _edge_terms("calib", T_WCs, Xs, Cs, ii, jj, idx, valid_match, Q,
                       edge_mask, cfg, pre, _calib_args(K_mat, img_size))


def _assemble(H_edges, g_edges, ii, jj, n_kf: int, K_cap: int, pin: int):
    """Scatter edge blocks into the dense 7K x 7K system (``ba.py:394``).
    Pinned poses (index < pin) and inactive slots (>= n_kf) land in a
    sentinel slot that is cut off. ``index_put_`` with ``accumulate`` sums
    in a fixed order on CUDA, unlike ``index_add_``."""
    D = 7
    iil, jjl = ii.to(torch.int64), jj.to(torch.int64)
    si = torch.where((iil >= pin) & (iil < n_kf), iil,
                     torch.full_like(iil, K_cap))
    sj = torch.where((jjl >= pin) & (jjl < n_kf), jjl,
                     torch.full_like(jjl, K_cap))
    Hb = H_edges.new_zeros((K_cap + 1, K_cap + 1, D, D))
    Hb.index_put_((si, si), H_edges[:, 0:7, 0:7], accumulate=True)
    Hb.index_put_((si, sj), H_edges[:, 0:7, 7:14], accumulate=True)
    Hb.index_put_((sj, si), H_edges[:, 7:14, 0:7], accumulate=True)
    Hb.index_put_((sj, sj), H_edges[:, 7:14, 7:14], accumulate=True)
    gb = g_edges.new_zeros((K_cap + 1, D))
    gb.index_put_((si,), g_edges[:, 0:7], accumulate=True)
    gb.index_put_((sj,), g_edges[:, 7:14], accumulate=True)
    Hd = Hb[:K_cap, :K_cap].permute(0, 2, 1, 3).reshape(K_cap * D, K_cap * D)
    return Hd, gb[:K_cap].reshape(K_cap * D)


def _host_cholesky_fp64(Hd, gd):
    """fp64 Cholesky solve on the host (``ba.py:432``); zeros when the
    factorization fails or the solution is not finite."""
    import scipy.linalg as sla

    H, g = timing.host_read("ba_fp64", Hd.detach(), gd.detach())
    H, g = H.astype(np.float64), g.astype(np.float64)
    try:
        dx = sla.cho_solve(sla.cho_factor(H, lower=True), g)
    except (np.linalg.LinAlgError, ValueError):
        return np.zeros_like(g, dtype=np.float32)
    if not np.all(np.isfinite(dx)):
        return np.zeros_like(g, dtype=np.float32)
    return dx.astype(np.float32)


def _solve(Hd, gd, n_kf: int, K_cap: int, pin: int, solver: str = "fp32"):
    """Cholesky solve of the assembled system (``ba.py:452``): identity
    diagonals for pinned and inactive rows, Jacobi equilibration, a 1e-8
    ridge; a failed or non-finite solve gives dx = 0. Returns
    (dx (K_cap, 7), free (K_cap,) bool)."""
    D = 7
    kf_ids = torch.arange(K_cap, device=Hd.device)
    free = (kf_ids >= pin) & (kf_ids < n_kf)
    free_rows = free.repeat_interleave(D)
    Hd = Hd + torch.diag((~free_rows).to(Hd.dtype))
    gd = torch.where(free_rows, gd, torch.zeros_like(gd))

    if solver == "fp64_host":
        dx = torch.from_numpy(_host_cholesky_fp64(Hd, gd)).to(Hd.device)
        return -dx.reshape(K_cap, D), free
    if solver != "fp32":
        raise ValueError(f"unknown BA solver {solver!r}")

    d = torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-12))
    d_inv = 1.0 / d
    Hs = Hd * d_inv[:, None] * d_inv[None, :]
    Hs = Hs + 1e-8 * torch.eye(K_cap * D, dtype=Hd.dtype, device=Hd.device)
    L, info = torch.linalg.cholesky_ex(Hs)
    dx = torch.cholesky_solve((gd * d_inv)[:, None], L)[:, 0] * d_inv
    dx = -dx.reshape(K_cap, D)
    ok = (info == 0) & torch.all(torch.isfinite(dx))
    return torch.where(ok, dx, torch.zeros_like(dx)), free


def _edge_system(mode, T_WCs, Xs, Cs, ii, jj, idx, valid_match, Q,
                 edge_mask, n_kf: int, K_cap: int, pin: int, cfg: BAConfig,
                 pre: EdgePre = None, calib: CalibArgs = None, wq=None,
                 plan: AssemblyPlan = None):
    """(H (E, 14, 14), g (E, 14), Hd, gd): the kernel on CUDA tensors,
    ``edge_system_plain`` on CPU tensors."""
    if T_WCs.device.type == "cpu":
        return edge_system_plain(mode, T_WCs, Xs, Cs, ii, jj, idx,
                                 valid_match, Q, edge_mask, n_kf, K_cap, pin,
                                 cfg, pre, calib)
    if pre is None:
        pre = _edge_prep(Xs, Cs, ii, jj, idx, valid_match,
                         stride=cfg.point_stride)
    if wq is None:
        wq = _edge_weights(pre, valid_match, Q, cfg, cfg.point_stride)
    return edge_system(mode, T_WCs, pre, wq, ii, jj, edge_mask, n_kf, K_cap,
                       pin, cfg, calib, plan)


def _gauss_newton(mode, T_WCs, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                  edge_mask, n_kf, cfg: BAConfig, calib=None,
                  replay=None) -> BAResult:
    """The dense solve: ``_system_of`` and ``_solve`` through ``gn_loop``,
    replayed from a graph of its iteration (``replay``; by default on CUDA
    under no_grad with the fp32 solver). The capture needs the addresses of
    the solve's tensors, not their values, so it is made before the plan's
    read of the edge lists: the host captures while the device still runs
    the work queued before the solve (the new edges' decode and match)."""
    exact_fp32()
    n_kf = int(n_kf)
    T = T_WCs.contiguous()
    K_cap, E = T.shape[0], ii.shape[0]
    if replay is None:
        replay = (not graphs.eager(T) and cfg.solver == "fp32"
                  and cfg.max_iters >= 1)
    plan = fill = None
    if replay:
        buf = _plan_buffer(E, K_cap, T.device)
        plan = _plan_views(buf, E)
        _counters(T.device, E)       # grown outside the capture

        def fill():
            with timing.span("ba.plan"):
                _assembly_plan(ii, jj, n_kf, K_cap, cfg.pin, out=buf)
    system = _system_of(mode, T, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                        edge_mask, n_kf, cfg, calib, plan)

    def step(T):
        _, _, Hd, gd = system(T)
        return _solve(Hd, gd, n_kf, K_cap, cfg.pin, cfg.solver)
    return gn_loop(step, T, cfg, replay, fill)


def _system_of(mode, T_WCs, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
               edge_mask, n_kf: int, cfg: BAConfig, calib=None, plan=None):
    """A solve's linear system as a function of the poses, T -> (H, g,
    Hd, gd) (``_edge_system``), with the per-solve work done here once:
    the edge prep and, on CUDA, the weights and the assembly plan (made
    here unless given)."""
    K_cap = T_WCs.shape[0]
    with timing.span("ba.plan"):
        pre = _edge_prep(Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                         stride=cfg.point_stride)
        wq = None
        if T_WCs.is_cuda:
            wq = _edge_weights(pre, valid_match, Q, cfg, cfg.point_stride)
            if plan is None:
                plan = _assembly_plan(ii, jj, n_kf, K_cap, cfg.pin)

    def system(T):
        return _edge_system(mode, T, Xs, Cs, ii, jj, idx_ii2jj, valid_match,
                            Q, edge_mask, n_kf, K_cap, cfg.pin, cfg, pre,
                            calib, wq, plan)
    return system


class Loop(NamedTuple):
    """The Gauss-Newton loop's state on the poses' device (``_loop``),
    updated in place by ``_predicated_iteration`` with no host read."""
    T: torch.Tensor       # (K_cap, 8) poses
    done: torch.Tensor    # () bool: the stop rule has fired
    k: torch.Tensor       # () int64: iterations issued, the next slot
    deltas: torch.Tensor  # (max_iters,) step norms, slot k by k


def _loop(T, max_iters: int) -> Loop:
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=T.device)
    return Loop(T.clone(), z((), torch.bool), z((), torch.int64),
                z((max_iters,), T.dtype))


def _predicated_iteration(loop: Loop, step, cfg: BAConfig):
    """One Gauss-Newton iteration (``ba.py:509-526``) with its stop rule
    kept on the device. ``step(T)`` gives (dx (K_cap, 7), free (K_cap,)
    bool); the free poses move by dx and the step norm is the norm of dx
    over them. Until ``loop.done`` is set it moves ``loop.T`` and writes
    its step norm into slot ``loop.k``; the iteration whose norm is below
    ``cfg.delta_norm`` (compared in fp32, as the JAX package compares it)
    sets ``done`` and keeps its step, and every later one leaves ``T`` and
    the slots as they are."""
    dx, free = step(loop.T)
    T_new = torch.where(free[:, None], sim3.retr(loop.T, dx), loop.T)
    delta = torch.linalg.vector_norm(
        torch.where(free[:, None], dx, torch.zeros_like(dx)))
    live = ~loop.done
    loop.T.copy_(torch.where(live, T_new, loop.T))
    slot = (torch.arange(loop.deltas.shape[0], device=dx.device)
            == loop.k) & live
    loop.deltas.copy_(torch.where(slot, delta, loop.deltas))
    loop.done.logical_or_(delta < float(np.float32(cfg.delta_norm)))
    loop.k.add_(1)


def _loop_deltas(loop: Loop, cfg: BAConfig) -> list:
    """The step norms of the iterations that ran, from one host read: the
    slots up to the first below ``cfg.delta_norm``, where ``done`` was
    set (later slots were never written)."""
    deltas = []
    for d in timing.host_read("ba_deltas", loop.deltas):
        deltas.append(float(d))
        if d < float(np.float32(cfg.delta_norm)):
            break
    return deltas


def gn_loop(step, T, cfg: BAConfig, replay: bool = False,
            before_replay=None) -> BAResult:
    """The Gauss-Newton loop of every BA solver: ``cfg.max_iters``
    iterations of ``_predicated_iteration`` on ``step`` (the solver's
    system at the poses, solved: T -> (dx, free)), one ``ba.iter`` span
    each, then one read of the step norms. Eagerly, or with ``replay``
    (CUDA tensors, no grad) from one CUDA graph of the iteration
    (``graphs.capture``), replayed ``cfg.max_iters`` times and dropped on
    return; ``before_replay()`` runs between the capture and the first
    replay. Both give the same poses, iterations and step norms, bit for
    bit; ``T`` itself is left as it was."""
    loop = _loop(T, cfg.max_iters)
    iteration = lambda: _predicated_iteration(loop, step, cfg)
    if replay:
        iteration = graphs.capture(iteration, T.device, "ba.capture").replay
        if before_replay is not None:
            before_replay()
    for _ in range(cfg.max_iters):
        with timing.span("ba.iter"):
            iteration()
    deltas = _loop_deltas(loop, cfg)
    return BAResult(loop.T, len(deltas), tuple(deltas),
                    "capture" if replay else "eager")


@torch.no_grad()
def gauss_newton_rays(T_WCs, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                      edge_mask, n_kf, cfg: BAConfig) -> BAResult:
    """Global GN on ray + distance residuals (``ba.py:493``).

    Capacity-padded arguments: T_WCs (K, 8); Xs (K, P, 3); Cs (K, P);
    ii, jj (E,) two-way edge endpoints; idx_ii2jj (E, P) int32;
    valid_match (E, P) bool; Q (E, P); edge_mask (E,); n_kf the active
    keyframe count."""
    return _gauss_newton("rays", T_WCs, Xs, Cs, ii, jj, idx_ii2jj,
                         valid_match, Q, edge_mask, n_kf, cfg)


@torch.no_grad()
def gauss_newton_points(T_WCs, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                        edge_mask, n_kf, cfg: BAConfig) -> BAResult:
    """Global GN on 3D point-difference residuals (``ba.py:530``)."""
    return _gauss_newton("points", T_WCs, Xs, Cs, ii, jj, idx_ii2jj,
                         valid_match, Q, edge_mask, n_kf, cfg)


@torch.no_grad()
def gauss_newton_calib(T_WCs, Xs, Cs, K_mat, ii, jj, idx_ii2jj, valid_match,
                       Q, edge_mask, n_kf, img_size,
                       cfg: BAConfig) -> BAResult:
    """Global GN on pixel + log-depth residuals (``ba.py:560``). ``Xs``
    must already lie on the calibrated rays
    (``geometry.constrain_points_to_ray``)."""
    return _gauss_newton("calib", T_WCs, Xs, Cs, ii, jj, idx_ii2jj,
                         valid_match, Q, edge_mask, n_kf, cfg,
                         _calib_args(K_mat, img_size))
