"""Edge-sharded global bundle adjustment over a device list.

Counterpart of ``mast3r_slam_tpu/parallel/dist_ba.py``. The edges are split
into ``mesh.size`` equal chunks (padded with masked edges), one per device.
Once per solve each shard gathers its edges' matched points
(``ba._edge_prep``: the ``gather_rows`` kernel on CUDA) and, on CUDA, makes
its weights and assembly plan. Per Gauss-Newton iteration each shard builds
the dense (7K)^2 system of its own edges (``ba.edge_system``: one launch of
the ``ba_edge_terms`` kernel on CUDA; ``edge_system_plain`` on the CPU),
the partial systems are summed on the first device in shard order and,
across processes, all-reduced (``mesh.reduce_partials``: the JAX package's
``psum``, in a fixed order), ``ba._solve`` runs there, and the new poses
are replicated to every shard for the next iteration. Every rank then
holds the same system and runs the same solve, so the ranks' poses are
bit-identical and their stop rule, the dense loop's with its one host read
per iteration, stops them at the same iteration.

The keyframe-sharded variant (``shard_keyframe_store``,
``prep_edges_kf_sharded``, ``gauss_newton_rays_dist_pre``) keeps each
keyframe's maps on one device only: before the loop, each edge's endpoint
points are gathered on the device that holds that keyframe and moved to
the edge's shard; the loop then reads no keyframe map. Across processes
that move would cross ranks, which is not ported: ``shard_keyframe_store``
and ``prep_edges_kf_sharded`` raise ``NotImplementedError`` for a mesh that
spans processes (ROADMAP.md queue 1 item 7).

The edge lists are read to the host once per solve, for every shard's
assembly plan (and the keyframe-sharded gather's selections).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import exact_fp32
from ..slam import ba
from .mesh import (Mesh, one_process_only, reduce_partials, replicate,
                   shard_edges)

__all__ = ["gauss_newton_dist", "gauss_newton_rays_dist",
           "gauss_newton_calib_dist", "gauss_newton_rays_dist_pre",
           "prep_edges_kf_sharded", "shard_keyframe_store"]


class _Shard(NamedTuple):
    """One device's edges and their loop-invariant data."""
    device: torch.device
    ii: torch.Tensor
    jj: torch.Tensor
    valid_match: torch.Tensor
    Q: torch.Tensor
    edge_mask: torch.Tensor
    pre: ba.EdgePre
    wq: Optional[torch.Tensor]           # CUDA only
    plan: Optional[ba.AssemblyPlan]      # CUDA only


def host_edges(ii, jj) -> np.ndarray:
    """The edge lists on the host, (2, E) int64: the solve's one read."""
    return torch.stack([ii.to(torch.int64), jj.to(torch.int64)]).cpu().numpy()


def _shards(mesh: Mesh, ij, ii, jj, valid_match, Q, edge_mask, pres, n_kf,
            K_cap, cfg: ba.BAConfig):
    """This process's shards: each local device's edges with their weights
    and plan (``pres``: each local shard's ``EdgePre``)."""
    chunks = shard_edges(mesh, ii, jj, valid_match, Q, edge_mask)
    E_loc = ii.shape[0] // mesh.size
    out = []
    for l, (dev, pre, ii_s, jj_s, vm_s, Q_s, m_s) in enumerate(
            zip(mesh.devices, pres, *chunks)):
        wq = plan = None
        if dev.type == "cuda":
            s = mesh.first_shard + l
            wq = ba._edge_weights(pre, vm_s, Q_s, cfg, cfg.point_stride)
            plan = ba._assembly_plan_host(
                ij[:, s * E_loc:(s + 1) * E_loc], n_kf, K_cap, cfg.pin,
                dev)
        out.append(_Shard(dev, ii_s, jj_s, vm_s, Q_s, m_s, pre, wq, plan))
    return out


def _system(mode, shards, T, n_kf: int, K_cap: int, cfg: ba.BAConfig,
            calib, mesh: Mesh):
    """The whole (7K)^2 system: each local shard's partial system at poses
    T, summed on the first local device in shard order and, across the
    processes of ``mesh``, all-reduced (``reduce_partials``)."""
    parts = []
    for sh in shards:
        _, _, Hd_s, gd_s = ba._edge_system(
            mode, T.to(sh.device), None, None, sh.ii, sh.jj, None,
            sh.valid_match, sh.Q, sh.edge_mask, n_kf, K_cap, cfg.pin,
            cfg, sh.pre, calib, sh.wq, sh.plan)
        parts.append((Hd_s, gd_s))
    return reduce_partials(mesh, parts)


def _gn_loop(mode, shards, T_WCs, n_kf: int, cfg: ba.BAConfig, calib,
             mesh: Mesh) -> ba.BAResult:
    K_cap = T_WCs.shape[0]
    T = T_WCs.to(shards[0].device).contiguous()
    deltas = []
    while len(deltas) < cfg.max_iters:
        Hd, gd = _system(mode, shards, T, n_kf, K_cap, cfg, calib, mesh)
        T, done = ba._step(T, Hd, gd, n_kf, K_cap, cfg, deltas)
        if done:
            break
    return ba.BAResult(T, len(deltas), tuple(deltas))


def _check_edges(mesh: Mesh, ii):
    if ii.shape[0] % mesh.size:
        raise ValueError(f"{ii.shape[0]} edges do not split over "
                         f"{mesh.size} devices: pad them with masked edges "
                         "(mesh.pad_to_multiple)")


@torch.no_grad()
def gauss_newton_dist(T_WCs, Xs, Cs, K_mat, ii, jj, idx_ii2jj, valid_match,
                      Q, edge_mask, n_kf, mesh: Mesh, cfg: ba.BAConfig,
                      residual: str = "rays", img_size=None) -> ba.BAResult:
    """Edge-sharded global GN (``dist_ba.py:143``): the contract of the
    ``slam.ba`` solvers, with edge arrays whose length divides by
    ``mesh.size`` (padded with masked edges). ``residual``: "rays",
    "calib" (needs K_mat and img_size) or "points". The poses come back on
    ``mesh.devices[0]``. Across processes every rank passes the same
    arguments and gets the same poses."""
    if residual not in ba.MODES:
        raise ValueError(f"unknown residual {residual!r}")
    exact_fp32()
    _check_edges(mesh, ii)
    n_kf = int(n_kf)
    calib = (ba._calib_args(K_mat, img_size) if residual == "calib"
             else None)
    shards = replicated_shards(mesh, host_edges(ii, jj), Xs, Cs, ii, jj,
                               idx_ii2jj, valid_match, Q, edge_mask, n_kf,
                               T_WCs.shape[0], cfg)
    return _gn_loop(residual, shards, T_WCs, n_kf, cfg, calib, mesh)


def replicated_shards(mesh: Mesh, ij, Xs, Cs, ii, jj, idx_ii2jj,
                      valid_match, Q, edge_mask, n_kf: int, K_cap: int,
                      cfg: ba.BAConfig):
    """This process's shards and their loop-invariant data, the keyframe
    maps replicated: each shard gathers its own edges' points (``ij``: the
    edge lists on the host)."""
    chunks = shard_edges(mesh, ii, jj, idx_ii2jj, valid_match)
    pres = []
    for dev, X_s, C_s, ii_s, jj_s, idx_s, vm_s in zip(
            mesh.devices, *replicate(mesh, Xs, Cs), *chunks):
        pres.append(ba._edge_prep(X_s, C_s, ii_s, jj_s, idx_s, vm_s,
                                  stride=cfg.point_stride))
    return _shards(mesh, ij, ii, jj, valid_match, Q, edge_mask, pres, n_kf,
                   K_cap, cfg)


def gauss_newton_rays_dist(T_WCs, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                           edge_mask, n_kf, mesh: Mesh,
                           cfg: ba.BAConfig) -> ba.BAResult:
    """Ray + distance variant of ``gauss_newton_dist`` (``:111``)."""
    return gauss_newton_dist(T_WCs, Xs, Cs, None, ii, jj, idx_ii2jj,
                             valid_match, Q, edge_mask, n_kf, mesh, cfg,
                             residual="rays")


def gauss_newton_calib_dist(T_WCs, Xs, Cs, K_mat, ii, jj, idx_ii2jj,
                            valid_match, Q, edge_mask, n_kf, img_size,
                            mesh: Mesh, cfg: ba.BAConfig) -> ba.BAResult:
    """Pixel + log-depth variant of ``gauss_newton_dist`` (``:121``); Xs
    must already lie on the calibrated rays."""
    return gauss_newton_dist(T_WCs, Xs, Cs, K_mat, ii, jj, idx_ii2jj,
                             valid_match, Q, edge_mask, n_kf, mesh, cfg,
                             residual="calib", img_size=img_size)


# -- keyframe-sharded maps ----------------------------------------------------



def shard_keyframe_store(mesh: Mesh, Xs, Cs):
    """Keyframe maps (K, P, 3) and confidences (K, P) in ``mesh.size``
    contiguous blocks, block ``b`` on ``mesh.devices[b]`` (``:32``); K must
    divide by ``mesh.size`` (pad with ``mesh.pad_to_multiple``). Returns
    the lists of blocks. One process only."""
    one_process_only(mesh, "shard_keyframe_store", 7)
    return shard_edges(mesh, Xs, Cs)


def prep_edges_kf_sharded(mesh: Mesh, Xs_sh, Cs_sh, ii, jj, idx,
                          valid_match, stride: int = 1):
    """Each edge shard's ``EdgePre`` from keyframe-sharded maps (``:44``):
    the endpoint points of each edge are gathered on the device that holds
    that keyframe (keyframe i's at the match indices through
    ``ba._gather_points``, the ``gather_rows`` kernel on CUDA; keyframe j's
    at every ``stride``-th pixel) and moved to the edge's shard. One process
    only."""
    one_process_only(mesh, "prep_edges_kf_sharded", 7)
    _check_edges(mesh, ii)
    B = Xs_sh[0].shape[0]
    XC = [torch.cat([X, C[..., None]], dim=-1) for X, C in zip(Xs_sh, Cs_sh)]
    ij = host_edges(ii, jj)
    E_loc = ii.shape[0] // mesh.size
    out = []
    for s, (dev, idx_s, vm_s) in enumerate(
            zip(mesh.devices, *shard_edges(mesh, idx, valid_match))):
        safe = torch.where(vm_s[:, ::stride], idx_s[:, ::stride].to(
            torch.int32), torch.zeros((), dtype=torch.int32,
                                      device=dev)).contiguous()
        XCi = XC[0].new_empty((E_loc, safe.shape[1], 4), device=dev)
        XCj = torch.empty_like(XCi)
        ij_s = ij[:, s * E_loc:(s + 1) * E_loc]
        for b, (dev_b, XC_b) in enumerate(zip(mesh.devices, XC)):
            for side, dst in ((0, XCi), (1, XCj)):
                sel = np.flatnonzero(ij_s[side] // B == b)
                if not sel.size:
                    continue
                # one upload: the shard's edges and their rows in block b
                both = torch.from_numpy(np.stack(
                    [sel, ij_s[side, sel] - b * B])).to(dev_b)
                if side == 0:
                    got = ba._gather_points(XC_b, both[1],
                                            safe.to(dev_b)[both[0]])
                else:
                    got = XC_b[both[1], ::stride]
                dst[both[0].to(dev)] = got.to(dev)
        out.append(ba.EdgePre(XCi, XCj, safe))
    return out


@torch.no_grad()
def gauss_newton_rays_dist_pre(T_WCs, pre, ii, jj, valid_match, Q, edge_mask,
                               n_kf, mesh: Mesh,
                               cfg: ba.BAConfig) -> ba.BAResult:
    """Edge-sharded ray + distance GN over pre-gathered edge data
    (``:63``): ``pre`` is ``prep_edges_kf_sharded``'s list, one
    ``EdgePre`` a shard."""
    exact_fp32()
    _check_edges(mesh, ii)
    n_kf = int(n_kf)
    shards = _shards(mesh, host_edges(ii, jj), ii, jj, valid_match, Q,
                     edge_mask, pre, n_kf, T_WCs.shape[0], cfg)
    return _gn_loop("rays", shards, T_WCs, n_kf, cfg, None, mesh)
