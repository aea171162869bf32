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
bit-identical; the loop is the dense solver's (``ba.gn_loop``), called
eagerly, so every rank issues ``max_iters`` iterations and their
collectives.

The keyframe-sharded variant (``shard_keyframe_store``,
``prep_edges_kf_sharded``, ``gauss_newton_rays_dist_pre``) keeps each
keyframe's maps on one device only, in ``mesh.size`` contiguous blocks:
before the loop, each edge's endpoint points are gathered on the device
that holds that keyframe and moved to the edge's shard; the loop then reads
no keyframe map. Across processes the points bound for another rank's
shards go in one ``mesh.exchange`` (the all-to-all that GSPMD inserts for
the JAX package); each shard's ``EdgePre`` is the one-process prep's for
that shard, bit for bit.

The edge lists are read to the host once per solve, for every shard's
assembly plan (and the keyframe-sharded gather's selections).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import exact_fp32
from ..slam import ba
from ..utils import timing
from .mesh import (Mesh, exchange, reduce_partials, replicate,
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
    return timing.host_read("ba_plan", torch.stack([ii.to(torch.int64),
                                                    jj.to(torch.int64)]))


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


def _summed_solve(mode, shards, T_WCs, n_kf: int, cfg: ba.BAConfig,
                  calib, mesh: Mesh) -> ba.BAResult:
    """``ba.gn_loop`` on the summed shards' system, solved by
    ``ba._solve`` on the first local device."""
    K_cap = T_WCs.shape[0]

    def step(T):
        Hd, gd = _system(mode, shards, T, n_kf, K_cap, cfg, calib, mesh)
        return ba._solve(Hd, gd, n_kf, K_cap, cfg.pin, cfg.solver)
    return ba.gn_loop(step, T_WCs.to(shards[0].device).contiguous(), cfg)


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
    return _summed_solve(residual, shards, T_WCs, n_kf, cfg, calib, mesh)


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
    contiguous blocks (``:32``): this process's blocks, block
    ``first_shard + l`` on ``mesh.devices[l]``, as ``shard_edges`` lays
    them out. K must divide by ``mesh.size`` (``ValueError``; pad with
    ``mesh.pad_to_multiple``). Returns the lists of local blocks."""
    if Xs.shape[0] % mesh.size:
        raise ValueError(f"{Xs.shape[0]} keyframes do not split over "
                         f"{mesh.size} devices: pad them "
                         "(mesh.pad_to_multiple)")
    return shard_edges(mesh, Xs, Cs)


class _Route(NamedTuple):
    """The edges of one shard whose endpoint on one side lies in one
    keyframe block, and the ranks that hold the block and the shard."""
    src: int            # rank of the block
    dst: int            # rank of the edge shard
    shard: int          # global edge shard
    block: int          # global keyframe block
    side: int           # 0: keyframe i at the matches, 1: keyframe j
    sel: np.ndarray     # the edges, as indices within the shard
    rows: np.ndarray    # their keyframes, as rows of the block


def _routes(mesh: Mesh, ij, B: int) -> list:
    """Every non-empty (shard, block, side), ordered by destination rank,
    then shard, then block, then side: a rank sends its part of this list
    to each other rank in this order and receives in the same order."""
    n_loc, E_loc = len(mesh.devices), ij.shape[1] // mesh.size
    out = []
    for s in range(mesh.size):
        ij_s = ij[:, s * E_loc:(s + 1) * E_loc]
        for b in range(mesh.size):
            for side in (0, 1):
                sel = np.flatnonzero(ij_s[side] // B == b)
                if sel.size:
                    out.append(_Route(b // n_loc, s // n_loc, s, b, side,
                                      sel, ij_s[side, sel] - b * B))
    return out


def kf_gather(mesh: Mesh, Xs_sh, Cs_sh, ii, jj, idx, valid_match,
              stride: int = 1):
    """The gathering half of ``prep_edges_kf_sharded``: for every route
    whose block this rank holds, the points gathered on the block's device.

    Returns (``pres``: this rank's shards' ``EdgePre`` with the local
    routes' points in place, ``send``: per rank the points bound there,
    ``recv``: per rank the shapes to receive, ``incoming``: the routes
    whose points arrive, in arrival order)."""
    _check_edges(mesh, ii)
    if len(Xs_sh) != len(mesh.devices):
        raise ValueError(f"{len(Xs_sh)} keyframe blocks for "
                         f"{len(mesh.devices)} local devices")
    B = Xs_sh[0].shape[0]
    ij = host_edges(ii, jj)
    if ij.size and ij.max() >= B * mesh.size:
        raise ValueError(f"edge endpoint {ij.max()} outside the "
                         f"{B * mesh.size} keyframes of the blocks")
    XC = [torch.cat([X, C[..., None]], dim=-1) for X, C in zip(Xs_sh, Cs_sh)]
    E_loc = ii.shape[0] // mesh.size
    me, lo = mesh.rank, mesh.first_shard
    safe = {}

    def safe_of(s, dev):
        """Shard ``s``'s safe match indices on ``dev``, made once."""
        if (s, dev) not in safe:
            rows = slice(s * E_loc, (s + 1) * E_loc)
            vm_s = valid_match[rows, ::stride].to(dev)
            safe[s, dev] = torch.where(
                vm_s, idx[rows, ::stride].to(dev, torch.int32),
                torch.zeros((), dtype=torch.int32, device=dev)).contiguous()
        return safe[s, dev]

    pres = []
    for l, dev in enumerate(mesh.devices):
        sf = safe_of(lo + l, dev)
        XCi = XC[0].new_empty((E_loc, sf.shape[1], 4), device=dev)
        pres.append(ba.EdgePre(XCi, torch.empty_like(XCi), sf))
    send = [[] for _ in range(mesh.world_size)]
    recv = [[] for _ in range(mesh.world_size)]
    incoming = []
    P_ = pres[0].safe_idx.shape[1]
    for rt in _routes(mesh, ij, B):
        if rt.src != me:
            if rt.dst == me:
                recv[rt.src].append(((rt.sel.size, P_, 4), XC[0].dtype))
                incoming.append(rt)
            continue
        dev_b, XC_b = mesh.devices[rt.block - lo], XC[rt.block - lo]
        # one upload: the shard's edges and their rows in the block
        both = torch.from_numpy(np.stack([rt.sel, rt.rows])).to(dev_b)
        if rt.side == 0:
            got = ba._gather_points(XC_b, both[1],
                                    safe_of(rt.shard, dev_b)[both[0]])
        else:
            got = XC_b[both[1], ::stride]
        if rt.dst == me:
            _place(pres, rt, got, lo)
        else:
            send[rt.dst].append(got)
    return pres, send, recv, incoming


def _place(pres, rt: _Route, got, lo: int):
    """A route's points into its edges' rows of the shard's ``EdgePre``."""
    pre = pres[rt.shard - lo]
    dst = pre.XCi if rt.side == 0 else pre.XCj
    dst[torch.from_numpy(rt.sel).to(dst.device)] = got.to(dst.device)


def prep_edges_kf_sharded(mesh: Mesh, Xs_sh, Cs_sh, ii, jj, idx,
                          valid_match, stride: int = 1):
    """Each local edge shard's ``EdgePre`` from keyframe-sharded maps
    (``:44``): for every edge of every shard whose endpoint keyframe lies
    in a local block, this rank gathers keyframe i's points at the safe
    match indices (``ba._gather_points``, the ``gather_rows`` kernel on
    CUDA) or keyframe j's points at every ``stride``-th pixel, on the
    block's device; one ``mesh.exchange`` routes the points bound for other
    ranks. ``ii``, ``jj``, ``idx`` and ``valid_match`` are the whole
    (padded) edge arrays, the same on every rank. Returns one ``EdgePre``
    a local shard, equal to the one-process prep's for that global shard
    index."""
    pres, send, recv, incoming = kf_gather(mesh, Xs_sh, Cs_sh, ii, jj, idx,
                                           valid_match, stride)
    got = exchange(mesh, send, recv, dtypes=(pres[0].XCi.dtype,))
    taken = [0] * mesh.world_size
    for rt in incoming:
        _place(pres, rt, got[rt.src][taken[rt.src]], mesh.first_shard)
        taken[rt.src] += 1
    return pres


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
    return _summed_solve("rays", shards, T_WCs, n_kf, cfg, None, mesh)
