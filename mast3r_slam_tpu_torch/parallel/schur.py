"""Schur-complement global bundle adjustment over a device list.

Counterpart of ``mast3r_slam_tpu/parallel/schur.py``. The keyframes are
split into blocks, one per device. Keyframes touched by a cross-block edge
form the separator S; the others are block interiors I_p, whose Hessian
rows only their own block's edges reach. Each device eliminates its
interior exactly,

    S_red = H_SS - sum_p H_SI_p H_II_p^-1 H_IS_p
    dx_S  = S_red^-1 (g_S - sum_p H_SI_p H_II_p^-1 g_I_p)
    dx_Ip = H_II_p^-1 (g_I_p - H_IS_p dx_S),

so the shards exchange the (7 S)^2 reduced system a Gauss-Newton
iteration instead of the (7K)^2 dense one, and each factors only its own
interior block. The Cholesky factors are ``torch.linalg.cholesky_ex`` and
``cholesky_solve``: the JAX package computes them with
``jax.scipy.linalg`` outside any kernel.

The partition (``schur_partition``, ``separator_dominated``) is host numpy,
a copy of the JAX package's with the same integer outputs. Per iteration
each shard builds its edges' blocks H (E, 14, 14), g (E, 14) with the
``ba_edge_terms`` kernel on CUDA (``ba.edge_system``, which also assembles
the (7K)^2 system, unused here) or ``edge_system_plain`` on the CPU, and
scatters them into its (I_cap + S_cap) local slots in edge order, as
``ba._assemble`` does. Three reductions cross the shards, each through
``mesh.reduce_partials`` (in shard order on the first local device, then an
all-reduce across processes): the reduced systems (summed), the
back-substituted interior steps (summed: each shard's interior rows are its
own) and the shards' success flags (min). Every rank then solves the same
separator system and retracts the same poses. The iteration runs in the
dense solver's loop (``ba.gn_loop``), eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import exact_fp32
from ..slam import ba
from .dist_ba import _check_edges, host_edges, replicated_shards
from .mesh import Mesh, reduce_partials

__all__ = ["SchurPartition", "schur_partition", "separator_dominated",
           "reorder_edges", "gauss_newton_schur", "gauss_newton_rays_schur",
           "gauss_newton_calib_schur"]

D = 7


class SchurPartition(NamedTuple):
    """Host-built keyframe partition (``schur.py:47``); arrays over
    keyframe ids.

    owner[k]     — the block (device) owning keyframe k.
    int_slot[k]  — k's interior slot in its block (-1 for a separator).
    sep_slot[k]  — k's separator slot (-1 for an interior keyframe).
    I_cap, S_cap — interior and separator slot counts.
    """

    owner: np.ndarray
    int_slot: np.ndarray
    sep_slot: np.ndarray
    I_cap: int
    S_cap: int


def _greedy_owner(ii, jj, em, K_cap: int, n_shards: int, B: int):
    """Connectivity-aware block assignment (``schur.py:66``). A split by id
    cuts every loop-closure edge, and both its endpoints become
    separators; loop closures pair a revisited interval of the trajectory
    with its partner, so the blocks should too:

      1. union-find over the active keyframes, merging loop edges first
         (widest span first), then chain edges in id order, a cluster
         never growing past the block capacity ``B``;
      2. first-fit-decreasing packing of the clusters into ``n_shards``
         blocks of capacity ``B`` (a cluster that fits nowhere is spread
         over the emptiest blocks: its members become separators);
      3. untouched ids fill the remaining capacity in id order.
    """
    parent = np.arange(K_cap)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    size = np.ones(K_cap, np.int64)

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra == rb or size[ra] + size[rb] > B:
            return
        if size[ra] < size[rb]:
            ra, rb = rb, ra
        parent[rb] = ra
        size[ra] += size[rb]

    ai, aj = ii[em], jj[em]
    dist = np.abs(ai.astype(np.int64) - aj.astype(np.int64))
    loops = dist > 1
    for a, b in sorted({(min(a, b), max(a, b))
                        for a, b in zip(ai[loops], aj[loops])},
                       key=lambda p: p[0] - p[1]):
        union(a, b)
    for a, b in sorted({(min(a, b), max(a, b))
                        for a, b in zip(ai[~loops], aj[~loops])}):
        union(a, b)

    touched = np.zeros(K_cap, bool)
    touched[ai] = True
    touched[aj] = True
    clusters = {}
    for k in np.nonzero(touched)[0]:
        clusters.setdefault(find(k), []).append(int(k))

    owner = np.full(K_cap, -1, np.int32)
    load = np.zeros(n_shards, np.int64)
    for members in sorted(clusters.values(), key=len, reverse=True):
        p = int(np.argmin(load))
        if load[p] + len(members) <= B:
            owner[members] = p
            load[p] += len(members)
        else:
            for k in members:
                p = int(np.argmin(load))
                owner[k] = p
                load[p] += 1
    for k in np.nonzero(owner < 0)[0]:
        p = int(np.argmin(load))
        owner[k] = p
        load[p] += 1
    return owner


def schur_partition(ii, jj, edge_mask, K_cap: int, n_shards: int,
                    sep_bucket: int = 8, method: str = "greedy"):
    """Partition the keyframes and order the edges so that device p's
    contiguous chunk holds exactly the edges its block owns (``:146``).

    An edge belongs to the block of its ``ii`` endpoint; a cross-block edge
    makes both endpoints separators. Returns ``(part, order, keep)``: apply
    ``order`` and ``keep`` (False on pad slots) with ``reorder_edges``. The
    chunk length E_loc is the largest block's edge count, rounded up to a
    power of two (at least 8); ``S_cap`` is rounded up to ``sep_bucket``,
    as in the JAX package. ``method``: "greedy" (``_greedy_owner``) or
    "contiguous" (blocks of consecutive ids)."""
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    em = np.asarray(edge_mask).astype(bool)

    I_cap = -(-K_cap // n_shards)
    if method == "greedy" and em.any():
        owner = _greedy_owner(ii, jj, em, K_cap, n_shards, I_cap)
    else:
        owner = np.minimum(np.arange(K_cap) // I_cap, n_shards - 1).astype(
            np.int32)

    cross = em & (owner[ii] != owner[jj])
    is_sep = np.zeros(K_cap, bool)
    is_sep[ii[cross]] = True
    is_sep[jj[cross]] = True

    sep_ids = np.nonzero(is_sep)[0]
    S_cap = min(K_cap,
                max(sep_bucket, sep_bucket * -(-len(sep_ids) // sep_bucket)))
    sep_slot = np.full(K_cap, -1, np.int32)
    sep_slot[sep_ids] = np.arange(len(sep_ids), dtype=np.int32)
    int_slot = np.full(K_cap, -1, np.int32)
    for p in range(n_shards):
        blk = np.nonzero((owner == p) & ~is_sep)[0]
        int_slot[blk] = np.arange(len(blk), dtype=np.int32)

    edge_owner = owner[ii]
    counts = np.bincount(edge_owner[em], minlength=n_shards)
    E_loc = max(8, int(counts.max()))
    E_loc = 1 << (E_loc - 1).bit_length()
    order = np.zeros(n_shards * E_loc, dtype=np.int32)   # pad -> edge 0
    keep = np.zeros(n_shards * E_loc, dtype=bool)
    for p in range(n_shards):
        mine = np.nonzero(em & (edge_owner == p))[0]
        order[p * E_loc:p * E_loc + len(mine)] = mine
        keep[p * E_loc:p * E_loc + len(mine)] = True

    part = SchurPartition(owner=owner, int_slot=int_slot, sep_slot=sep_slot,
                          I_cap=int(I_cap), S_cap=int(S_cap))
    return part, order, keep


def separator_dominated(part: SchurPartition, n_active: int,
                        frac: float = 0.5) -> bool:
    """True when at least ``frac`` of the active keyframes are separators
    (``:211``): the reduction then eliminates almost nothing and the
    caller should solve edge-sharded (``dist_ba``) instead."""
    n_active = int(n_active)
    if n_active <= 0:
        return False
    n_sep = int((np.asarray(part.sep_slot[:n_active]) >= 0).sum())
    return n_sep >= frac * n_active


def reorder_edges(order, keep, ii, jj, idx, valid_match, Q, edge_mask):
    """A ``schur_partition`` permutation applied to the edge arrays on
    their device (``:229``; one upload of the permutation); pad slots get
    edge mask 0."""
    dev = ii.device
    ok = torch.from_numpy(np.stack([np.asarray(order, np.int64),
                                     np.asarray(keep, np.int64)])).to(dev)
    take = lambda a: a.index_select(0, ok[0])
    return (take(ii), take(jj), take(idx), take(valid_match), take(Q),
            take(edge_mask) * ok[1].to(edge_mask.dtype))


def _equilibrate(Hd, gd, free_rows):
    """Identity rows for unused slots and Jacobi scaling (``:243``), as
    ``ba._solve`` conditions the dense system."""
    Hd = Hd + torch.diag((~free_rows).to(Hd.dtype))
    gd = torch.where(free_rows, gd, torch.zeros_like(gd))
    d_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-12))
    Hs = Hd * d_inv[:, None] * d_inv[None, :]
    Hs = Hs + 1e-8 * torch.eye(Hd.shape[0], dtype=Hd.dtype, device=Hd.device)
    return Hs, gd, d_inv


def _solve_vec(L, b):
    return torch.cholesky_solve(b[:, None], L)[:, 0]


class _Blocks(NamedTuple):
    """One shard's slots (device tensors, made once per solve)."""
    si: torch.Tensor        # (E_loc,) local block row of each edge's i
    sj: torch.Tensor        # (E_loc,) and of its j (sentinel L if not here)
    free_I: torch.Tensor    # (7 I_cap,) rows of the used interior slots
    mine: torch.Tensor      # (K_cap,) this block's active interiors
    int_slot: torch.Tensor  # (K_cap,) int64, clipped at 0


def _blocks(ij, part: SchurPartition, p: int, kf_act, dev) -> _Blocks:
    """Shard p's local slots: interiors first, then separators; an endpoint
    that is inactive, pinned or another block's interior goes to the
    sentinel slot (``schur.py:335-350``)."""
    L = part.I_cap + part.S_cap
    sep = part.sep_slot >= 0

    def slot(k):
        s = np.where(sep[k], part.I_cap + part.sep_slot[k], part.int_slot[k])
        local = sep[k] | (part.owner[k] == p)
        return np.where(kf_act[k] & local & (s >= 0), s, L)

    mine = (part.owner == p) & ~sep & kf_act & (part.int_slot >= 0)
    used = np.zeros(part.I_cap, bool)
    used[part.int_slot[mine]] = True
    packed = np.stack([slot(ij[0]), slot(ij[1])])
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    si_sj = up(packed.astype(np.int64))
    return _Blocks(si_sj[0], si_sj[1], up(np.repeat(used, D)), up(mine),
                   up(np.maximum(part.int_slot, 0).astype(np.int64)))


def _local_system(H, g, b: _Blocks, L: int):
    """Edge blocks into the (L D)^2 local system in edge order, the
    sentinel slot L cut off (``ba._assemble``'s order)."""
    si, sj = b.si, b.sj
    Hb = H.new_zeros((L + 1, L + 1, D, D))
    Hb.index_put_((si, si), H[:, 0:7, 0:7], accumulate=True)
    Hb.index_put_((si, sj), H[:, 0:7, 7:14], accumulate=True)
    Hb.index_put_((sj, si), H[:, 7:14, 0:7], accumulate=True)
    Hb.index_put_((sj, sj), H[:, 7:14, 7:14], accumulate=True)
    gb = g.new_zeros((L + 1, D))
    gb.index_put_((si,), g[:, 0:7], accumulate=True)
    gb.index_put_((sj,), g[:, 7:14], accumulate=True)
    return (Hb[:L, :L].permute(0, 2, 1, 3).reshape(L * D, L * D),
            gb[:L].reshape(L * D))


@torch.no_grad()
def gauss_newton_schur(T_WCs, Xs, Cs, K_mat, owner, int_slot, sep_slot, ii,
                       jj, idx_ii2jj, valid_match, Q, edge_mask, n_kf,
                       I_cap: int, S_cap: int, mesh: Mesh, cfg: ba.BAConfig,
                       residual: str = "rays", img_size=None) -> ba.BAResult:
    """Global GN with each block's interior eliminated on its device
    (``:291``): the contract of the ``slam.ba`` solvers over edge arrays
    ordered by ``schur_partition`` (device p's chunk holds its block's
    edges); ``owner``, ``int_slot``, ``sep_slot`` from its partition.
    ``residual``: "rays", "calib" (needs K_mat and img_size) or "points".
    The poses come back on ``mesh.devices[0]``; across processes every rank
    passes the same arguments and gets the same poses."""
    if residual not in ba.MODES:
        raise ValueError(f"unknown residual {residual!r}")
    exact_fp32()
    _check_edges(mesh, ii)
    n_kf = int(n_kf)
    K_cap = T_WCs.shape[0]
    host = lambda a: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a))
    part = SchurPartition(host(owner), host(int_slot), host(sep_slot),
                          int(I_cap), int(S_cap))
    calib = (ba._calib_args(K_mat, img_size) if residual == "calib"
             else None)
    L, nI = I_cap + S_cap, D * I_cap
    kf = np.arange(K_cap)
    kf_act = (kf >= cfg.pin) & (kf < n_kf)
    used_S = np.zeros(S_cap, bool)
    used_S[part.sep_slot[(part.sep_slot >= 0) & kf_act]] = True

    ij = host_edges(ii, jj)
    shards = replicated_shards(mesh, ij, Xs, Cs, ii, jj, idx_ii2jj,
                               valid_match, Q, edge_mask, n_kf, K_cap, cfg)
    E_loc = ii.shape[0] // mesh.size
    blocks = [_blocks(ij[:, p * E_loc:(p + 1) * E_loc], part, p, kf_act,
                      sh.device)
              for p, sh in enumerate(shards, start=mesh.first_shard)]
    d0 = shards[0].device
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d0)
    free_S = up(np.repeat(used_S, D))
    sep_act = up((part.sep_slot >= 0) & kf_act)
    sep_idx = up(np.maximum(part.sep_slot, 0).astype(np.int64))
    free = up(kf_act)

    def step(T):
        local, reduced = [], []
        for sh, b in zip(shards, blocks):
            H, g, _, _ = ba._edge_system(
                residual, T.to(sh.device), None, None, sh.ii, sh.jj, None,
                sh.valid_match, sh.Q, sh.edge_mask, n_kf, K_cap, cfg.pin,
                cfg, sh.pre, calib, sh.wq, sh.plan)
            Hd, gd = _local_system(H, g, b, L)
            H_IS, H_SS = Hd[:nI, nI:], Hd[nI:, nI:]
            Hs_II, g_I, dI = _equilibrate(Hd[:nI, :nI], gd[:nI], b.free_I)
            L_II, info = torch.linalg.cholesky_ex(Hs_II)
            B = H_IS * dI[:, None]                       # D^-1/2 H_IS
            S_p = H_SS - B.T @ torch.cholesky_solve(B, L_II)
            g_p = gd[nI:] - B.T @ _solve_vec(L_II, g_I * dI)
            local.append((L_II, info, dI, g_I, H_IS))
            reduced.append((S_p, g_p))
        S_red, g_red = reduce_partials(mesh, reduced)
        # the separator system, on the first device
        Hs_S, g_red, dS = _equilibrate(S_red, g_red, free_S)
        L_SS, info_S = torch.linalg.cholesky_ex(Hs_S)
        x_S = dS * _solve_vec(L_SS, g_red * dS)
        ok_S = (info_S == 0) & torch.all(torch.isfinite(x_S))
        dx_S = torch.where(sep_act[:, None], x_S.reshape(S_cap, D)[sep_idx],
                           torch.zeros((), dtype=x_S.dtype, device=d0))
        # back-substitution on each shard; interiors are disjoint by shard,
        # so each row of the sums below has one nonzero term
        steps, oks = [], []
        for sh, b, (L_II, info, dI, g_I, H_IS) in zip(shards, blocks, local):
            x_I = dI * _solve_vec(L_II, dI * (g_I - H_IS @ x_S.to(
                sh.device)))
            steps.append((torch.where(b.mine[:, None],
                                      x_I.reshape(-1, D)[b.int_slot],
                                      torch.zeros((), dtype=x_I.dtype,
                                                  device=sh.device)),))
            oks.append(((info == 0) & torch.all(torch.isfinite(x_I)),))
        (dx_I,) = reduce_partials(mesh, steps)
        (ok,) = reduce_partials(mesh, oks, op="min")
        dx = dx_S + dx_I
        return torch.where(ok & ok_S, -dx, torch.zeros_like(dx)), free
    return ba.gn_loop(step, T_WCs.to(d0).contiguous(), cfg)


def gauss_newton_rays_schur(T_WCs, Xs, Cs, owner, int_slot, sep_slot, ii, jj,
                            idx_ii2jj, valid_match, Q, edge_mask, n_kf,
                            I_cap: int, S_cap: int, mesh: Mesh,
                            cfg: ba.BAConfig) -> ba.BAResult:
    """Ray + distance variant of ``gauss_newton_schur`` (``:256``)."""
    return gauss_newton_schur(T_WCs, Xs, Cs, None, owner, int_slot,
                              sep_slot, ii, jj, idx_ii2jj, valid_match, Q,
                              edge_mask, n_kf, I_cap, S_cap, mesh, cfg)


def gauss_newton_calib_schur(T_WCs, Xs, Cs, K_mat, owner, int_slot,
                             sep_slot, ii, jj, idx_ii2jj, valid_match, Q,
                             edge_mask, n_kf, I_cap: int, S_cap: int,
                             img_size, mesh: Mesh,
                             cfg: ba.BAConfig) -> ba.BAResult:
    """Pixel + log-depth variant of ``gauss_newton_schur`` (``:269``); Xs
    must already lie on the calibrated rays."""
    return gauss_newton_schur(T_WCs, Xs, Cs, K_mat, owner, int_slot,
                              sep_slot, ii, jj, idx_ii2jj, valid_match, Q,
                              edge_mask, n_kf, I_cap, S_cap, mesh, cfg,
                              residual="calib", img_size=img_size)
