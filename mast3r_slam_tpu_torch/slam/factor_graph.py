"""Keyframe factor graph: edge proposal, gating and global-GN dispatch.

Counterpart of ``mast3r_slam_tpu/slam/factor_graph.py``. Edges live in
capacity-padded device buffers that grow by doubling. Candidate edges are
decoded batched through the two-view model (``inference_symmetric``) and
matched in both directions, by the ``iter_proj`` + ``refine_matches``
kernels (``matcher="iter_proj"``) or by the dense matcher whose coarse
stage is the ``coarse_correlate`` kernel (``matcher="dense"``,
``ops/dense_matcher.py``); the consecutive edge can instead be built from
the tracker's existing match (``add_tracked_edge``). The confidence lookup
of the gate is the ``take_along`` kernel, the solvers are ``slam/ba.py``.

The JAX package writes edge rows with functional scatters and drops a row
by routing it out of bounds. Here the buffers are updated in place and own
one extra row past ``capacity``: a dropped row is routed to that sentinel
row, so no write needs the host to know how many rows were kept. The
device keeps its own edge count (``n_edges_dev``) for the same reason:
``add_factors(defer=True)`` followed by a solve needs no host read.

``ba_backend`` ``"edge_sharded"`` and ``"schur"`` shard the solve over
the ``mesh`` of devices (``parallel/dist_ba.py``, ``parallel/schur.py``;
``factor_graph.py:600-700``) when it has more than one; without one they
solve dense, as the JAX package does. A sharded solve flushes the deferred
edge gates first (the partition needs exact counts), and Schur falls back
to ``edge_sharded`` when the separator dominates. The solved poses go
through the store's ``update_T_WCs``, which a ``BackendMirror`` also
pushes to the frontend's store.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import geometry
from ..config import BAConfig, FactorGraphConfig, MatchingConfig
from ..models import graphs, mast3r
from ..ops import dense_matcher, gather, matching
from ..utils import timing
from . import ba
from .frame import KeyframeStore

__all__ = ["FactorGraph", "FactorGraphConfig", "MatchingConfig",
           "constrain_all"]


# the decoded maps the edge chain reads, in its inputs' order
EDGE_MAPS = tuple(c + d for c in "XDQ" for d in ("ii", "jj", "ji", "ij"))


def _edge_maps(out, mcfg, ds: int = 1):
    """The decode's maps that matching and the gate read
    (``EDGE_MAPS``), each subsampled by ``ds``. With a bf16 refine
    (``mcfg.refine_dtype``) the matchers read the descriptors only through
    a cast to bf16, so they are cast here, first: the same bits, and half
    the bytes for the edge chain's graph inputs to hold."""
    maps = mast3r.downsample_maps(*(out[k] for k in EDGE_MAPS), ds=ds)
    if mcfg.refine_dtype != "bfloat16":
        return maps
    return tuple(m.to(torch.bfloat16) if k[0] == "D" else m
                 for k, m in zip(EDGE_MAPS, maps))


def _check_matcher(matcher):
    if matcher not in ("iter_proj", "dense"):
        raise ValueError(f"local_opt.matcher must be 'iter_proj' or "
                         f"'dense', got {matcher!r}")


def _match_maps(maps, mcfg, matcher: str = "iter_proj",
                query_stride: int = 1):
    """Match both directions of a batch of decoded candidate edges
    (``maps`` as ``_edge_maps`` gives them; ``factor_graph.py:61``).
    Returns idx_i2j, idx_j2i (b, P) int32; valid_match_j, valid_match_i
    (b, P, 1); Qii/Qjj/Qji/Qij (b, P)."""
    out = dict(zip(EDGE_MAPS, maps))
    b = out["Xii"].shape[0]
    X11 = torch.cat([out["Xii"], out["Xjj"]], dim=0)
    X21 = torch.cat([out["Xji"], out["Xij"]], dim=0)
    D11 = torch.cat([out["Dii"], out["Djj"]], dim=0)
    D21 = torch.cat([out["Dji"], out["Dij"]], dim=0)
    if matcher == "dense":
        # the preset's dilation budget is the depth of the fine search; only
        # the points BA will read are matched (query_stride columns)
        idx, valid = dense_matcher.match_dense(
            X11, X21, D11, D21, dist_thresh=mcfg.dist_thresh,
            fine_radius=mcfg.radius,
            fine_dilation=max(int(mcfg.dilation_max), 1),
            lambda_init=mcfg.lambda_init,
            convergence_thresh=mcfg.convergence_thresh,
            query_stride=query_stride)
    else:
        kw = mcfg._asdict()
        kw["subpixel"] = False   # BA gathers by index
        # edge matches start cold (no warm-start index): keep the full LM
        # budget even when the tracking preset trims max_iter
        kw["max_iter"] = max(int(kw["max_iter"]), 10)
        idx, valid = matching.match(X11, X21, D11, D21, **kw)
    idx = idx.to(torch.int32)
    hw = X11.shape[1] * X11.shape[2]
    flat = lambda a: a.reshape(b, hw).contiguous()
    return {
        "idx_i2j": idx[:b].contiguous(), "idx_j2i": idx[b:].contiguous(),
        "valid_match_j": valid[:b], "valid_match_i": valid[b:],
        "Qii": flat(out["Qii"]), "Qjj": flat(out["Qjj"]),
        "Qji": flat(out["Qji"]), "Qij": flat(out["Qij"]),
    }


@torch.no_grad()
def _match_edges_symmetric(params, cfg, mcfg, feat_i, pos_i, feat_j, pos_j,
                           ds: int = 1, matcher: str = "iter_proj",
                           model_mod=mast3r, query_stride: int = 1):
    """Decode + match both directions of a batch of candidate edges
    (``factor_graph.py:61``): ``_match_maps`` of the symmetric decode."""
    _check_matcher(matcher)
    out = model_mod.inference_symmetric(params, feat_i, pos_i, feat_j,
                                        pos_j, cfg)
    return _match_maps(_edge_maps(out, mcfg, ds), mcfg, matcher,
                       query_stride)


def _gate_edges(m, Q_conf, query_stride: int = 1):
    """Paired descriptor confidences and bidirectional match fractions
    (``factor_graph.py:117``). With query-strided edge matching only every
    qs-th point can be valid; the fractions are normalized to the matched
    subset so ``min_match_frac`` keeps its meaning."""
    Qii_at, Qjj_at = gather.take_along_pair(m["Qii"], m["idx_i2j"], m["Qjj"],
                                            m["idx_j2i"], 1)
    Qj = torch.sqrt(Qii_at * m["Qji"])
    Qi = torch.sqrt(Qjj_at * m["Qij"])
    valid_j = m["valid_match_j"][..., 0] & (Qj > Q_conf)
    valid_i = m["valid_match_i"][..., 0] & (Qi > Q_conf)
    return (Qj, Qi, valid_j.float().mean(dim=1) * query_stride,
            valid_i.float().mean(dim=1) * query_stride)


def _pairs(a, bwd):
    """Interleave forward and backward rows: (b, ...) x 2 -> (2b, ...)."""
    return torch.stack([a, bwd], dim=1).reshape(2 * a.shape[0], *a.shape[1:])


def _edge_chain(bufs, maps, ii_arr, jj_arr, consec, e0, min_match_frac,
                strict, Q_conf, mcfg, matcher, query_stride: int = 1):
    """Everything of add_factors after the decode: match -> confidence
    gate -> masked two-way append, the keep decision taken on the device
    (``factor_graph.py:137``). No host read and no upload, so that it
    captures as one CUDA graph.

    ``bufs`` = (ii, jj, idx, valid_match, Q) edge buffers with E_cap + 1
    rows, written in place: dropped rows (gated out, or past a hard
    capacity) go to the sentinel row E_cap. ``maps`` as ``_edge_maps``
    gives them; ``e0`` is the 0-d device edge count. Returns (fracs (2, b),
    n_new 0-d int32)."""
    ii_buf, jj_buf, idx_buf, vm_buf, Q_buf = bufs
    m = _match_maps(maps, mcfg, matcher, query_stride)
    Qj, Qi, frac_j, frac_i = _gate_edges(m, Q_conf, query_stride)

    invalid = (torch.minimum(frac_j, frac_i) < min_match_frac) & ~consec
    keep = ~invalid
    if strict:
        keep = keep & ~invalid.any()

    E_cap = ii_buf.shape[0] - 1
    kprefix = torch.cumsum(keep, 0) - keep.to(torch.int64)   # rank among kept
    rows_fwd = e0.to(torch.int64) + 2 * kprefix
    # a pair that does not fit whole is dropped whole
    rows_fwd = torch.where(keep & (rows_fwd + 1 < E_cap), rows_fwd,
                           torch.full_like(rows_fwd, E_cap))
    rows = torch.clamp(_pairs(rows_fwd, rows_fwd + 1), max=E_cap)

    i32, j32 = ii_arr.to(torch.int32), jj_arr.to(torch.int32)
    ii_buf[rows] = _pairs(i32, j32)
    jj_buf[rows] = _pairs(j32, i32)
    idx_buf[rows] = _pairs(m["idx_i2j"], m["idx_j2i"])
    vm_buf[rows] = _pairs(m["valid_match_j"][..., 0],
                          m["valid_match_i"][..., 0])
    Q_buf[rows] = _pairs(Qj, Qi)
    # post-append edge count on the device (mirrors the host's fits-clamp)
    fits = torch.clamp((E_cap - e0) // 2, min=0)
    n_new = e0 + 2 * torch.minimum(keep.sum().to(torch.int32), fits)
    return torch.stack([frac_j, frac_i]), n_new


@torch.no_grad()
def _add_factors_body(bufs, params, feat, pos, ii_arr, jj_arr, consec, e0,
                      min_match_frac, strict, Q_conf, cfg, mcfg, ds, matcher,
                      model_mod, query_stride: int = 1, owner=None,
                      span=None):
    """The add_factors pipeline without a host read: pair-feature gather ->
    symmetric decode -> ``_edge_chain`` (match, gate, append; arguments
    and result as there).

    With an ``owner`` (the ``FactorGraph``), the chain runs through
    ``graphs.run`` under it: on CUDA under no_grad one CUDA graph a
    proposal shape, keyed also by the edge buffers' storage (a capacity
    doubling makes new buffers and so new graphs) and by what the chain
    bakes in; ``span`` gets the attribute ``graph``. The decode is a
    replay of its own (``mast3r.decode_pair``), never nested in this
    one."""
    _check_matcher(matcher)
    out = model_mod.inference_symmetric(
        params, feat.index_select(0, ii_arr), pos.index_select(0, ii_arr),
        feat.index_select(0, jj_arr), pos.index_select(0, jj_arr), cfg)
    args = (*_edge_maps(out, mcfg, ds), ii_arr, jj_arr, consec, e0)
    n = len(EDGE_MAPS)

    def chain(*a):
        return _edge_chain(bufs, a[:n], *a[n:], min_match_frac, strict,
                           Q_conf, mcfg, matcher, query_stride)

    if owner is None:
        return chain(*args)
    key = ("edges", matcher, query_stride, ds, float(min_match_frac),
           bool(strict), float(Q_conf), mcfg,
           tuple((b.data_ptr(), tuple(b.shape)) for b in bufs))
    return graphs.run(owner, key, chain, args, span, "fg.capture",
                      share_inputs=True)


@torch.no_grad()
def _add_tracked_edge_body(bufs, i, j, idx_j_per_i, valid_i, Q_i, e0):
    """Append the two-way consecutive edge (i, j) from an existing
    frame -> keyframe tracker match: no decode, no matching
    (``factor_graph.py:212``).

    ``idx_j_per_i`` (P,): for each pixel of keyframe i's grid the matched
    pixel in keyframe j's grid. Edge row (ii=j, jj=i) takes it as it is;
    row (ii=i, jj=j) gets the scatter-inverse, where the smallest i-pixel
    wins a collision. The pair is atomic: if both rows do not fit, neither
    is written (both go to the sentinel row) and the count stays put.
    Returns n_new (0-d int32)."""
    ii_buf, jj_buf, idx_buf, vm_buf, Q_buf = bufs
    P = idx_j_per_i.shape[0]
    E_cap = ii_buf.shape[0] - 1
    dev = idx_j_per_i.device
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    idx32 = idx_j_per_i.to(torch.int32)
    src = torch.where(valid_i, idx_j_per_i.to(torch.int64),
                      torch.full((), P, dtype=torch.int64, device=dev))
    inv = torch.full((P + 1,), P, dtype=torch.int32, device=dev)
    inv = inv.scatter_reduce_(0, src, ar, "amin", include_self=True)[:P]
    valid_inv = inv < P
    inv_safe = torch.where(valid_inv, inv, torch.zeros_like(inv))
    Q_inv = torch.where(valid_inv, Q_i[inv_safe.to(torch.int64)],
                        torch.zeros_like(Q_i))

    fits = (e0 + 2) <= E_cap
    e64 = e0.to(torch.int64)
    rows = torch.where(fits, torch.stack([e64, e64 + 1]),
                       torch.full((2,), E_cap, dtype=torch.int64, device=dev))
    ij = timing.host_write("pair_upload",
                           np.array([[j, i], [i, j]], np.int32), device=dev)
    ii_buf[rows] = ij[0]
    jj_buf[rows] = ij[1]
    idx_buf[rows] = torch.stack([idx32, inv_safe])
    vm_buf[rows] = torch.stack([valid_i, valid_inv])
    Q_buf[rows] = torch.stack([Q_i, Q_inv])
    return torch.where(fits, e0 + 2, e0)


class FactorGraph:
    """Host-side edge bookkeeping over device buffers
    (``factor_graph.py:284``).

    Edge arrays ``ii``, ``jj``, ``idx_ii2jj``, ``valid_match``, ``Q`` are
    (capacity, ...) views with ``n_edges`` active rows."""

    def __init__(self, params, model_cfg, keyframes: KeyframeStore,
                 cfg: FactorGraphConfig, ba_cfg: BAConfig,
                 mcfg: MatchingConfig, K=None, downsample: int = 1,
                 model_module=mast3r, mesh=None):
        self.device = keyframes.X.device
        self.mesh = mesh
        self.downsample = downsample
        self.model_mod = model_module
        self.params = params
        self.model_cfg = model_cfg
        self.frames = keyframes
        self.cfg = cfg
        self.ba_cfg = ba_cfg
        self.mcfg = mcfg
        self.K = K

        E, P = cfg.edge_capacity, keyframes.X.shape[1]
        # match only the points BA reads: at point_stride == s the solvers
        # use idx/valid/Q[:, ::s] only, and a stride over the row-major flat
        # point axis is a column stride, so the dense edge matcher can skip
        # the other columns. Only when the strided query grid stays an even
        # image (the matcher's pyramid needs that).
        qs = int(ba_cfg.point_stride)
        w = keyframes.w
        self.query_stride = (
            qs if (cfg.matcher == "dense" and qs > 1 and w % qs == 0
                   and (w // qs) % 2 == 0 and keyframes.h % 2 == 0)
            else 1)
        self.capacity = E           # grows by doubling; see ensure_capacity
        self.edges_dropped = 0      # non-zero only with a max_edge_capacity
        self.n_edges = 0
        # the device keeps its own post-append edge count so add_factors
        # and the following solve need no read of the match fractions; the
        # host applies the same gate arithmetic later (flush)
        self.n_edges_dev = torch.zeros((), dtype=torch.int32,
                                       device=self.device)
        self.n_edges_ub = 0          # host upper bound on the device count
        self._pending: list = []     # deferred gate readbacks, FIFO
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)
        # one extra row: the sentinel that swallows dropped writes
        self._bufs = (z((E + 1,), torch.int32), z((E + 1,), torch.int32),
                      z((E + 1, P), torch.int32), z((E + 1, P), torch.bool),
                      z((E + 1, P), torch.float32))

    ii = property(lambda self: self._bufs[0][:self.capacity])
    jj = property(lambda self: self._bufs[1][:self.capacity])
    idx_ii2jj = property(lambda self: self._bufs[2][:self.capacity])
    valid_match = property(lambda self: self._bufs[3][:self.capacity])
    Q = property(lambda self: self._bufs[4][:self.capacity])

    def ensure_capacity(self, n_edges: int) -> bool:
        """Grow the edge buffers (doubling) until they hold ``n_edges``;
        False if a configured ``max_edge_capacity`` prevents it."""
        mx = self.cfg.max_edge_capacity
        while self.capacity < n_edges:
            new_cap = self.capacity * 2
            if mx and new_cap > mx:
                return False

            def grow(a):
                out = a.new_zeros((new_cap + 1,) + a.shape[1:])
                out[:self.capacity] = a[:self.capacity]
                return out

            self._bufs = tuple(grow(a) for a in self._bufs)
            self.capacity = new_cap
            graphs.drop(self)      # the edge chain's graphs wrote the old
        return True

    # -- edge construction ---------------------------------------------------

    def add_factors(self, ii, jj, min_match_frac, is_reloc=False,
                    defer=False):
        """Propose edges (i, j); returns True if any edge was accepted
        (``factor_graph.py:398``).

        Capacity is grown for the worst case (all candidates kept) before
        the device work, since the keep count exists only on the device; at
        a hard ``max_edge_capacity`` the device drops the rows that do not
        fit and the host mirrors that arithmetic for ``edges_dropped``.

        ``defer=True``: skip the readback of the match fractions; the
        device's ``n_edges_dev`` feeds the next solve's edge mask, and the
        readback is queued for a later ``flush()``. Returns True meaning
        "dispatched". Strict (relocalization) proposals always run
        synchronously."""
        if not ii:
            return False
        with timing.span("fg.add_factors", n=len(ii)) as sp:
            if is_reloc:
                defer = False
            if not defer:
                self.flush()
            nb = len(ii)
            ii_np = np.asarray(ii, dtype=np.int64)
            jj_np = np.asarray(jj, dtype=np.int64)
            consec = ii_np == jj_np - 1

            # worst case over everything in flight; False = capped, the
            # device clamps by dropping
            self.ensure_capacity(self.n_edges_ub + 2 * nb)
            fracs, self.n_edges_dev = _add_factors_body(
                self._bufs, self.params, self.frames.feat, self.frames.pos,
                *timing.host_write("edge_upload", ii_np, jj_np, consec,
                                   device=self.device), self.n_edges_dev,
                float(min_match_frac), bool(is_reloc),
                float(self.cfg.Q_conf), self.model_cfg, self.mcfg,
                self.downsample, self.cfg.matcher, self.model_mod,
                self.query_stride, owner=self, span=sp)

            rec = (fracs, nb, consec, float(min_match_frac), self.capacity,
                   bool(is_reloc))
            if defer:
                self._pending.append(rec)
                self.n_edges_ub = min(self.n_edges_ub + 2 * nb,
                                      self.capacity)
                return True
            ok = self._apply_gate(rec)
            self.n_edges_ub = self.n_edges
            return ok

    def add_tracked_edge(self, i, j, idx_j_per_i, valid, Q):
        """Append the consecutive edge (i, j) from the tracker's existing
        match. Consecutive edges are gate-exempt, so the host count
        advances without a readback; the record still rides the FIFO so
        deferred gates of earlier ``add_factors`` calls reconcile in
        order."""
        with timing.span("fg.add_tracked_edge"):
            self.ensure_capacity(self.n_edges_ub + 2)
            # the tracker's match arrives from the frontend's device
            self.n_edges_dev = _add_tracked_edge_body(
                self._bufs, int(i), int(j), idx_j_per_i.to(self.device),
                valid.to(self.device, torch.bool),
                Q.to(self.device, torch.float32), self.n_edges_dev)
            rec = ("fixed", self.capacity)
            if self._pending:
                self._pending.append(rec)
            else:
                self._apply_gate(rec)
            self.n_edges_ub = min(self.n_edges_ub + 2, self.capacity)
            return True

    def _apply_gate(self, rec):
        """Host mirror of the device gate (the same fp32 arithmetic):
        reconciles n_edges / edges_dropped with the rows the device wrote.
        Applied in dispatch order."""
        if rec[0] == "fixed":       # unconditional pair (add_tracked_edge)
            cap_at_dispatch = rec[1]
            if cap_at_dispatch - self.n_edges < 2:
                self.edges_dropped += 2
                print("FactorGraph: max_edge_capacity reached; dropping "
                      f"a tracked consecutive edge (total dropped "
                      f"{self.edges_dropped})")
                return False
            self.n_edges += 2
            return True
        fracs, nb, consec, min_match_frac, cap_at_dispatch, is_reloc = rec
        fr = timing.host_read("edge_gate", fracs)   # the pipeline's one read
        frac_j, frac_i = fr[0, :nb], fr[1, :nb]
        invalid = np.minimum(frac_j, frac_i) < np.float32(min_match_frac)
        invalid = (~consec) & invalid
        if invalid.any() and is_reloc:
            return False
        keep = int((~invalid).sum())
        if keep == 0:
            return False
        fits = max((cap_at_dispatch - self.n_edges) // 2, 0)
        if keep > fits:
            # mirrors the device's dropped rows exactly
            self.edges_dropped += 2 * (keep - fits)
            print("FactorGraph: max_edge_capacity "
                  f"{self.cfg.max_edge_capacity} reached; dropping "
                  f"{2 * (keep - fits)} edges "
                  f"(total dropped {self.edges_dropped})")
            keep = fits
            if keep == 0:
                return False
        self.n_edges += 2 * keep
        return True

    def flush(self):
        """Apply all deferred edge-gate readbacks (the host's bookkeeping
        catches up with the device's edge count)."""
        if self._pending:
            with timing.span("fg.flush", n=len(self._pending)):
                while self._pending:
                    self._apply_gate(self._pending.pop(0))
        self.n_edges_ub = self.n_edges

    def _append_edge(self, i, j, idx, valid, Q):
        """Write one edge row directly (tests and tools)."""
        e = self.n_edges
        if e >= self.capacity:
            raise RuntimeError("edge buffer full")
        ii_buf, jj_buf, idx_buf, vm_buf, Q_buf = self._bufs
        ii_buf[e] = int(i)
        jj_buf[e] = int(j)
        idx_buf[e] = idx.to(torch.int32)
        vm_buf[e] = valid
        Q_buf[e] = Q
        self.n_edges = e + 1
        self.n_edges_dev = torch.full((), self.n_edges, dtype=torch.int32,
                                      device=self.device)
        self.n_edges_ub = self.n_edges

    @property
    def edge_mask(self):
        self.flush()
        return (torch.arange(self.capacity, device=self.device)
                < self.n_edges).to(torch.float32)

    def unique_kf_idx(self):
        self.flush()
        e = self.n_edges
        if not e:
            return np.array([], dtype=np.int64)
        return np.unique(np.concatenate(timing.host_read(
            "kf_idx", self.ii[:e], self.jj[:e])))

    # -- solvers -------------------------------------------------------------

    def _buckets(self):
        """Active edge and keyframe counts a solve runs on: the solvers get
        the leading ``Eb`` edge rows and ``Kb`` keyframes, not the whole
        capacity, which bounds their work. (The JAX package rounds both up
        to powers of two so that few shapes are compiled; nothing is
        compiled per shape here.)"""
        Eb = min(max(self.n_edges, self.n_edges_ub), self.capacity)
        return Eb, len(self.frames)

    def _solve_args(self):
        Eb, Kb = self._buckets()
        # with deferred add_factors in flight the device's edge count is
        # the authoritative one; otherwise the host's is (covers tests and
        # tools that assign n_edges directly)
        if self._pending:
            mask = (torch.arange(Eb, device=self.device)
                    < self.n_edges_dev).to(torch.float32)
        else:
            mask = self.edge_mask[:Eb]
        return Kb, (self.ii[:Eb], self.jj[:Eb], self.idx_ii2jj[:Eb],
                    self.valid_match[:Eb], self.Q[:Eb], mask,
                    len(self.frames))

    def _nothing_to_solve(self):
        return ((self.n_edges == 0 and self.n_edges_ub == 0)
                or len(self.frames) <= self.ba_cfg.pin)

    def solve_GN_rays(self):
        self._solve_GN("rays")

    def solve_GN_calib(self):
        self._solve_GN("calib")

    def _solve_GN(self, residual):
        """Global GN over every keyframe with the configured backend
        (``factor_graph.py:600``, ``:654``)."""
        if self._nothing_to_solve():
            return
        with timing.span("ba.solve") as sp:
            backend = (self.cfg.ba_backend
                       if self.mesh is not None and self.mesh.size > 1
                       else "dense")
            if backend != "dense":
                self.flush()     # the partition needs exact counts
                if self.n_edges == 0:
                    return
            Kb, args = self._solve_args()
            T0, Xs, Cs = (self.frames.T_WC[:Kb], self.frames.X[:Kb],
                          self.frames.average_confs(Kb))
            img_size = (self.frames.h, self.frames.w)
            if residual == "calib":
                Xs = constrain_all(Xs, self.K, img_size)
            if backend == "schur":
                from ..parallel import schur

                Eb = args[0].shape[0]
                ij = timing.host_read("schur_edges", torch.stack(
                    [args[0], args[1]]))
                part, order, keep = schur.schur_partition(
                    ij[0], ij[1], np.arange(Eb) < self.n_edges, K_cap=Kb,
                    n_shards=self.mesh.size)
                if schur.separator_dominated(part, len(self.frames)):
                    backend = "edge_sharded"
            if backend == "schur":
                res = schur.gauss_newton_schur(
                    T0, Xs, Cs, self.K, part.owner, part.int_slot,
                    part.sep_slot,
                    *schur.reorder_edges(order, keep, *args[:6]), args[6],
                    part.I_cap, part.S_cap, self.mesh, self.ba_cfg,
                    residual=residual, img_size=img_size)
            elif backend == "edge_sharded":
                from ..parallel import dist_ba, mesh as mesh_mod

                nd = self.mesh.size
                pad = lambda a, fill=0: mesh_mod.pad_to_multiple(a, nd, 0,
                                                                 fill)
                ii, jj, idx, vm, Q, mask, n_kf = args
                res = dist_ba.gauss_newton_dist(
                    T0, Xs, Cs, self.K, pad(ii), pad(jj), pad(idx),
                    pad(vm, False), pad(Q), pad(mask), n_kf, self.mesh,
                    self.ba_cfg, residual=residual, img_size=img_size)
            elif residual == "calib":
                res = ba.gauss_newton_calib(T0, Xs, Cs, self.K, *args,
                                            img_size, self.ba_cfg)
            else:
                res = ba.gauss_newton_rays(T0, Xs, Cs, *args, self.ba_cfg)
            sp.set("backend", backend)
            sp.set("iters", res.iters)
            sp.set("graph", res.graph)
            n_edges, n_kf = self._buckets()
            sp.set("n_kf", n_kf)
            sp.set("n_edges", n_edges)
            self.frames.update_T_WCs(res.T_WC)


def constrain_all(Xs, K, img_size):
    """Every keyframe's points onto its calibrated pixel rays: (K, P, 3)."""
    return geometry.constrain_points_to_ray(img_size, Xs, K)
