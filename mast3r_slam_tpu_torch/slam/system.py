"""SLAM system: the tracking frontend (per frame and windowed), the backend
step and the mode machine.

Counterpart of ``mast3r_slam_tpu/slam/system.py``: ``_track_gate_pre``
(:78), ``_track_frame_body`` (:101), the fused path of ``TrackerRunner``
(:442), ``SLAMSystem.make_frame`` / ``process_frame`` (:744, :764) with the
INIT, TRACKING and RELOC modes, ``backend_prefetch`` (:961) and
``backend_step`` (:993): every promoted keyframe is queued, gets its
consecutive edge (from the tracker's match, or by a symmetric decode +
match), with a retrieval database (``slam/retrieval.py``) its loop-closure
candidates, and a global Sim(3) bundle adjustment over all keyframes
(``slam/factor_graph.py``, ``slam/ba.py``). A lost frame is relocalized
against the retrieved keyframes (``_relocalize`` :1112), and after
``reloc.reinit_after`` failures in a row tracking restarts from it
(``_reinit_from_current`` :1089).

Per tracked frame the host waits for the device once, for the five frame
stats (the Gauss-Newton solve runs on the device, ``slam/tracker.py``);
per backend step once per BA iteration (the step norm) and once for the
retrieval features and word ids.

The windowed frontend (``runtime.tracking_window`` W > 1;
``_track_window_body`` :245, ``dispatch_window`` / ``consume_window``
:818, :877) encodes W frames as one batch and tracks them in sequence with
the keyframe carried on the device: the keyframe decision, the keyframe
switch and the store-row writes are device work, and the host waits once a
window, for the (W, 8) stats.

``run`` (``:1158``) drives a dataset through the frontend: with
``single_thread`` the backend is drained after every frame (or window),
otherwise it runs in a host thread beside the frontend, the two serialized
by ``state_lock`` (both issue their work on the same CUDA stream). It can
checkpoint the state every N frames (``slam/checkpoint.py``) and start
from a resumed frame.

Not in this slice (each raises ``NotImplementedError``; see ROADMAP.md):
the step-by-step tracking path, a separate backend device, and ``run``'s
live viewer.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config as config_mod
from .. import geometry
from .._device import resolve_device
from ..io.image import resize_img
from ..lie import sim3
from ..models import mast3r
from ..ops import matching
from . import tracker as tracker_mod
from .factor_graph import FactorGraph
from .frame import Frame, KeyframeStore, Mode, _score, fuse_pointmap
from .retrieval import RetrievalDatabase

_TODO = "is not ported yet; see ROADMAP.md queue 1"


def _track_match(model_mod, params, cfg, mcfg, feat_f, pos_f, feat_k, pos_k,
                 idx_init, ds: int = 1):
    """Asymmetric inference + frame->keyframe matching (``system.py:34``).
    Returns flat (n, ...) idx_f2k, valid, Xff, Cff, Qff, Xkf, Ckf, Qkf,
    p_sub."""
    X, C, D, Q = model_mod.inference_asymmetric(params, feat_f, pos_f,
                                                feat_k, pos_k, cfg)
    X, C, D, Q = mast3r.downsample_maps(X, C, D, Q, ds=ds)
    Xff, Xkf = X[0:1], X[1:2]
    out = matching.match(Xff, Xkf, D[0:1], D[1:2], idx_1_to_2_init=idx_init,
                         **mcfg._asdict())
    if mcfg.subpixel:
        idx, valid, p_sub = out
    else:
        idx, valid = out
        p_sub = matching.lin_to_pixel(idx, Xff.shape[2]).to(Xff.dtype)
    hw = X.shape[1] * X.shape[2]
    flat = lambda a: a.reshape(hw, -1)
    return (idx[0], valid[0], flat(Xff), flat(C[0:1]), flat(Q[0:1]),
            flat(Xkf), flat(C[1:2]), flat(Q[1:2]), p_sub[0])


def _track_gate_pre(idx_f2k, valid_match_k, Qff_at, Qkf, Cf_at, Ck_avg,
                    C_conf, Q_conf):
    """Confidence gate and keyframe statistics (``system.py:78``).
    Returns (Qk (n, 1), valid_opt (n, 1), stats (3,))."""
    n = idx_f2k.shape[0]
    Qk = torch.sqrt(Qff_at * Qkf)
    valid_opt = (valid_match_k & (Cf_at > C_conf) & (Ck_avg > C_conf)
                 & (Qk > Q_conf))
    valid_kf = valid_match_k & (Qk > Q_conf)
    hit = torch.zeros(n + 1, dtype=torch.float32, device=idx_f2k.device)
    # index_fill_ takes the scalar as it is (an indexed assignment of a
    # Python float copies it to the GPU, which waits for the stream)
    hit.index_fill_(0, torch.where(valid_match_k[:, 0], idx_f2k,
                                   torch.full_like(idx_f2k, n)), 1.0)
    stats = torch.stack([valid_opt.float().mean(), valid_kf.float().mean(),
                         hit[:n].sum() / n])
    return Qk, valid_opt, stats


def _track_frame_body(model_mod, params, cfg, mcfg, tcfg, feat_f, pos_f,
                      feat_k, pos_k, idx_init, kf_X, kf_C, kf_N,
                      kf_N_updates, kf_score, kf_T_WC, frame_T_WC, K,
                      ds: int, fuse_mode: str, score_fn: str,
                      use_calib: bool, img_size, intrinsics=None):
    """One tracking step: inference, matching, gating, Sim(3) GN, masked
    fusion and pose update (``system.py:101``). The skip/failure decisions
    come back in a 5-vector of stats; nothing is read to the host here.
    ``intrinsics``: K's (fx, fy, cx, cy) as host floats (calibrated)."""
    (idx_f2k, valid_match_k, Xff, Cff, Qff, Xkf, Ckf, Qkf,
     p_sub) = _track_match(model_mod, params, cfg, mcfg, feat_f, pos_f,
                           feat_k, pos_k, idx_init, ds)

    kf_Cavg = (kf_C / torch.clamp(kf_N.to(kf_C.dtype), min=1.0))[:, None]
    Xf, Xk = Xff, kf_X
    if use_calib:
        Xf = geometry.constrain_points_to_ray(img_size, Xf, K)
        Xk = geometry.constrain_points_to_ray(img_size, Xk, K)

    if mcfg.subpixel:
        hh, ww = img_size
        u = torch.clamp(p_sub[None, :, 0], 0.0, ww - 1.001)
        v = torch.clamp(p_sub[None, :, 1], 0.0, hh - 1.001)
        Xf_at = matching._bilinear(Xf.reshape(1, hh * ww, 3), u, v, hh,
                                   ww)[0]
    else:
        Xf_at = Xf[idx_f2k]
    Qff_at, Cf_at = Qff[idx_f2k], Cff[idx_f2k]

    Qk, valid_opt, stats3 = _track_gate_pre(
        idx_f2k, valid_match_k, Qff_at, Qkf, Cf_at, kf_Cavg,
        tcfg.C_conf, tcfg.Q_conf)

    T_init = sim3.rel(kf_T_WC, frame_T_WC)
    if not use_calib:
        res = tracker_mod.opt_pose_ray_dist_sim3(Xf_at, Xk, T_init, Qk,
                                                 valid_opt, tcfg)
    else:
        meas_k, valid_meas_k = tracker_mod.calib_measurements(
            Xk, K, img_size, tcfg.depth_eps)
        res = tracker_mod.opt_pose_calib_sim3(
            Xf_at, Xk, T_init, Qk, valid_opt, meas_k, valid_meas_k, K,
            img_size, tcfg, intrinsics)

    skip = stats3[0] < tcfg.min_match_frac
    ok = (~skip) & (~res.failed)
    T_CkCf = res.T_CkCf
    T_WCf = torch.where(ok, sim3.mul(kf_T_WC, T_CkCf), frame_T_WC)

    Xkk = sim3.act(T_CkCf, Xkf)
    if fuse_mode == "best_score":
        Xn, Cn, Nn, score_n = fuse_pointmap(fuse_mode, kf_X, kf_C[:, None],
                                            kf_N, Xkk, Ckf, kf_score,
                                            score_fn)
    else:
        Xn, Cn, Nn = fuse_pointmap(fuse_mode, kf_X, kf_C[:, None], kf_N,
                                   Xkk, Ckf, n_updates=kf_N_updates)
        score_n = kf_score
    kf_X_new = torch.where(ok, Xn, kf_X)
    kf_C_new = torch.where(ok, Cn[:, 0], kf_C)
    kf_N_new = torch.where(ok, Nn, kf_N)
    kf_NU_new = torch.where(ok, kf_N_updates + 1, kf_N_updates)
    kf_score_new = torch.where(ok, score_n, kf_score)

    frame_score = (_score(Cff, score_fn) if fuse_mode == "best_score"
                   else torch.zeros((), device=Cff.device))
    stats = torch.cat([stats3, torch.stack([skip.float(),
                                            res.failed.float()])])
    return (idx_f2k, T_WCf, Xff, Cff, kf_X_new, kf_C_new, kf_N_new,
            kf_NU_new, kf_score_new, frame_score, stats,
            valid_match_k[:, 0], Qk[:, 0])


class WindowOut(NamedTuple):
    """Outputs of ``_track_window_body`` (``system.py:212``), all on the
    device; the host reads ``hoststats`` once a window. The keyframe store
    is written in place."""

    hoststats: torch.Tensor  # (W, 8): match_frac, match_frac_k, unique_frac,
    #                          skip, failed, new_kf, frame_score, active
    T_WCf: torch.Tensor      # (W, 8) per-frame world poses
    feats: torch.Tensor      # (W, n_patch, d) encoder features
    poss: torch.Tensor       # (W, n_patch, 2)
    Xff: torch.Tensor        # (W, n, 3) per-frame canonical pointmaps
    Cff: torch.Tensor        # (W, n, 1)
    idx_last: torch.Tensor   # (n,) match warm start for the next window
    # each frame's match against its carried keyframe (the consecutive-edge
    # reuse of local_opt.reuse_consec_edge); None without capture_matches
    idxs: Optional[torch.Tensor]     # (W, n)
    valids: Optional[torch.Tensor]   # (W, n) bool
    Qks: Optional[torch.Tensor]      # (W, n)
    prev_T_WC: torch.Tensor  # (8,) the last active frame's pose
    feat_last: torch.Tensor  # (n_patch, d) the last active frame's features
    pos_last: torch.Tensor   # (n_patch, 2)


def _put_row(buf, row, value, mask):
    """``buf[row] = value`` where ``mask`` (a 0-d bool device tensor), in
    place. ``row`` is a one-element device index: no host read."""
    old = buf.index_select(0, row)[0]
    buf.index_copy_(0, row, torch.where(mask, value.to(buf.dtype), old)[None])


def _track_window_body(model_mod, params, cfg, mcfg, tcfg, imgs, frame_ids,
                       idx_init, prev_T_WC, K, last_idx, kfs, ds: int,
                       fuse_mode: str, score_fn: str, use_calib: bool,
                       img_size, intrinsics=None,
                       capture_matches: bool = True) -> WindowOut:
    """W frames through the tracker with the keyframe carried on the device
    (``system.py:245``).

    The W frames are encoded as one batch, then tracked in sequence by
    ``_track_frame_body``. The keyframe decision is made on the device
    (``kf_every`` from the host-known frame id, otherwise
    ``min(match_frac_k, unique_frac) < match_frac_thresh``); on a switch the
    outgoing keyframe's fused state is written at row ``cur`` and the frame
    at ``cur + 1`` of ``kfs`` (masked in-place row writes), and the rest of
    the window tracks against it. The chain halts at the first skipped or
    failed frame: every later frame is inactive and writes nothing. A final
    flush writes the carried keyframe at ``cur``. ``last_idx`` is the host's
    index of the current keyframe; the caller keeps ``cur + 1`` inside the
    store (``len(kfs) + W < capacity``)."""
    W = imgs.shape[0]
    dev = imgs.device
    n = img_size[0] * img_size[1]
    ident = torch.arange(n, device=dev)
    feats_all, poss_all = model_mod.encode(params, imgs, cfg)

    cur = torch.full((1,), last_idx, dtype=torch.int64, device=dev)
    row = lambda buf: buf.index_select(0, cur)[0]
    # the carried keyframe; its features stay in the store's dtype, as the
    # per-frame path reads them from the store
    feat_k, pos_k = row(kfs.feat)[None], row(kfs.pos)[None]
    kf_X, kf_C, kf_N = row(kfs.X), row(kfs.C), row(kfs.N)
    kf_NU, kf_sc, kf_T = row(kfs.N_updates), row(kfs.score), row(kfs.T_WC)
    idx = ident if idx_init is None else idx_init
    halted = torch.zeros((), dtype=torch.bool, device=dev)
    feat_last, pos_last = feats_all[0], poss_all[0]
    one_i = torch.ones((), dtype=kfs.N.dtype, device=dev)

    def flush(mask):
        """The carried keyframe's fused state into its row ``cur``."""
        for buf, v in ((kfs.X, kf_X), (kfs.C, kf_C), (kfs.N, kf_N),
                       (kfs.N_updates, kf_NU), (kfs.score, kf_sc)):
            _put_row(buf, cur, v, mask)

    o_stats, o_T, o_Xff, o_Cff, o_idx, o_valid, o_Qk = ([] for _ in range(7))
    for t in range(W):
        feat_f, pos_f = feats_all[t:t + 1], poss_all[t:t + 1]
        (idx_f2k, T_WCf, Xff, Cff, kf_Xn, kf_Cn, kf_Nn, kf_NUn, kf_scn,
         frame_score, stats, vmk, Qk) = _track_frame_body(
            model_mod, params, cfg, mcfg, tcfg, feat_f, pos_f, feat_k, pos_k,
            idx[None], kf_X, kf_C, kf_N, kf_NU, kf_sc, kf_T, prev_T_WC, K, ds,
            fuse_mode, score_fn, use_calib, img_size, intrinsics)
        ok = (stats[3] < 0.5) & (stats[4] < 0.5)
        active = ~halted
        if tcfg.kf_every:
            want = frame_ids[t] % tcfg.kf_every == 0
            new_kf = active & ok if want else torch.zeros_like(ok)
        else:
            new_kf = active & ok & (torch.minimum(stats[1], stats[2])
                                    < tcfg.match_frac_thresh)

        # the frame's effect on the carried keyframe (the body gates the
        # fusion by ok; the whole frame is gated by active)
        kf_X = torch.where(active, kf_Xn, kf_X)
        kf_C = torch.where(active, kf_Cn, kf_C)
        kf_N = torch.where(active, kf_Nn, kf_N)
        kf_NU = torch.where(active, kf_NUn, kf_NU)
        kf_sc = torch.where(active, kf_scn, kf_sc)
        T_WCf = torch.where(active & ok, T_WCf, prev_T_WC)

        # keyframe switch: flush the outgoing keyframe, store the frame
        flush(new_kf)
        nxt = cur + 1
        fid = torch.full((), frame_ids[t], dtype=kfs.dataset_idx.dtype,
                         device=dev)
        for buf, v in ((kfs.X, Xff), (kfs.C, Cff[:, 0]), (kfs.N, one_i),
                       (kfs.N_updates, one_i), (kfs.score, frame_score),
                       (kfs.T_WC, T_WCf), (kfs.feat, feat_f[0]),
                       (kfs.pos, pos_f[0]), (kfs.dataset_idx, fid)):
            _put_row(buf, nxt, v, new_kf)

        # carry the new keyframe (its features through the store's dtype,
        # as the per-frame path reads them back)
        feat_k = torch.where(new_kf, feat_f.to(kfs.feat.dtype), feat_k)
        pos_k = torch.where(new_kf, pos_f, pos_k)
        kf_X = torch.where(new_kf, Xff, kf_X)
        kf_C = torch.where(new_kf, Cff[:, 0], kf_C)
        kf_N = torch.where(new_kf, one_i, kf_N)
        kf_NU = torch.where(new_kf, one_i, kf_NU)
        kf_sc = torch.where(new_kf, frame_score.to(kf_sc.dtype), kf_sc)
        kf_T = torch.where(new_kf, T_WCf, kf_T)
        cur = cur + new_kf.to(cur.dtype)
        idx = torch.where(active, torch.where(new_kf, ident, idx_f2k), idx)
        prev_T_WC = torch.where(active, T_WCf, prev_T_WC)
        feat_last = torch.where(active, feats_all[t], feat_last)
        pos_last = torch.where(active, poss_all[t], pos_last)
        halted = halted | (active & ~ok)

        o_stats.append(torch.cat([stats, torch.stack([
            new_kf.float(), frame_score.float(), active.float()])]))
        o_T.append(T_WCf)
        o_Xff.append(Xff)
        o_Cff.append(Cff)
        if capture_matches:
            o_idx.append(idx_f2k)
            o_valid.append(vmk)
            o_Qk.append(Qk)

    flush(torch.ones((), dtype=torch.bool, device=dev))
    stack = lambda xs: torch.stack(xs) if capture_matches else None
    return WindowOut(
        hoststats=torch.stack(o_stats), T_WCf=torch.stack(o_T),
        feats=feats_all, poss=poss_all, Xff=torch.stack(o_Xff),
        Cff=torch.stack(o_Cff), idx_last=idx, idxs=stack(o_idx),
        valids=stack(o_valid), Qks=stack(o_Qk), prev_T_WC=prev_T_WC,
        feat_last=feat_last, pos_last=pos_last)


class TrackerRunner:
    """Frame-to-keyframe tracking driver (fused path, ``system.py:402``)."""

    def __init__(self, params, model_cfg, keyframes: KeyframeStore,
                 tcfg, mcfg, filtering_mode: str = "weighted_pointmap",
                 filtering_score: str = "median", use_calib=False, K=None,
                 model_mod=mast3r):
        self.params = params
        self.model_cfg = model_cfg
        self.keyframes = keyframes
        self.tcfg = tcfg
        self.mcfg = mcfg
        self.filtering_mode = filtering_mode
        self.filtering_score = filtering_score
        self.use_calib = use_calib
        self.K = K
        # read once here, so that a tracked frame does not wait for K
        self.intrinsics = (geometry.host_intrinsics(K) if K is not None
                           else None)
        self.downsample = 1
        self.fused = True
        self.model_mod = model_mod
        self.idx_f2k = None
        self.last_stats = {}
        # (idx_f2k, valid, Qk) of the most recently promoted frame against
        # its previous keyframe: the consecutive-edge reuse path of
        # SLAMSystem.process_frame takes it
        self.last_match = None

    def reset_idx(self):
        self.idx_f2k = None

    def track(self, frame: Frame):
        """Returns (new_kf, try_reloc)."""
        if not self.fused:
            raise NotImplementedError(f"the step-by-step tracking path {_TODO}")
        return self._track_fused(frame)

    def _track_fused(self, frame: Frame):
        kfs = self.keyframes
        last = len(kfs) - 1
        idx_init = self.idx_f2k
        dev = kfs.X.device
        K = self.K if self.K is not None else torch.eye(3, device=dev)
        (idx_f2k, T_WCf, Xff, Cff, kf_X, kf_C, kf_N, kf_NU, kf_score,
         frame_score, stats, vmk, Qk) = _track_frame_body(
            self.model_mod, self.params, self.model_cfg, self.mcfg,
            self.tcfg, frame.feat[None], frame.pos[None],
            kfs.feat[last][None], kfs.pos[last][None],
            idx_init[None] if idx_init is not None else None,
            kfs.X[last], kfs.C[last], kfs.N[last], kfs.N_updates[last],
            kfs.score[last], kfs.T_WC[last], frame.T_WC, K,
            self.downsample, self.filtering_mode, self.filtering_score,
            self.use_calib, (kfs.h, kfs.w), self.intrinsics)

        st = stats.cpu().numpy()     # the per-frame stats read
        self.idx_f2k = idx_f2k
        self.last_stats = {"match_frac": float(st[0]),
                           "match_frac_k": float(st[1]),
                           "unique_frac": float(st[2])}
        frame.X_canon, frame.C, frame.N = Xff, Cff, 1
        frame.N_updates = 1
        if self.filtering_mode == "best_score":
            frame.score = frame_score

        if st[3] > 0.5:
            print(f"Skipped frame {frame.frame_id}")
            return False, True
        if st[4] > 0.5:
            print(f"Cholesky failed {frame.frame_id}")
            return False, True

        frame.T_WC = T_WCf
        kfs.X[last] = kf_X            # in-place row writes
        kfs.C[last] = kf_C
        kfs.N[last] = kf_N
        kfs.N_updates[last] = kf_NU
        kfs.score[last] = kf_score

        if self.tcfg.kf_every:
            new_kf = frame.frame_id % self.tcfg.kf_every == 0
        else:
            new_kf = min(st[1], st[2]) < self.tcfg.match_frac_thresh
        if new_kf:
            self.last_match = (idx_f2k, vmk, Qk)
            self.reset_idx()
        return bool(new_kf), False


class SLAMSystem:
    """Frontend and backend with the reference's mode machine
    (INIT -> TRACKING <-> RELOC)."""

    def __init__(self, params, model_cfg, config: dict, img_shape,
                 retrieval_params=None, K=None, keyframe_capacity=None,
                 edge_capacity=None, model_module=mast3r, device="cuda",
                 metrics=None):
        self.device = resolve_device(device)
        rt = config.get("runtime", {})
        if rt.get("backend_device", "none") not in (None, "none", "None", 0,
                                                    False, ""):
            raise NotImplementedError(
                f"runtime.backend_device (a second device for the backend) "
                f"{_TODO}")
        # frames per tracking dispatch (the windowed frontend of run())
        self.window = int(rt.get("tracking_window", 1))
        h, w = img_shape
        self.full_img_shape = (h, w)
        self.downsample = int(config.get("dataset", {}).get("img_downsample",
                                                            1))
        ds = self.downsample
        if K is not None:
            K = torch.as_tensor(K, dtype=torch.float32, device=self.device)
        if ds > 1:
            h, w = h // ds, w // ds
            if K is not None:
                K = K / ds * torch.tensor([[1.0, 1, 1], [1, 1, 1],
                                           [ds, ds, ds]], device=self.device)
        kf_cap = keyframe_capacity or int(rt.get("keyframe_capacity", 512))
        e_cap = edge_capacity or int(rt.get("edge_capacity", 1024))
        self.config = config
        self.model_cfg = model_cfg
        self.model_mod = model_module
        self.params = params
        self.use_calib = bool(config.get("use_calib", False))
        self.K = K
        # False: run() keeps the backend in a host thread beside the frontend
        self.single_thread = bool(config.get("single_thread", True))
        self.keyframes = KeyframeStore(
            kf_cap, h * w, model_cfg.num_patches, model_cfg.enc_embed_dim,
            (h, w), device=self.device)
        self.keyframes.K = K
        self.tracker = TrackerRunner(
            params, model_cfg, self.keyframes,
            config_mod.make_tracker_config(config),
            config_mod.make_matching_config(config),
            filtering_mode=config["tracking"]["filtering_mode"],
            filtering_score=config["tracking"].get("filtering_score",
                                                   "median"),
            use_calib=self.use_calib, K=K, model_mod=model_module)
        self.tracker.downsample = ds
        self.factor_graph = FactorGraph(
            params, model_cfg, self.keyframes,
            config_mod.make_factor_graph_config(config, e_cap),
            config_mod.make_ba_config(config), self.tracker.mcfg, K=K,
            downsample=ds, model_module=model_module)
        self.retrieval = (
            RetrievalDatabase(retrieval_params,
                              config_mod.make_retrieval_config(config))
            if retrieval_params else None)
        self.mode = Mode.INIT
        self.backend_queue: list = []
        # kf store idx -> handles of retrieval.prefetch (backend_prefetch)
        self._retrieval_prefetch: dict = {}
        # kf store idx -> (idx_f2k, valid, Qk), the tracker's match of the
        # promoted frame against its previous keyframe: lets the backend
        # build the consecutive edge without a symmetric decode + match
        # (local_opt.reuse_consec_edge)
        self._reuse_consec = bool(config.get("local_opt", {})
                                  .get("reuse_consec_edge", False))
        self._consec_match: dict = {}
        # serializes the frontend and the backend thread of run()
        self.state_lock = threading.Lock()
        self._backend_error: Optional[Exception] = None
        self.last_frame_idx = 0
        # the next dataset frame after a checkpoint.load_state
        self.resume_frame = 0
        self.reloc_pending = False
        self.current_frame: Optional[Frame] = None
        self.stats = {"skipped": 0, "keyframes": 0, "loop_closures": 0,
                      "relocs": 0, "reloc_failed": 0, "reinits": 0,
                      "frames_tracking": 0, "frames_reloc": 0,
                      "frames_init": 0}
        self._reloc_fail_streak = 0
        # reinit_after: after N failed relocalization attempts in a row,
        # restart tracking from the current frame's mono pointmap as a
        # fresh keyframe; 0 = never (relocalize forever)
        self.reloc_cfg = config_mod.make_reloc_config(config)
        self.reinit_after = self.reloc_cfg.reinit_after
        self.metrics = metrics

    def _to_uimg(self, img_np: np.ndarray) -> np.ndarray:
        if img_np.dtype == np.uint8:
            u = img_np.astype(np.float32) / 255.0
        else:
            u = img_np * 0.5 + 0.5
        ds = self.downsample
        return u[::ds, ::ds] if ds > 1 else u

    def _check_frame_shape(self, frame_id, img_np):
        expect = (*self.full_img_shape, 3)
        if tuple(img_np.shape) != expect:
            raise ValueError(
                f"frame {frame_id} resized to {tuple(img_np.shape)} but the "
                f"pipeline was built for {expect} (from the dataset's first "
                "frame); all frames must share one resolution")

    def make_frame(self, frame_id: int, img_np: np.ndarray) -> Frame:
        """img_np (h, w, 3): normalized float32 or raw uint8."""
        self._check_frame_shape(frame_id, img_np)
        img = torch.from_numpy(np.ascontiguousarray(img_np)).to(self.device)
        T_WC = (self.current_frame.T_WC if self.current_frame is not None
                else sim3.identity(device=self.device))
        frame = Frame(frame_id=frame_id, img=img, uimg=self._to_uimg(img_np),
                      T_WC=T_WC, K=self.K)
        feat, pos = self.model_mod.encode(self.params, img[None],
                                          self.model_cfg)
        frame.feat = feat[0]
        frame.pos = pos[0]
        return frame

    def _mono_init(self, frame: Frame):
        X, C = self.model_mod.inference_mono(
            self.params, frame.feat[None], frame.pos[None], self.model_cfg,
            self.downsample)
        frame.update_pointmap(X[0], C[0],
                              self.config["tracking"]["filtering_mode"])

    def process_frame(self, frame: Frame):
        """One frontend step; returns the (possibly updated) mode."""
        if self.mode == Mode.INIT:
            self.stats["frames_init"] += 1
            self._mono_init(frame)
            self.keyframes.append(frame)
            self.stats["keyframes"] += 1
            self.backend_queue.append(len(self.keyframes) - 1)
            self.mode = Mode.TRACKING
            self.current_frame = frame
            return self.mode

        if self.mode == Mode.TRACKING:
            self.stats["frames_tracking"] += 1
            new_kf, try_reloc = self.tracker.track(frame)
            if try_reloc:
                self.mode = Mode.RELOC
                self.stats["skipped"] += 1
            self.current_frame = frame
            if new_kf:
                self.keyframes.append(frame)
                self.stats["keyframes"] += 1
                self.backend_queue.append(len(self.keyframes) - 1)
                cm, self.tracker.last_match = self.tracker.last_match, None
                if self._reuse_consec and cm is not None:
                    self._consec_match[len(self.keyframes) - 1] = cm
            if self.metrics is not None:
                self.metrics.log(
                    event="track", frame=frame.frame_id, new_kf=bool(new_kf),
                    reloc=bool(try_reloc), n_kf=len(self.keyframes),
                    n_edges=self.factor_graph.n_edges,
                    edges_dropped=self.factor_graph.edges_dropped,
                    **self.tracker.last_stats)
            return self.mode

        if self.mode == Mode.RELOC:
            # the mono pointmap for the relocalization attempt; the attempt
            # itself runs in the backend (backend_step -> _relocalize)
            self.stats["frames_reloc"] += 1
            self._mono_init(frame)
            self.current_frame = frame
            self.reloc_pending = True
            return self.mode

        raise RuntimeError(f"invalid mode {self.mode}")

    def dispatch_window(self, ids, imgs_np):
        """Enqueue ``len(ids)`` frames (uint8 (h, w, 3) each) through the
        windowed tracker in TRACKING mode (``system.py:818``) without
        waiting for the device: the frames go up in one copy from pinned
        memory, the chain and its store-row writes are enqueued, and the
        returned handle is for ``consume_window``. Work enqueued in between
        (the backend's) runs after the window on the stream."""
        assert self.mode == Mode.TRACKING
        kfs, tr = self.keyframes, self.tracker
        W = len(ids)
        assert len(kfs) + W < kfs.capacity, "keyframe buffer nearly full"
        for fid, im in zip(ids, imgs_np):
            self._check_frame_shape(fid, im)
        host = torch.from_numpy(np.ascontiguousarray(np.stack(imgs_np)))
        if self.device.type == "cuda":
            imgs = host.pin_memory().to(self.device, non_blocking=True)
        else:
            imgs = host.to(self.device)
        K = (self.K if self.K is not None
             else torch.eye(3, device=self.device))
        prev_T = (self.current_frame.T_WC if self.current_frame is not None
                  else sim3.identity(device=self.device))
        out = _track_window_body(
            self.model_mod, self.params, self.model_cfg, tr.mcfg, tr.tcfg,
            imgs, list(ids), tr.idx_f2k, prev_T, K,
            len(kfs) - 1, kfs, self.downsample, tr.filtering_mode,
            tr.filtering_score, self.use_calib, (kfs.h, kfs.w),
            tr.intrinsics, capture_matches=self._reuse_consec)
        tr.idx_f2k = out.idx_last
        return out, list(ids), imgs_np, imgs

    def process_window(self, ids, imgs_np) -> int:
        """Track ``len(ids)`` frames as one window (``system.py:870``).
        Returns the number of frames consumed: on a skip or failure the
        prefix is committed, the system enters RELOC at the offending frame
        and the caller goes on with the per-frame path."""
        return self.consume_window(self.dispatch_window(ids, imgs_np))

    def consume_window(self, pending) -> int:
        """Read the window's stats (the one host wait of a window) and do
        the host's bookkeeping (``system.py:877``)."""
        out, ids, imgs_np, imgs = pending
        kfs, tr = self.keyframes, self.tracker
        hs = out.hoststats.cpu().numpy()
        consumed = 0
        for t in range(len(ids)):
            if hs[t, 7] < 0.5:           # after the halt: never tracked
                break
            skipped = hs[t, 3] > 0.5 or hs[t, 4] > 0.5
            tr.last_stats = {"match_frac": float(hs[t, 0]),
                             "match_frac_k": float(hs[t, 1]),
                             "unique_frac": float(hs[t, 2])}
            new_kf = hs[t, 5] > 0.5
            if new_kf:
                kfs.n_size += 1
                self.stats["keyframes"] += 1
                self.backend_queue.append(kfs.n_size - 1)
                kfs.uimg[kfs.n_size - 1] = self._to_uimg(imgs_np[t])
                if self._reuse_consec:
                    self._consec_match[kfs.n_size - 1] = (
                        out.idxs[t], out.valids[t], out.Qks[t])
            if self.metrics is not None:
                self.metrics.log(
                    event="track", frame=ids[t], new_kf=bool(new_kf),
                    reloc=bool(skipped), n_kf=len(kfs),
                    n_edges=self.factor_graph.n_edges,
                    edges_dropped=self.factor_graph.edges_dropped,
                    **tr.last_stats)
            consumed += 1
            self.stats["frames_tracking"] += 1
            if skipped:
                which = "Skipped" if hs[t, 3] > 0.5 else "Cholesky failed"
                print(f"{which} frame {ids[t]}")
                self.stats["skipped"] += 1
                self.mode = Mode.RELOC
                self.current_frame = Frame(
                    frame_id=ids[t], img=imgs[t],
                    uimg=self._to_uimg(imgs_np[t]), T_WC=out.T_WCf[t],
                    X_canon=out.Xff[t], C=out.Cff[t], feat=out.feats[t],
                    pos=out.poss[t], N=1, N_updates=1, K=self.K)
                return consumed
        self.current_frame = Frame(
            frame_id=ids[consumed - 1], img=None, uimg=None,
            T_WC=out.prev_T_WC, feat=out.feat_last, pos=out.pos_last, N=1,
            N_updates=1, K=self.K)
        return consumed

    def check_invariants(self):
        """Runtime checks of the store and the graph (``system.py:938``);
        raises ``AssertionError`` naming the broken invariant."""
        def need(cond, what):
            if not cond:
                raise AssertionError(what)

        kf, fg = self.keyframes, self.factor_graph
        need(0 <= kf.n_size <= kf.capacity, "keyframe count out of range")
        fg.flush()
        need(0 <= fg.n_edges <= fg.capacity, "edge count out of range")
        n = kf.n_size
        if n:
            T = kf.T_WC[:n].cpu().numpy()
            need(np.all(np.isfinite(T)), "non-finite keyframe pose")
            q = np.linalg.norm(T[:, 3:7], axis=-1)
            need(np.all(np.abs(q - 1.0) < 1e-2), "denormalized quaternion")
            need(np.all(T[:, 7] > 0), "non-positive scale")
        e = fg.n_edges
        if e:
            ii = fg.ii[:e].cpu().numpy()
            jj = fg.jj[:e].cpu().numpy()
            need(ii.min() >= 0 and ii.max() < max(n, 1),
                 "edge endpoint ii out of range")
            need(jj.min() >= 0 and jj.max() < max(n, 1),
                 "edge endpoint jj out of range")

    def backend_prefetch(self):
        """Enqueue the device half of the queued backend steps' retrieval
        updates (prep + quantize, one small piece of work per queued
        keyframe) and start their copies to the host, so that they sit in
        the device queue before the next frame's network
        (``system.py:961``). ``backend_step`` takes the handles; the
        results equal the inline path's."""
        if self.retrieval is None:
            return
        for idx in self.backend_queue:
            if idx not in self._retrieval_prefetch:
                self._retrieval_prefetch[idx] = self.retrieval.prefetch(
                    self.keyframes.feat[idx])

    def backend_step(self, flush_deferred=True):
        """Process one backend task (``system.py:993``): a pending
        relocalization, or the queued keyframe's edges (consecutive and
        retrieved) and a global optimization. Returns True if work was
        done.

        ``flush_deferred=False`` skips the flush of deferred edge-gate
        readbacks (a caller draining several queued keyframes flushes once
        before stepping)."""
        if flush_deferred:
            self.factor_graph.flush()
        if self.reloc_pending:
            self.reloc_pending = False
            if self._relocalize(self.current_frame):
                self.mode = Mode.TRACKING
                self.stats["relocs"] += 1
                self._reloc_fail_streak = 0
            else:
                self.stats["reloc_failed"] += 1
                self._reloc_fail_streak += 1
                if self.metrics is not None:
                    self.metrics.log(event="reloc_failed",
                                     frame=self.current_frame.frame_id,
                                     streak=self._reloc_fail_streak)
                if self.reinit_after and (self._reloc_fail_streak
                                          >= self.reinit_after):
                    self._reinit_from_current()
            return True

        if not self.backend_queue:
            return False
        idx = self.backend_queue[0]

        # consecutive edge: reuse the tracker's frame->keyframe match when
        # one was captured, else decode + match the pair
        cm = (self._consec_match.pop(idx, None)
              if self._reuse_consec else None)
        kf_idx = []
        if cm is None and idx > 0:
            kf_idx.append(idx - 1)

        if self.retrieval is not None:
            rcfg = self.config["retrieval"]
            pref = self._retrieval_prefetch.pop(idx, None)
            feat = None if pref is not None else self.keyframes.feat[idx]
            inds = self.retrieval.update(
                feat, add_after_query=True, k=int(rcfg["k"]),
                min_thresh=float(rcfg["min_thresh"]), prefetched=pref)
            lc = set(inds) - {idx - 1}
            if lc:
                self.stats["loop_closures"] += len(lc)
            kf_idx += inds

        drop = {idx} if cm is None else {idx, idx - 1}
        kf_idx = list(set(kf_idx) - drop)
        if cm is not None and idx > 0:
            self.factor_graph.add_tracked_edge(idx - 1, idx, *cm)
        if kf_idx:
            # deferred gate: no host read here; the solve below masks by
            # the device's edge count and the match fractions are read at
            # the next backend step's flush
            self.factor_graph.add_factors(
                kf_idx, [idx] * len(kf_idx),
                float(self.config["local_opt"]["min_match_frac"]),
                defer=True)

        self._solve()
        self.backend_queue.pop(0)
        return True

    def _solve(self):
        if self.use_calib:
            self.factor_graph.solve_GN_calib()
        else:
            self.factor_graph.solve_GN_rays()

    def _reinit_from_current(self):
        """Way out of a relocalization that keeps failing
        (``system.py:1089``): restart tracking from the current frame's
        mono pointmap as a fresh keyframe (a new, disconnected trajectory
        segment; its pose keeps the last tracked value). Off unless
        ``reloc.reinit_after`` > 0."""
        frame = self.current_frame
        print(f"Re-initializing from frame {frame.frame_id} after "
              f"{self._reloc_fail_streak} failed relocalizations")
        self._reloc_fail_streak = 0
        self.stats["reinits"] += 1
        # the RELOC branch of process_frame gave the frame its mono pointmap
        self.keyframes.append(frame)
        self.stats["keyframes"] += 1
        self.backend_queue.append(len(self.keyframes) - 1)
        self.tracker.reset_idx()
        self.mode = Mode.TRACKING
        if self.metrics is not None:
            self.metrics.log(event="reinit", frame=frame.frame_id,
                             n_kf=len(self.keyframes))

    def _relocalize(self, frame: Frame):
        """Match the lost frame against the retrieved keyframes
        (``system.py:1112``); on success it becomes a keyframe seeded with
        the best candidate's pose."""
        if self.retrieval is None:
            return False
        rcfg = self.config["retrieval"]
        kf_idx = self.retrieval.update(
            frame.feat, add_after_query=False, k=int(rcfg["k"]),
            min_thresh=float(rcfg["min_thresh"]))
        if not kf_idx:
            return False
        self.keyframes.append(frame)
        n_kf = len(self.keyframes)
        print(f"RELOCALIZING against kf {n_kf - 1} and {kf_idx}")
        ok = self.factor_graph.add_factors(
            [n_kf - 1] * len(kf_idx), list(kf_idx),
            self.reloc_cfg.min_match_frac, is_reloc=self.reloc_cfg.strict)
        if ok:
            self.retrieval.update(frame.feat, add_after_query=True,
                                  k=int(rcfg["k"]),
                                  min_thresh=float(rcfg["min_thresh"]))
            # seed the pose from the best retrieved keyframe
            self.keyframes.T_WC[n_kf - 1] = self.keyframes.T_WC[kf_idx[0]]
            self.stats["keyframes"] += 1
            self._solve()
            print("Success! Relocalized")
            return True
        self.keyframes.pop_last()
        print("Failed to relocalize")
        return False

    def run(self, dataset, max_frames=None, progress=False, start_frame=0,
            checkpoint_path=None, checkpoint_every=0, viewer=None):
        """Drive ``dataset`` (``io.datasets``) through the system
        (``system.py:1158``); returns ``stats``.

        Each frame is resized (``io.image.resize_img`` to
        ``dataset.img_size``), made (``make_frame`` on its uint8 pixels) and
        processed. With ``single_thread`` the backend is drained after every
        frame, which makes a run deterministic, and with a
        ``tracking_window`` W > 1 the frames go W at a time through the
        windowed tracker while the system is TRACKING and W frames and W
        keyframe rows are left (``system.py:1206``): the queued keyframes'
        retrieval prep is enqueued first, then the window, then the backend
        is drained (its work queues behind the window on the stream), then
        the window's stats are read. Otherwise the backend runs in a daemon
        thread and each ``process_frame`` and ``backend_step`` holds
        ``state_lock`` (frame by frame, as the JAX package does). At the end
        the backend is drained, the mode becomes ``TERMINATED``, the thread
        is joined and the deferred edge gates are flushed.

        ``start_frame`` skips frames already processed (a resumed run starts
        at ``resume_frame``); with ``checkpoint_path`` and
        ``checkpoint_every`` N the state is saved (``checkpoint.save_state``)
        each time the frame count passes a multiple of N; ``progress``
        prints the frames/s every 30 frames."""
        if viewer is not None:
            raise NotImplementedError(
                "run(viewer=): the live viewer is not ported yet; see "
                "ROADMAP.md queue 1 item 6")
        n = len(dataset) if max_frames is None else min(max_frames,
                                                        len(dataset))
        thread = None
        if not self.single_thread:
            self._backend_error = None
            thread = threading.Thread(target=self._backend_loop, daemon=True)
            thread.start()
        try:
            self._run_frames(dataset, int(start_frame), n, progress,
                             thread is not None, checkpoint_path,
                             int(checkpoint_every or 0))
            # drain; in threaded mode wait until the thread has nothing
            # left to do between two steps (it holds the lock for a step)
            while thread is None and self.backend_step():
                pass
            while thread is not None:
                self._check_backend_thread()
                with self.state_lock:
                    if not (self.backend_queue or self.reloc_pending):
                        self.mode = Mode.TERMINATED
                        break
                time.sleep(0.01)
        finally:
            self.mode = Mode.TERMINATED
            if thread is not None:
                thread.join(timeout=60.0)
                if thread.is_alive():
                    raise RuntimeError("the backend thread did not stop")
        self._check_backend_thread()
        # host bookkeeping catches up with the last deferred edge gates
        self.factor_graph.flush()
        return self.stats

    def _run_frames(self, dataset, i, n, progress, threaded,
                    checkpoint_path=None, checkpoint_every=0):
        t0 = time.time()
        W = self.window
        load = lambda t: resize_img(dataset[t][1], dataset.img_size)["img_u8"]
        while i < n:
            i_prev = i
            if (W > 1 and not threaded and self.mode == Mode.TRACKING
                    and i + W <= n
                    and len(self.keyframes) + W < self.keyframes.capacity):
                ids = list(range(i, i + W))
                self.backend_prefetch()
                pending = self.dispatch_window(ids, [load(t) for t in ids])
                # one flush for the whole drain: the earlier windows' gate
                # readbacks, not this window's keyframes (queued at consume)
                self.factor_graph.flush()
                while self.backend_step(flush_deferred=False):
                    pass
                i += self.consume_window(pending)
            else:
                frame = self.make_frame(i, load(i))
                if threaded:
                    self._check_backend_thread()
                    with self.state_lock:
                        self.process_frame(frame)
                else:
                    self.process_frame(frame)
                    while self.backend_step():
                        pass
                i += 1
            self.last_frame_idx = i
            if progress and i // 30 > i_prev // 30:
                print(f"FPS: {i / (time.time() - t0):.2f}")
            if (checkpoint_path and checkpoint_every
                    and i // checkpoint_every > i_prev // checkpoint_every):
                from . import checkpoint

                with self.state_lock:
                    checkpoint.save_state(checkpoint_path, self)

    def _backend_loop(self):
        """The backend thread of ``run``: one ``backend_step`` at a time
        under ``state_lock`` until the mode is ``TERMINATED``. An exception
        is kept for the frontend to raise."""
        try:
            while True:
                with self.state_lock:
                    if self.mode == Mode.TERMINATED:
                        return
                    did = self.backend_step()
                if not did:
                    time.sleep(0.005)
        except Exception as e:     # re-raised by the frontend thread
            self._backend_error = e

    def _check_backend_thread(self):
        if self._backend_error is not None:
            raise RuntimeError("the backend thread failed") from (
                self._backend_error)
