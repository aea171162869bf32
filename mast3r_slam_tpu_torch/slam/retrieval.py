"""Retrieval database for loop closure (ASMK over encoder features).

Counterpart of ``mast3r_slam_tpu/slam/retrieval.py``:

* feature prep (prewhiten -> projector -> l2-norm attention -> postwhiten ->
  top-``nfeat`` selection) and codebook quantization (L2 top-k against the
  codebook by the expanded-norm matrix product) run on the device. They are
  plain matrix products, which the JAX package leaves to XLA outside any
  kernel: ``torch.matmul`` and ``torch.topk`` in fp32, TF32 off;
* the inverted file (growable posting lists of binarized aggregated
  residuals) lives on the host: the C++ popcount engine of ``native/``
  (built with ``g++`` at first use) or, when the caller asks for it with
  ``use_native=False``, the numpy ``IVF`` below. A failed native build
  raises; it never switches to numpy on its own.

Scoring: binary kernel, no idf, multiple assignment 1 on build and 5 on
query, monomial alpha 3, similarity threshold 0 (``RetrievalConfig``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import exact_fp32, resolve_device
from ..config import RetrievalConfig

__all__ = ["IVF", "RetrievalConfig", "RetrievalDatabase",
           "aggregate_image", "aggregate_residuals", "binarize_pack",
           "convert_retrieval_checkpoint", "hamming_cdist_packed",
           "init_retrieval_params", "prep_features",
           "prep_and_quantize", "quantize"]


# -- device side: feature prep + quantization ----------------------------------


def init_retrieval_params(generator: torch.Generator = None,
                          backbone_dim=1024, proj_dim=1024,
                          codebook_size=1024, device="cuda"):
    """Random retrieval head and codebook from ``generator`` (for runs
    without a released retrieval checkpoint; a converted one has the same
    tree, ``models/convert.retrieval_params_from_jax``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, generator=generator,
                                       device=generator.device).to(dev)
    return {
        "prewhiten": {"m": torch.zeros(backbone_dim, device=dev),
                      "p": torch.eye(backbone_dim, device=dev)},
        "projector": {"w": randn(backbone_dim, proj_dim) / backbone_dim ** 0.5,
                      "b": torch.zeros(proj_dim, device=dev)},
        "postwhiten": {"m": torch.zeros(proj_dim, device=dev),
                       "p": torch.eye(proj_dim, device=dev)},
        "centroids": randn(codebook_size, proj_dim),
    }


def convert_retrieval_checkpoint(path, codebook_pkl=None, device="cuda"):
    """The released training-free retrieval ``.pth`` (``prewhiten.{m,p}``,
    ``projector.{weight,bias}``, optionally ``postwhiten.{m,p}``) and the
    codebook pickle (``{'train_codebook': {'codebook': {'centroids': ...}}}``
    or the bare array) -> the retrieval params on ``device``
    (``retrieval.py:60``): the projector transposed so that every matrix
    applies as ``x @ p``; ``postwhiten`` None when the file has none; no
    ``centroids`` without a codebook. Both files are unpickled: load only
    files you trust."""
    import pickle

    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    t = lambda k: sd[k].detach().to(torch.float32)
    put = lambda a: torch.as_tensor(a, dtype=torch.float32).contiguous().to(
        dev)
    params = {
        "prewhiten": {"m": put(t("prewhiten.m").reshape(-1)),
                      "p": put(t("prewhiten.p"))},
        "projector": {"w": put(t("projector.weight").T),
                      "b": put(t("projector.bias"))},
        "postwhiten": ({"m": put(t("postwhiten.m").reshape(-1)),
                        "p": put(t("postwhiten.p"))}
                       if "postwhiten.m" in sd else None),
    }
    if codebook_pkl is not None:
        with open(codebook_pkl, "rb") as f:
            cb = pickle.load(f)
        if isinstance(cb, dict) and "train_codebook" in cb:
            cb = cb["train_codebook"]["codebook"]["centroids"]
        params["centroids"] = put(np.asarray(cb, dtype=np.float32))
    return params


@torch.no_grad()
def prep_features(rparams, backbone_feat, nfeat: int):
    """Whiten, project and select local features (``retrieval.py:91``).

    backbone_feat (n, backbone_dim): the encoder tokens of one frame.
    Returns (min(nfeat, n), proj_dim) fp32, strongest attention first."""
    exact_fp32()
    pw = rparams["prewhiten"]
    x = (backbone_feat.to(torch.float32) - pw["m"]) @ pw["p"]
    proj = x @ rparams["projector"]["w"] + rparams["projector"]["b"]
    attention = torch.linalg.vector_norm(proj, dim=-1)
    if rparams.get("postwhiten") is not None:
        pow_ = rparams["postwhiten"]
        proj = (proj - pow_["m"]) @ pow_["p"]
    k = min(nfeat, proj.shape[0])
    top_idx = torch.topk(attention, k).indices
    return proj[top_idx]


@torch.no_grad()
def quantize(feats, centroids, k: int):
    """Top-k nearest centroids by L2, nearest first (``retrieval.py:111``:
    the expanded-norm matrix product). Returns (n, k) int64."""
    exact_fp32()
    d2 = ((feats ** 2).sum(dim=1)[:, None]
          + (centroids ** 2).sum(dim=1)[None, :]
          - 2.0 * feats @ centroids.T)
    return torch.topk(-d2, k, dim=1).indices


def prep_and_quantize(rparams, backbone_feat, nfeat: int, k: int):
    """``prep_features`` + ``quantize`` (``retrieval.py:124``)."""
    feats = prep_features(rparams, backbone_feat, nfeat)
    return feats, quantize(feats, rparams["centroids"], k)


# -- host side: binarized inverted file ----------------------------------------

_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint16)


def binarize_pack(des: np.ndarray) -> np.ndarray:
    """Sign-binarize rows and pack to uint8 (bit set iff value > 0)."""
    return np.packbits(des > 0, axis=-1)


def hamming_cdist_packed(a: np.ndarray, b: np.ndarray, nbits: int):
    """Normalized Hamming distance between packed rows."""
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return _POPCNT8[x].sum(axis=-1).astype(np.float32) / nbits


class IVF:
    """Growable per-visual-word posting lists of binarized residuals, idf
    disabled (``retrieval.py:151``)."""

    def __init__(self, n_words: int, dim: int):
        self.n_words = n_words
        self.dim = dim
        self.vecs = [None] * n_words       # packed uint8 arrays (cap, dim/8)
        self.imids = [None] * n_words
        self.counts = np.zeros(n_words, dtype=np.int64)
        self.norm_factor = np.zeros(0)
        self.n_images = 0

    def add(self, agg_des, agg_words, agg_imids):
        max_imid = int(agg_imids.max())
        if max_imid + 1 > len(self.norm_factor):
            self.norm_factor = np.concatenate(
                [self.norm_factor,
                 np.zeros(max_imid + 1 - len(self.norm_factor))])
        self.n_images = max(self.n_images, max_imid + 1)
        for vec, word, imid in zip(agg_des, agg_words, agg_imids):
            w = int(word)
            c = self.counts[w]
            if self.vecs[w] is None:
                cap = 8
                self.vecs[w] = np.zeros((cap,) + vec.shape, dtype=vec.dtype)
                self.imids[w] = np.zeros(cap, dtype=np.int64)
            elif c >= self.vecs[w].shape[0]:
                new_cap = int(np.ceil(self.vecs[w].shape[0] * 1.5))
                self.vecs[w] = np.resize(self.vecs[w],
                                         (new_cap,) + vec.shape)
                self.imids[w] = np.resize(self.imids[w], new_cap)
            self.vecs[w][c] = vec
            self.imids[w][c] = imid
            self.counts[w] += 1
            self.norm_factor[int(imid)] += 1

    def search(self, agg_des, agg_words, alpha, sim_thresh):
        scores = np.zeros(self.n_images, dtype=np.float32)
        q_norm = 0.0
        for qvec, word in zip(agg_des, agg_words):
            w = int(word)
            q_norm += 1.0
            c = self.counts[w]
            if c == 0:
                continue
            nh = hamming_cdist_packed(qvec[None], self.vecs[w][:c],
                                      self.dim)[0]
            sim = 1.0 - 2.0 * nh
            mask = sim >= sim_thresh
            s = np.power(sim[mask], alpha)
            imids = self.imids[w][:c][mask]
            s = s / np.sqrt(self.norm_factor[imids])
            np.add.at(scores, imids, s)
        if q_norm > 0:
            scores /= np.sqrt(q_norm)
        return scores

    def state_dict(self):
        return {
            "n_words": self.n_words, "dim": self.dim,
            "vecs": self.vecs, "imids": self.imids, "counts": self.counts,
            "norm_factor": self.norm_factor, "n_images": self.n_images,
        }

    def flat_state(self):
        """Flat-array export (plain arrays, no pickled object lists); the
        same entries as ``state_dict``."""
        vs, ws, ims = [], [], []
        for w in range(self.n_words):
            c = int(self.counts[w])
            if c:
                vs.append(self.vecs[w][:c])
                ws.append(np.full(c, w, dtype=np.int64))
                ims.append(self.imids[w][:c])
        cat = (lambda xs, dt: np.concatenate(xs) if xs
               else np.zeros((0,), dt))
        vecs = (np.concatenate(vs) if vs
                else np.zeros((0, self.dim // 8), np.uint8))
        return {"kind": "numpy", "n_words": self.n_words, "dim": self.dim,
                "vecs": vecs, "words": cat(ws, np.int64),
                "imids": cat(ims, np.int64)}

    @classmethod
    def from_flat(cls, state):
        ivf = cls(int(state["n_words"]), int(state["dim"]))
        words = np.asarray(state["words"])
        if len(words):
            # add() grows n_images and norm_factor per entry exactly as the
            # original incremental adds did
            ivf.add(np.asarray(state["vecs"]), words,
                    np.asarray(state["imids"]))
        return ivf

    @classmethod
    def from_state(cls, state):
        ivf = cls(state["n_words"], state["dim"])
        ivf.vecs = state["vecs"]
        ivf.imids = state["imids"]
        ivf.counts = state["counts"]
        ivf.norm_factor = state["norm_factor"]
        ivf.n_images = state["n_images"]
        return ivf


def aggregate_residuals(des: np.ndarray, word_ids: np.ndarray,
                        centroids: np.ndarray):
    """Per-visual-word residual aggregation (``retrieval.py:259``).

    des (n, dim) raw features; word_ids (n, ma) top-k assignments. Returns
    (residual sums (u, dim) fp32, unique word ids (u,)). For word w the sum
    over the features assigned to it of (des[i] - c_w) is a scatter-add of
    des by word minus count_w * c_w. A feature assigned the same word
    through several of its ma columns contributes once, so duplicate
    columns are masked first."""
    n, ma = word_ids.shape
    unique_ids, inv = np.unique(word_ids, return_inverse=True)
    inv = inv.reshape(n, ma)
    keep = np.ones((n, ma), dtype=bool)     # first occurrence within a row
    for j in range(1, ma):
        keep[:, j] = ~(word_ids[:, :j] == word_ids[:, j:j + 1]).any(axis=1)
    pi, pj = np.nonzero(keep)
    slots = inv[pi, pj]
    u = unique_ids.shape[0]
    ades = np.zeros((u, des.shape[1]), dtype=np.float32)
    np.add.at(ades, slots, des[pi].astype(np.float32, copy=False))
    counts = np.bincount(slots, minlength=u).astype(np.float32)
    ades -= counts[:, None] * centroids[unique_ids]
    return ades, unique_ids


def aggregate_image(des: np.ndarray, word_ids: np.ndarray,
                    centroids: np.ndarray):
    """Binarized aggregation for the numpy IVF path."""
    ades, unique_ids = aggregate_residuals(des, word_ids, centroids)
    return binarize_pack(ades), unique_ids


class RetrievalDatabase:
    """Incremental retrieval database (``retrieval.py:298``).

    ``use_native=True`` (the default) uses the C++ inverted file and raises
    if its library cannot be built or loaded; ``use_native=False`` uses the
    numpy ``IVF``."""

    def __init__(self, rparams, cfg: RetrievalConfig = RetrievalConfig(),
                 use_native: bool = True):
        self.rparams = rparams
        self.cfg = cfg
        self.centroids_np = rparams["centroids"].detach().cpu().numpy()
        n_words, dim = self.centroids_np.shape
        self.native = None
        if use_native:
            from .. import native as native_mod

            native_mod.load()           # raises if the build or load fails
            self.native = native_mod
            self.ivf = native_mod.NativeIVF(n_words, dim)
        else:
            self.ivf = IVF(n_words, dim)
        self.kf_counter = 0

    def state_dict(self):
        """Checkpointable IVF state as flat arrays."""
        st = self.ivf.flat_state()
        st["kf_counter"] = self.kf_counter
        return st

    def load_state_dict(self, state) -> bool:
        """Restore the IVF; False when the stored kind cannot be loaded
        into this database (the packings of the two IVFs differ), so the
        caller can replay the keyframes' features instead."""
        kind = str(np.asarray(state["kind"]))
        if kind == "native" and self.native:
            self.ivf = self.native.NativeIVF.from_flat(state)
        elif kind == "numpy" and not self.native:
            self.ivf = IVF.from_flat(state)
        else:
            return False
        self.kf_counter = int(np.asarray(state["kf_counter"]))
        return True

    def prefetch(self, backbone_feat):
        """Enqueue (do not wait for) the device half of ``update``.

        Returns handles for ``update(prefetched=...)``. The point is queue
        position: enqueued before a frame's network, the small prep +
        quantize runs first, so the readback and the host's IVF work need
        not wait behind the frame. On a GPU the results are copied into
        pinned host memory without blocking and an event marks the end of
        the copy. Always quantizes to top-max(ma_query, ma_build); the
        top-k columns are ordered, so both consumers slice the shared
        prefix: the same results as the inline path."""
        ma = max(self.cfg.ma_query, self.cfg.ma_build)
        feats, words = prep_and_quantize(self.rparams, backbone_feat,
                                         self.cfg.nfeat, ma)
        if feats.device.type != "cuda":
            return feats, words, None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (feats, words)]
        for h, t in zip(host, (feats, words)):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host[0], host[1], event

    def update(self, backbone_feat, add_after_query: bool, k: int,
               min_thresh: float = 0.0, prefetched=None):
        """Query the top-k similar keyframes, then optionally insert
        (``retrieval.py:376``).

        backbone_feat (n, backbone_dim): the frame's encoder tokens
        (ignored when ``prefetched`` handles from ``prefetch`` are given).
        Returns a list of keyframe indices."""
        if prefetched is not None:
            feats_d, words_d, event = prefetched
            if event is not None:
                event.synchronize()
        else:
            ma = (max(self.cfg.ma_query, self.cfg.ma_build)
                  if self.kf_counter > 0 else self.cfg.ma_build)
            feats_d, words_d = prep_and_quantize(self.rparams, backbone_feat,
                                                 self.cfg.nfeat, ma)
        feats = feats_d.cpu().numpy()       # the one sync of the update
        q_words = words_d.cpu().numpy()
        topk_inds: list = []
        if self.kf_counter > 0:
            words = q_words[:, : self.cfg.ma_query]
            ades, agg_ids = aggregate_residuals(feats, words,
                                                self.centroids_np)
            if self.native:
                packed = self.native.binarize_pack64(ades)
                scores = self.ivf.search_packed(
                    packed, agg_ids.astype(np.int64), self.cfg.alpha,
                    self.cfg.similarity_threshold)
            else:
                scores = self.ivf.search(binarize_pack(ades), agg_ids,
                                         self.cfg.alpha,
                                         self.cfg.similarity_threshold)
            order = np.argsort(-scores)[: min(k, self.ivf.n_images)]
            topk_inds = [int(i) for i in order if scores[i] > min_thresh]

        if add_after_query:
            words_b = q_words[:, : self.cfg.ma_build]
            ades, agg_ids = aggregate_residuals(feats, words_b,
                                                self.centroids_np)
            if self.native:
                self.ivf.add_packed(self.native.binarize_pack64(ades),
                                    agg_ids.astype(np.int64),
                                    self.kf_counter)
            else:
                self.ivf.add(binarize_pack(ades), agg_ids,
                             np.full(agg_ids.shape[0], self.kf_counter,
                                     dtype=np.int64))
            self.kf_counter += 1
        return topk_inds
