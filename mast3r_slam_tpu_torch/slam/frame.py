"""Frames, pointmap fusion and the capacity-padded keyframe store.

Counterpart of ``mast3r_slam_tpu/slam/frame.py``. The JAX store updates
rows through donated ``.at[i].set`` programs; here a row write is an
in-place slice assignment into the preallocated device tensors, which is
what the donation achieves on the TPU. ``uimg`` (export/viewer only) stays
host numpy.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..lie import sim3


class Mode(enum.Enum):
    INIT = 0
    TRACKING = 1
    RELOC = 2
    TERMINATED = 3


def median(x):
    """Median as numpy/JAX define it (mean of the two middle values for an
    even count; ``torch.median`` would return the lower one)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def _avg_confs(C, N):
    """Average confidences C / N per row, N clamped to 1."""
    return C / torch.clamp(N, min=1).to(C.dtype)[:, None]


def _score(C, score_fn):
    return median(C) if score_fn == "median" else torch.mean(C)


def fuse_pointmap(mode: str, X_old, C_old, N_old, X_new, C_new,
                  score_old=None, score_fn: str = "median", n_updates=None):
    """One fusion step (``frame.py:50-100``); returns (X, C, N[, score])."""
    ones = torch.ones_like(N_old)
    if mode == "best_score":
        new_score = _score(C_new, score_fn)
        take = new_score > score_old
        return (torch.where(take, X_new, X_old), torch.where(take, C_new, C_old),
                ones, torch.where(take, new_score, score_old))
    if mode == "first":
        take = n_updates == 1
        return (torch.where(take, X_new, X_old),
                torch.where(take, C_new, C_old), ones)
    if mode == "recent":
        return X_new, C_new, ones
    if mode == "indep_conf":
        take = C_new > C_old
        return (torch.where(take, X_new, X_old),
                torch.where(take, C_new, C_old), ones)
    if mode == "weighted_pointmap":
        X = (C_old * X_old + C_new * X_new) / (C_old + C_new)
        return X, C_old + C_new, N_old + 1
    if mode == "weighted_spherical":
        def to_sph(P):
            r = torch.sqrt(torch.sum(P * P, dim=-1, keepdim=True))
            x, y, z = P[..., 0:1], P[..., 1:2], P[..., 2:3]
            phi = torch.atan2(y, x)
            theta = torch.arccos(torch.clamp(z / torch.clamp(r, min=1e-12),
                                             -1.0, 1.0))
            return torch.cat([r, phi, theta], dim=-1)

        def to_cart(s):
            r, phi, theta = s[..., 0:1], s[..., 1:2], s[..., 2:3]
            st = torch.sin(theta)
            return torch.cat([r * st * torch.cos(phi), r * st * torch.sin(phi),
                              r * torch.cos(theta)], dim=-1)

        s = (C_old * to_sph(X_old) + C_new * to_sph(X_new)) / (C_old + C_new)
        return to_cart(s), C_old + C_new, N_old + 1
    raise ValueError(f"unknown filtering_mode {mode}")


@dataclasses.dataclass
class Frame:
    """One input frame (device tensors; batch dim stripped)."""

    frame_id: int
    img: torch.Tensor                   # (h, w, 3)
    uimg: np.ndarray                    # (h, w, 3) [0, 1], host
    T_WC: torch.Tensor = None           # (8,)
    X_canon: Optional[torch.Tensor] = None   # (h*w, 3)
    C: Optional[torch.Tensor] = None         # (h*w, 1)
    feat: Optional[torch.Tensor] = None      # (n, enc_dim)
    pos: Optional[torch.Tensor] = None       # (n, 2)
    N: int = 0
    N_updates: int = 0
    K: Optional[torch.Tensor] = None
    score: Optional[torch.Tensor] = None     # best_score filtering state

    def __post_init__(self):
        if self.T_WC is None:
            dev = self.img.device if self.img is not None else "cpu"
            self.T_WC = sim3.identity(device=dev)

    def update_pointmap(self, X, C, mode: str, score_fn: str = "median"):
        if self.N == 0:
            self.X_canon, self.C, self.N = X, C, 1
            self.N_updates = 1
            if mode == "best_score":
                self.score = _score(C, score_fn)
            return
        # a fill, not an upload: the host does not wait for the device
        N_t = torch.full((), self.N, dtype=torch.int32, device=X.device)
        if mode == "best_score":
            Xn, Cn, Nn, self.score = fuse_pointmap(
                mode, self.X_canon, self.C, N_t, X, C, self.score, score_fn)
        else:
            Xn, Cn, Nn = fuse_pointmap(mode, self.X_canon, self.C, N_t, X, C,
                                       n_updates=self.N_updates)
        self.X_canon, self.C, self.N = Xn, Cn, int(Nn)
        self.N_updates += 1

    def get_average_conf(self):
        return self.C / self.N if self.C is not None else None


class KeyframeStore:
    """Fixed-capacity keyframe buffer of device tensors (``frame.py:165``).
    ``n_size`` is host state; row writes are in place."""

    def __init__(self, capacity: int, num_points: int, num_patches: int,
                 feat_dim: int, img_shape, dtype=torch.float32,
                 feat_dtype=torch.bfloat16, device="cuda"):
        h, w = img_shape
        self.capacity = capacity
        self.h, self.w = h, w
        self.n_size = 0
        dev = resolve_device(device)
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        self.dataset_idx = z((capacity,), torch.int32)
        self.T_WC = sim3.identity((capacity,), device=dev)
        self.X = z((capacity, num_points, 3), dtype)
        self.C = z((capacity, num_points), dtype)
        self.N = z((capacity,), torch.int32)
        self.N_updates = z((capacity,), torch.int32)
        self.feat = z((capacity, num_patches, feat_dim), feat_dtype)
        self.pos = z((capacity, num_patches, 2), torch.int64)
        self.score = z((capacity,), dtype)
        self.uimg = np.zeros((capacity, h, w, 3), np.float32)
        # bumped at every write of a uimg row, so that a reader holding a
        # copy of a row (the live viewer's colours) can tell it is stale
        self.uimg_gen = np.zeros(capacity, np.int64)
        self.K = None

    def __len__(self):
        return self.n_size

    def append(self, frame: Frame):
        idx = self.n_size
        assert idx < self.capacity, "keyframe buffer full"
        self.set_frame(idx, frame)
        return idx

    def pop_last(self):
        self.n_size -= 1

    def set_frame(self, idx: int, frame: Frame):
        self.n_size = max(self.n_size, idx + 1)
        # the host integers as fills (an indexed assignment of a Python
        # number uploads it and waits for the device)
        self.dataset_idx[idx].fill_(frame.frame_id)
        self.T_WC[idx] = frame.T_WC
        self.X[idx] = frame.X_canon
        self.C[idx] = frame.C[..., 0]
        self.N[idx].fill_(frame.N)
        self.N_updates[idx].fill_(frame.N_updates)
        self.feat[idx] = frame.feat
        self.pos[idx] = frame.pos
        if frame.score is not None:
            self.score[idx] = frame.score
        # a frame taken from this row (get_frame) carries a view of it
        if frame.uimg is not None and not np.may_share_memory(
                frame.uimg, self.uimg[idx]):
            self.set_uimg(idx, frame.uimg)

    def set_uimg(self, idx: int, uimg):
        self.uimg[idx] = np.asarray(uimg)
        self.uimg_gen[idx] += 1

    def get_frame(self, idx: int) -> Frame:
        return Frame(
            frame_id=int(self.dataset_idx[idx]), img=None,
            uimg=self.uimg[idx], T_WC=self.T_WC[idx].clone(),
            X_canon=self.X[idx].clone(), C=self.C[idx][..., None].clone(),
            feat=self.feat[idx], pos=self.pos[idx], N=int(self.N[idx]),
            N_updates=int(self.N_updates[idx]), K=self.K,
            score=self.score[idx].clone())

    def last_keyframe(self) -> Optional[Frame]:
        if self.n_size == 0:
            return None
        return self.get_frame(self.n_size - 1)

    def update_T_WCs(self, T_WCs):
        """Adopt solved poses for the leading ``T_WCs.shape[0]`` rows (the
        factor graph's write back; ``parallel/backend_device.BackendMirror``
        also pushes them to the frontend's store)."""
        self.T_WC[:T_WCs.shape[0]] = T_WCs

    def average_confs(self, rows: Optional[int] = None):
        """Average confidences C / N of the first ``rows`` slots (default:
        all), (rows, P); inactive rows -> 0."""
        rows = self.capacity if rows is None else rows
        return _avg_confs(self.C[:rows], self.N[:rows])
