"""Save and resume a SLAM run's state mid-sequence.

Counterpart of ``mast3r_slam_tpu/slam/checkpoint.py`` (``save_state`` :19,
``load_state`` :79), in its file format: one ``np.savez_compressed`` file
with the same keys, shapes and dtypes, so a checkpoint written by either
package resumes in the other. What it holds: the active keyframe rows
(``n_size``), the active edges, the mode, the backend queue, the last
frame's id and pose, the tracker's match warm start and the retrieval
inverted file (a flat snapshot; rebuilt from the stored keyframe features
when the snapshot's engine is not the one this database runs). The model
weights are not part of it. Neither are the backend's transient handles:
retrieval prefetches and the tracker matches of queued consecutive edges
(after a resume the backend builds those edges by decode + match).

Keyframe features are stored as float32 (the store keeps bfloat16, the
cast back is exact) and patch positions as int32, as the JAX package keeps
them.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from .frame import Frame, Mode


def _host(t, dtype=None):
    a = t.detach().cpu()
    if a.dtype == torch.bfloat16:
        a = a.float()
    a = a.numpy()
    return a if dtype is None else a.astype(dtype)


def save_state(path, system):
    """Write ``system``'s runtime state to ``path`` (npz); returns the
    path. Reads the active rows to the host: a caller in a frame loop pays
    that once a checkpoint."""
    kf, fg = system.keyframes, system.factor_graph
    fg.flush()          # the deferred edge gates land before the snapshot
    n, e = kf.n_size, fg.n_edges
    arrays = {
        "kf_n_size": np.asarray(n),
        "kf_dataset_idx": _host(kf.dataset_idx[:n], np.int32),
        "kf_T_WC": _host(kf.T_WC[:n], np.float32),
        "kf_X": _host(kf.X[:n], np.float32),
        "kf_C": _host(kf.C[:n], np.float32),
        "kf_N": _host(kf.N[:n], np.int32),
        "kf_N_updates": _host(kf.N_updates[:n], np.int32),
        "kf_score": _host(kf.score[:n], np.float32),
        "kf_feat": _host(kf.feat[:n], np.float32),
        "kf_pos": _host(kf.pos[:n], np.int32),
        "kf_uimg": np.asarray(kf.uimg[:n]),
        "fg_n_edges": np.asarray(e),
        "fg_ii": _host(fg.ii[:e], np.int32),
        "fg_jj": _host(fg.jj[:e], np.int32),
        "fg_idx": _host(fg.idx_ii2jj[:e], np.int32),
        "fg_valid": _host(fg.valid_match[:e], bool),
        "fg_Q": _host(fg.Q[:e], np.float32),
        "mode": np.asarray(system.mode.value),
        "backend_queue": np.asarray(system.backend_queue, dtype=np.int64),
        "last_frame_id": np.asarray(
            system.current_frame.frame_id
            if system.current_frame is not None
            else (int(kf.dataset_idx[:n].max()) if n else -1)),
    }
    if system.retrieval is not None:
        arrays["retrieval_kf_counter"] = np.asarray(
            system.retrieval.kf_counter)
        for k, v in system.retrieval.state_dict().items():
            arrays[f"ivf_{k}"] = np.asarray(v)
    if system.tracker.idx_f2k is not None:
        arrays["tracker_idx_f2k"] = _host(system.tracker.idx_f2k, np.int32)
    if system.current_frame is not None:
        arrays["current_T_WC"] = _host(system.current_frame.T_WC,
                                       np.float32)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def load_state(path, system):
    """Restore the state saved at ``path`` into ``system`` (a fresh
    ``SLAMSystem`` of the same configuration) in place; sets
    ``system.resume_frame``, the next dataset frame to process. Returns the
    system."""
    data = np.load(path, allow_pickle=False)
    kf, fg = system.keyframes, system.factor_graph

    def into(buf, name):
        """The saved active rows into the leading rows of ``buf``."""
        arr = torch.from_numpy(np.ascontiguousarray(data[name]))
        m = arr.shape[0]
        if m > buf.shape[0]:
            raise ValueError(f"checkpoint {name} has {m} rows; the capacity "
                             f"is {buf.shape[0]}")
        buf[:m] = arr.to(device=buf.device, dtype=buf.dtype)

    kf.n_size = int(data["kf_n_size"])
    for name in ("dataset_idx", "T_WC", "X", "C", "N", "N_updates", "score",
                 "feat", "pos"):
        if f"kf_{name}" in data:
            into(getattr(kf, name), f"kf_{name}")
    kf.uimg[:kf.n_size] = data["kf_uimg"][:kf.n_size]

    e = int(data["fg_n_edges"])
    if not fg.ensure_capacity(e):
        raise ValueError(f"checkpoint has {e} edges, more than "
                         "max_edge_capacity")
    for buf, name in ((fg.ii, "fg_ii"), (fg.jj, "fg_jj"),
                      (fg.idx_ii2jj, "fg_idx"), (fg.valid_match, "fg_valid"),
                      (fg.Q, "fg_Q")):
        into(buf, name)
    fg.n_edges = fg.n_edges_ub = e
    fg.n_edges_dev = torch.full((), e, dtype=torch.int32, device=fg.device)
    fg._pending = []

    mode = Mode(int(data["mode"]))
    if mode == Mode.TERMINATED:
        # an end-of-run checkpoint: resuming processes more frames
        mode = Mode.TRACKING if kf.n_size else Mode.INIT
    system.mode = mode
    system.backend_queue = [int(x) for x in data["backend_queue"]]
    system._retrieval_prefetch = {}
    system._consec_match = {}
    if system.retrieval is not None and "retrieval_kf_counter" in data:
        st = {k[len("ivf_"):]: data[k] for k in data.files
              if k.startswith("ivf_")}
        if not ("kind" in st and system.retrieval.load_state_dict(st)):
            # another engine's snapshot: replay the stored keyframes
            system.retrieval.kf_counter = 0
            for i in range(min(int(data["retrieval_kf_counter"]),
                               kf.n_size)):
                system.retrieval.update(kf.feat[i], add_after_query=True,
                                        k=1)
    dev = system.device
    if "tracker_idx_f2k" in data:
        system.tracker.idx_f2k = torch.from_numpy(
            data["tracker_idx_f2k"].astype(np.int64)).to(dev)
    if "current_T_WC" in data and system.current_frame is None:
        system.current_frame = Frame(
            frame_id=-1, img=None, uimg=None,
            T_WC=torch.from_numpy(data["current_T_WC"]).to(dev))
    system.resume_frame = (int(data["last_frame_id"]) + 1
                           if "last_frame_id" in data else 0)
    return system
