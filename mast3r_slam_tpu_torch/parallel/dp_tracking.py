"""Data-parallel tracking of several sequences, one per device, and the
symmetric decode of an edge batch split over the devices.

Counterpart of ``mast3r_slam_tpu/parallel/dp_tracking.py`` and of the
sharded ``inference_symmetric`` of ``tests/test_parallel.py:38``. The JAX
package maps S sequences over a ``seq`` mesh axis with ``shard_map``; here
each sequence is a ``SeqInputs`` whose tensors and keyframe store live on
its device, and ``track_window_dp`` runs the windowed tracker
(``slam.system._track_window_body``) once per sequence. No call reads the
device, so all S windows are enqueued before the caller reads any
``hoststats``: on distinct GPUs they run at once. Each sequence's result is
the one a lone window on that device gives, bit for bit: the same
operations on the same tensors; nothing passes between sequences.

Across processes (a mesh of ``parallel/mesh.py`` that spans ranks) each
rank tracks its own ``len(mesh.devices)`` sequences, the global sequences
``first_shard + l``, and gets their outputs: the counterpart of the
addressable shards of JAX's global output; no collective is needed. The
sharded decode splits the batch into ``mesh.size`` chunks, each rank
decodes its own, and ``mesh.all_gather_shards`` gives every rank the whole
batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models import mast3r
from ..slam.frame import KeyframeStore
from ..slam.system import WindowOut, _track_window_body
from .backend_device import params_to
from .mesh import (Mesh, all_gather_shards, normalize_device,
                   pad_to_multiple, shard_edges)

__all__ = ["SeqInputs", "inference_symmetric_dp", "replicate_params",
           "track_window_dp"]


class SeqInputs(NamedTuple):
    """One sequence's window (``dp_tracking.py:40``), every tensor on the
    sequence's device."""

    imgs: torch.Tensor               # (W, h, w, 3) frames, uint8 or float
    frame_ids: list                  # W host ints
    idx_init: Optional[torch.Tensor]  # (n,) match warm start, or None
    prev_T_WC: torch.Tensor          # (8,) the last tracked frame's pose
    K: torch.Tensor                  # (3, 3)
    last_idx: int                    # the current keyframe's row in kfs
    kfs: KeyframeStore               # written in place, as a lone window
    intrinsics: Optional[tuple] = None  # K's (fx, fy, cx, cy), calibrated


def replicate_params(params, mesh: Mesh) -> list:
    """The model parameters for each device of the mesh, in mesh order: one
    copy per distinct device (``backend_device.params_to``: a module, a
    tensor or a dict of them), shared where the mesh repeats a device."""
    copies = {}
    return [copies.setdefault(d, params_to(params, d)) for d in mesh.devices]


def _check_on(dev, seq: SeqInputs, s: int):
    kfs = seq.kfs
    held = [seq.imgs, seq.prev_T_WC, seq.K, kfs.X, kfs.T_WC, kfs.feat]
    if seq.idx_init is not None:
        held.append(seq.idx_init)
    where = {normalize_device(t.device) for t in held}
    if where != {dev}:
        raise ValueError(f"track_window_dp: sequence {s}'s tensors lie on "
                         f"{sorted(map(str, where))}, not on its mesh "
                         f"device {dev}")


def track_window_dp(params_by_device, model_cfg, mcfg, tcfg, seqs,
                    mesh: Mesh, ds: int = 1,
                    fuse_mode: str = "weighted_pointmap",
                    score_fn: str = "median", use_calib: bool = False,
                    capture_matches: bool = True,
                    model_mod=mast3r) -> list:
    """The windowed tracker for S sequences, sequence ``s`` on
    ``mesh.devices[s]`` with ``params_by_device[s]`` (``replicate_params``)
    (``dp_tracking.py:40``). S must equal the number of local devices
    (``ValueError`` otherwise: a larger S would drop sequences), which on
    every rank of a mesh across processes makes the mesh size globally;
    each sequence's tensors must lie on its device (``ValueError``). Each
    keyframe store is written in place. Returns one ``WindowOut`` per
    sequence, all still on their devices: the caller reads each
    ``hoststats`` (the window's one host read) after every window is
    enqueued."""
    if len(seqs) != len(mesh.devices):
        raise ValueError(
            f"track_window_dp maps one sequence per device: got S = "
            f"{len(seqs)} sequences for the {len(mesh.devices)} local "
            f"devices of a {mesh.size}-device mesh (a larger S would "
            "silently drop sequences)")
    for s, (dev, seq) in enumerate(zip(mesh.devices, seqs)):
        _check_on(dev, seq, mesh.first_shard + s)
    outs: list[WindowOut] = []
    for params, seq in zip(params_by_device, seqs):
        kfs = seq.kfs
        outs.append(_track_window_body(
            model_mod, params, model_cfg, mcfg, tcfg, seq.imgs,
            list(seq.frame_ids), seq.idx_init, seq.prev_T_WC, seq.K,
            seq.last_idx, kfs, ds, fuse_mode, score_fn, use_calib,
            (kfs.h, kfs.w), seq.intrinsics, capture_matches))
    return outs


def inference_symmetric_dp(params_by_device, mesh: Mesh, feat_i, pos_i,
                           feat_j, pos_j, cfg, model_mod=mast3r) -> dict:
    """``inference_symmetric`` of an edge batch split over the mesh
    (``tests/test_parallel.py:38``): the batch padded to a multiple of the
    mesh size (``pad_to_multiple``), this rank's chunks decoded, chunk
    ``first_shard + l`` on ``mesh.devices[l]`` with
    ``params_by_device[l]``, the outputs gathered in shard order on the
    first local device (``mesh.all_gather_shards``: one collective an
    output dtype across processes) and the padding cut off. Every rank
    passes the whole batch and gets the whole result. The same keys as
    ``model_mod.inference_symmetric``."""
    b = feat_i.shape[0]
    chunks = shard_edges(mesh, *(pad_to_multiple(t, mesh.size)
                                 for t in (feat_i, pos_i, feat_j, pos_j)))
    outs = [model_mod.inference_symmetric(params, fi, pi, fj, pj, cfg)
            for params, fi, pi, fj, pj in zip(params_by_device, *chunks)]
    keys = list(outs[0])
    got = all_gather_shards(mesh, [tuple(o[k] for k in keys) for o in outs])
    return {k: t[:b] for k, t in zip(keys, got)}
