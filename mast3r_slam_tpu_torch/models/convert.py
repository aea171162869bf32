"""Carry weights across from the JAX package's parameter pytrees.

``from_jax_params`` maps a JAX MASt3R parameter tree (numpy leaves, as
``jax.device_get`` returns it) to the port's ``state_dict``, which uses the
reference checkpoint names, so the mapping is the one
``mast3r_slam_tpu/models/convert.py::export_state_dict`` (:363) writes:

* linear ``(in, out)`` -> ``(out, in)``;
* conv HWIO -> OIHW;
* transposed conv ``(s, s, in, out)`` -> ``(in, out, s, s)``, no flip
  (``layers.conv_transpose2d``, :64-84);
* the patch embed ``(ps*ps*3, E)`` matmul -> the ``(E, 3, ps, ps)`` conv;
* ``dec_blocks_s`` (leaf shape ``(2, ...)``) unstacks into ``dec_blocks``
  and ``dec_blocks2``.

``oracle_params_from_jax`` carries the oracle's scene/trajectory arrays.
``retrieval_params_from_jax`` carries the retrieval head and codebook.
``slam_state_from_jax`` carries a keyframe store's and a factor graph's
arrays, so both packages' solvers can start from one state.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _lin(out, name, p):
    out[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        out[f"{name}.bias"] = _t(p["b"])


def _conv(out, name, p):
    out[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    if "b" in p:
        out[f"{name}.bias"] = _t(p["b"])


def _deconv(out, name, p):
    out[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(2, 3, 0, 1))
    if "b" in p:
        out[f"{name}.bias"] = _t(p["b"])


def _norm(out, name, p):
    out[f"{name}.weight"] = _t(p["w"])
    out[f"{name}.bias"] = _t(p["b"])


def _enc_block(out, pre, p):
    _norm(out, f"{pre}.norm1", p["norm1"])
    _lin(out, f"{pre}.attn.qkv", p["attn"]["qkv"])
    _lin(out, f"{pre}.attn.proj", p["attn"]["proj"])
    _norm(out, f"{pre}.norm2", p["norm2"])
    _lin(out, f"{pre}.mlp.fc1", p["mlp"]["fc1"])
    _lin(out, f"{pre}.mlp.fc2", p["mlp"]["fc2"])


def _dec_block(out, pre, p):
    _norm(out, f"{pre}.norm1", p["norm1"])
    _lin(out, f"{pre}.attn.qkv", p["attn"]["qkv"])
    _lin(out, f"{pre}.attn.proj", p["attn"]["proj"])
    for nm in ("projq", "projk", "projv", "proj"):
        _lin(out, f"{pre}.cross_attn.{nm}", p["cross_attn"][nm])
    _norm(out, f"{pre}.norm2", p["norm2"])
    _norm(out, f"{pre}.norm3", p["norm3"])
    _norm(out, f"{pre}.norm_y", p["norm_y"])
    _lin(out, f"{pre}.mlp.fc1", p["mlp"]["fc1"])
    _lin(out, f"{pre}.mlp.fc2", p["mlp"]["fc2"])


def _head(out, pre, p):
    dpt = f"{pre}.dpt"
    ap = p["dpt"]["act_postprocess"]
    _conv(out, f"{dpt}.act_postprocess.0.0", ap[0]["proj"])
    _deconv(out, f"{dpt}.act_postprocess.0.1", ap[0]["deconv"])
    _conv(out, f"{dpt}.act_postprocess.1.0", ap[1]["proj"])
    _deconv(out, f"{dpt}.act_postprocess.1.1", ap[1]["deconv"])
    _conv(out, f"{dpt}.act_postprocess.2.0", ap[2]["proj"])
    _conv(out, f"{dpt}.act_postprocess.3.0", ap[3]["proj"])
    _conv(out, f"{dpt}.act_postprocess.3.1", ap[3]["conv"])
    for i in (1, 2, 3, 4):
        _conv(out, f"{dpt}.scratch.layer{i}_rn", p["dpt"]["layer_rn"][i - 1])
        rf = p["dpt"][f"refinenet{i}"]
        for unit in ("resConfUnit1", "resConfUnit2"):
            for c in ("conv1", "conv2"):
                _conv(out, f"{dpt}.scratch.refinenet{i}.{unit}.{c}",
                      rf[unit][c])
        _conv(out, f"{dpt}.scratch.refinenet{i}.out_conv", rf["out_conv"])
    hd = p["dpt"]["head"]
    _conv(out, f"{dpt}.head.0", hd["conv1"])
    _conv(out, f"{dpt}.head.2", hd["conv2"])
    _conv(out, f"{dpt}.head.4", hd["conv3"])
    _lin(out, f"{pre}.head_local_features.fc1",
         p["head_local_features"]["fc1"])
    _lin(out, f"{pre}.head_local_features.fc2",
         p["head_local_features"]["fc2"])


def _stream(tree, s):
    if isinstance(tree, dict):
        return {k: _stream(v, s) for k, v in tree.items()}
    return np.asarray(tree)[s]


def from_jax_params(tree) -> dict:
    """JAX MASt3R parameter tree -> the port's (reference-named)
    ``state_dict`` of fp32 CPU tensors."""
    out = {}
    pe = tree["patch_embed"]["proj"]
    w = np.asarray(pe["w"], np.float32)
    e = w.shape[1]
    ps = int(round((w.shape[0] // 3) ** 0.5))
    out["patch_embed.proj.weight"] = _t(
        w.reshape(ps, ps, 3, e).transpose(3, 2, 0, 1))
    out["patch_embed.proj.bias"] = _t(pe["b"])
    for i, blk in enumerate(tree["enc_blocks"]):
        _enc_block(out, f"enc_blocks.{i}", blk)
    _norm(out, "enc_norm", tree["enc_norm"])
    _lin(out, "decoder_embed", tree["decoder_embed"])
    for i, blk_s in enumerate(tree["dec_blocks_s"]):
        _dec_block(out, f"dec_blocks.{i}", _stream(blk_s, 0))
        _dec_block(out, f"dec_blocks2.{i}", _stream(blk_s, 1))
    _norm(out, "dec_norm", tree["dec_norm"])
    _head(out, "downstream_head1", tree["head1"])
    _head(out, "downstream_head2", tree["head2"])
    return out


def oracle_params_from_jax(tree, device="cuda") -> dict:
    """JAX oracle params (``models/oracle.make_params``: traj, desc_proj,
    sphere/plane scalars, cluttered-scene arrays) -> the port's dict of
    fp32 tensors on ``device``."""
    from .._device import resolve_device

    dev = resolve_device(device)
    return {k: (float(np.asarray(v)) if k == "pix_noise" else _t(v).to(dev))
            for k, v in tree.items()}


def retrieval_params_from_jax(tree, device="cuda") -> dict:
    """JAX retrieval params (``slam/retrieval.init_retrieval_params`` or
    ``convert_retrieval_checkpoint``, numpy leaves: ``prewhiten.{m,p}``,
    ``projector.{w,b}``, ``postwhiten`` or None, ``centroids``) -> the
    same tree of fp32 tensors on ``device``. Both packages apply the
    matrices as ``x @ p`` and ``x @ w``, so nothing is transposed."""
    from .._device import resolve_device

    dev = resolve_device(device)

    def walk(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        return _t(v).to(dev)

    return walk(dict(tree))


def _rows(a, n):
    """The first n rows as a torch tensor (bf16 arrays go through fp32:
    numpy's bfloat16 is not a dtype torch reads)."""
    a = np.asarray(a[:n])
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


KEYFRAME_FIELDS = ("dataset_idx", "T_WC", "X", "C", "N", "N_updates", "feat",
                   "pos", "score")
EDGE_FIELDS = ("ii", "jj", "idx_ii2jj", "valid_match", "Q")


def slam_state_from_jax(kf_arrays: dict, fg_arrays: dict, keyframes,
                        factor_graph=None):
    """Fill the port's ``KeyframeStore`` and ``FactorGraph`` in place from
    the numpy arrays of the JAX package's.

    ``kf_arrays``: ``n_size`` and any of ``KEYFRAME_FIELDS`` (capacity-padded
    arrays of ``mast3r_slam_tpu/slam/frame.py::KeyframeStore``);
    ``fg_arrays``: ``n_edges`` and ``EDGE_FIELDS`` (of
    ``mast3r_slam_tpu/slam/factor_graph.py::FactorGraph``). The active rows
    are copied; the port's buffers grow where they are too small for the
    edges."""
    n = int(kf_arrays["n_size"])
    if n > keyframes.capacity:
        raise ValueError(f"{n} keyframes do not fit a capacity of "
                         f"{keyframes.capacity}")
    keyframes.n_size = n
    for name in KEYFRAME_FIELDS:
        if name in kf_arrays:
            dst = getattr(keyframes, name)
            dst[:n] = _rows(kf_arrays[name], n).to(device=dst.device,
                                                   dtype=dst.dtype)
    if factor_graph is None:
        return
    fg = factor_graph
    e = int(fg_arrays["n_edges"])
    if not fg.ensure_capacity(e):
        raise ValueError(f"{e} edges exceed max_edge_capacity")
    for name in EDGE_FIELDS:
        dst = getattr(fg, name)
        dst[:e] = _rows(fg_arrays[name], e).to(device=dst.device,
                                               dtype=dst.dtype)
    fg.n_edges = fg.n_edges_ub = e
    fg.n_edges_dev = torch.full((), e, dtype=torch.int32, device=fg.device)
