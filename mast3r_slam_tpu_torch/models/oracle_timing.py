"""Timing-faithful oracle: the real network runs, oracle geometry comes out.

Counterpart of ``mast3r_slam_tpu/models/oracle_timing.py``. Every entry
point runs the full network (``models.mast3r``) on the production shapes,
then returns the oracle's ground-truth predictions. The JAX package folds
the network's outputs into the oracle outputs (``_carry``) so XLA cannot
remove the network as dead code. PyTorch runs eagerly and removes nothing,
so here ``_carry`` is a plain data dependency: it keeps the network's work
ordered before the outputs on the stream and keeps the NaN sanitising of
``_total`` (``oracle_timing.py:72-99``), so a random network that emits NaN
can never reach the oracle geometry.

Frame-id protocol: two uint8 pixels ([0,0,0] = id % 256, [0,0,1] =
id // 256), recoverable after ImgNorm normalization.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import timing
from . import mast3r, oracle


def make_params(net, oracle_params):
    """Combine the real network (a ``mast3r.MASt3R``) with oracle params."""
    return {"net": net, "orc": oracle_params}


def make_frame_image(frame_id: int, h: int, w: int, rng=None):
    """Raw uint8 noise frame carrying ``frame_id`` in two pixels."""
    rng = rng or np.random.default_rng(frame_id)
    img = rng.integers(0, 255, (h, w, 3), np.uint8)
    img[0, 0, 0] = frame_id % 256
    img[0, 0, 1] = frame_id // 256
    return img


def _fid_from_image(img):
    if img.dtype == torch.uint8:
        p0 = img[:, 0, 0, 0].to(torch.int64)
        p1 = img[:, 0, 0, 1].to(torch.int64)
    else:
        p0 = torch.round((img[:, 0, 0, 0] * 0.5 + 0.5) * 255.0).to(torch.int64)
        p1 = torch.round((img[:, 0, 0, 1] * 0.5 + 0.5) * 255.0).to(torch.int64)
    return p0 + 256 * p1


def _total(*reals):
    """A scalar depending on every real output: each element NaN-sanitized
    and made non-negative before the sum, so it is finite or +inf, never
    NaN."""
    tot = None
    for r in reals:
        r32 = r.to(torch.float32)
        s = torch.sum(torch.abs(torch.where(torch.isnan(r32),
                                            torch.zeros_like(r32), r32)))
        tot = s if tot is None else tot + s
    return tot


def _carry(orc, total):
    """``orc`` exactly, plus a term that is 0 for every value ``_total``
    can take."""
    z = torch.where(torch.isnan(total), total, torch.zeros_like(total))
    return orc + z.to(orc.dtype)


def encode(params, img, cfg):
    feat_r, _ = mast3r.encode(params["net"], img, cfg)
    with timing.span("oracle"):
        fid = _fid_from_image(img)
        feat_o, pos_o = oracle.encode_fid(params["orc"], fid, cfg)
    with timing.span("oracle.carry"):
        return _carry(feat_o, _total(feat_r)), pos_o


def inference_mono(params, feat, pos, cfg, ds: int = 1):
    X_r, C_r = mast3r.inference_mono(params["net"], feat, pos, cfg, ds)
    with timing.span("oracle"):
        X_o, C_o = oracle.inference_mono(params["orc"], feat, pos, cfg, ds)
    with timing.span("oracle.carry"):
        t = _total(X_r, C_r)
        return _carry(X_o, t), _carry(C_o, t)


def inference_asymmetric(params, feat_f, pos_f, feat_k, pos_k, cfg):
    real = mast3r.inference_asymmetric(params["net"], feat_f, pos_f,
                                       feat_k, pos_k, cfg)
    with timing.span("oracle"):
        orc = oracle.inference_asymmetric(params["orc"], feat_f, pos_f,
                                          feat_k, pos_k, cfg)
    with timing.span("oracle.carry"):
        t = _total(*real)
        return tuple(_carry(o, t) for o in orc)


def inference_symmetric(params, feat_i, pos_i, feat_j, pos_j, cfg):
    real = mast3r.inference_symmetric(params["net"], feat_i, pos_i,
                                      feat_j, pos_j, cfg)
    with timing.span("oracle"):
        orc = oracle.inference_symmetric(params["orc"], feat_i, pos_i,
                                         feat_j, pos_j, cfg)
    with timing.span("oracle.carry"):
        t = _total(*real.values())
        return {k: _carry(v, t) for k, v in orc.items()}
