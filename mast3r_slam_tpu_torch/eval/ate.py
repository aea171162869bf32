"""Trajectory alignment for evaluation (numpy only).

The port's own copy of ``mast3r_slam_tpu/eval/ate.py::umeyama_alignment``
(:45), plus the aligned keyframe-position RMSE the oracle checks use.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y, with_scale: bool = True):
    """Least-squares similarity y ~ s R x + t (Umeyama 1991); x, y (n, 3).
    Returns (s, R (3, 3), t (3,))."""
    mx = x.mean(axis=0)
    my = y.mean(axis=0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc ** 2).sum() / len(x)
        s = float(np.trace(np.diag(d) @ S) / var_x)
    else:
        s = 1.0
    t = my - s * R @ mx
    return s, R, t


def aligned_rmse(est, gt):
    """(rmse, extent): Sim(3)-aligned RMSE of positions est -> gt (n, 3)
    and the diagonal of gt's bounding box."""
    s, R, t = umeyama_alignment(est, gt)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    return float(np.sqrt((err ** 2).mean())), extent
