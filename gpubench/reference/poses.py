"""Sim(3)-aligned trajectory error, in NumPy (a frozen copy of
``mast3r_slam_tpu_torch/eval/ate.py::umeyama_alignment`` and
``aligned_rmse``)."""

from __future__ import annotations

import numpy as np


def umeyama(x, y):
    """Least-squares similarity y ~ s R x + t (Umeyama 1991); x, y (n, 3)
    float64. Returns (s, R, t)."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    U, d, Vt = np.linalg.svd(yc.T @ xc / len(x))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / len(x)
    s = float(np.trace(np.diag(d) @ S) / max(var_x, 1e-300))
    return s, R, my - s * R @ mx


def aligned_error(est, gt):
    """RMSE of positions ``est`` (n, 3) after their Sim(3) alignment to
    ``gt``, over the diagonal of ``gt``'s bounding box."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    s, R, t = umeyama(est, gt)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    return float(np.sqrt((err ** 2).mean())) / max(extent, 1e-12)


def quat_to_mat(q):
    """(n, 4) quaternions (x, y, z, w) -> (n, 3, 3) rotations."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], axis=1)


def rotation_error(est, gt):
    """RMS angle (radians) between the orientations of poses ``est`` and
    ``gt`` (n, 7: position, quaternion x y z w) relative to their first
    pose, so that no alignment enters."""
    Re = quat_to_mat(np.asarray(est, np.float64)[:, 3:7])
    Rg = quat_to_mat(np.asarray(gt, np.float64)[:, 3:7])
    rel_e = np.einsum("ji,njk->nik", Re[0], Re)
    rel_g = np.einsum("ji,njk->nik", Rg[0], Rg)
    d = np.einsum("nji,njk->nik", rel_g, rel_e)
    c = np.clip((np.trace(d, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.sqrt((np.arccos(c) ** 2).mean()))


def step_rotation_error(est, gt):
    """RMS angle (radians) between the rotations from each pose to the next
    of ``est`` and of ``gt`` (n, 7)."""
    Re = quat_to_mat(np.asarray(est, np.float64)[:, 3:7])
    Rg = quat_to_mat(np.asarray(gt, np.float64)[:, 3:7])
    se = np.einsum("nji,njk->nik", Re[:-1], Re[1:])
    sg = np.einsum("nji,njk->nik", Rg[:-1], Rg[1:])
    d = np.einsum("nji,njk->nik", sg, se)
    c = np.clip((np.trace(d, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.sqrt((np.arccos(c) ** 2).mean()))
