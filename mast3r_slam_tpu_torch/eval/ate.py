"""Absolute trajectory error (ATE RMSE) with Sim(3) alignment, and the
relative pose error (numpy only).

The port's own copy of ``mast3r_slam_tpu/eval/ate.py``: TUM trajectory
loading, timestamp association, Umeyama similarity alignment, ATE and RPE,
and the ``main`` command line (``python -m mast3r_slam_tpu_torch.eval.ate
gt.txt traj.txt``); plus ``aligned_rmse``, the aligned keyframe-position
RMSE the oracle checks use.
"""

from __future__ import annotations

import numpy as np


def load_tum_trajectory(path):
    """Load TUM format `t x y z qx qy qz qw` -> (stamps (n,), t (n,3),
    q (n,4))."""
    data = np.loadtxt(path, dtype=np.float64, comments="#")
    data = np.atleast_2d(data)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def associate(stamps_a, stamps_b, max_diff: float = 0.02):
    """Greedy nearest-timestamp association (evo/TUM tooling semantics).

    Returns index arrays (ia, ib).
    """
    ia, ib = [], []
    j = 0
    order = np.argsort(stamps_b)
    sb = stamps_b[order]
    for i, t in enumerate(stamps_a):
        j = np.searchsorted(sb, t)
        best, bestd = -1, max_diff
        for k in (j - 1, j):
            if 0 <= k < len(sb):
                d = abs(sb[k] - t)
                if d <= bestd:
                    best, bestd = k, d
        if best >= 0:
            ia.append(i)
            ib.append(order[best])
    return np.asarray(ia, dtype=np.int64), np.asarray(ib, dtype=np.int64)


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


def ate_rmse(gt_file, traj_file, max_diff: float = 0.02,
             with_scale: bool = True):
    """Sim3-aligned ATE RMSE between a ground-truth and estimated TUM
    trajectory. Returns dict(rmse, mean, median, n_pairs, scale)."""
    ts_gt, t_gt, _ = load_tum_trajectory(gt_file)
    ts_est, t_est, _ = load_tum_trajectory(traj_file)
    ia, ib = associate(ts_gt, ts_est, max_diff)
    if len(ia) < 3:
        raise ValueError(f"only {len(ia)} associated poses")
    x = t_est[ib]
    y = t_gt[ia]
    s, R, t = umeyama_alignment(x, y, with_scale)
    aligned = (s * (R @ x.T)).T + t
    err = np.linalg.norm(aligned - y, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "n_pairs": int(len(ia)),
        "scale": s,
    }


def _quat_to_R(q):
    """(n, 4) xyzw quaternions -> (n, 3, 3) rotation matrices."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def rpe(gt_file, traj_file, delta: int = 1, max_diff: float = 0.02):
    """Relative pose error over associated pose pairs ``delta`` frames
    apart (the standard drift metric alongside ATE; semantics of
    ``evo_rpe``/the TUM tooling). Returns dict with translational RMSE
    (trans_rmse, meters per delta) and rotational RMSE (rot_rmse_deg).
    Alignment-free: relative motions cancel the global frame (scale is NOT
    normalized — use ATE's Sim3 alignment for monocular scale).

    UNIT NOTE: ``delta`` counts associated POSES (for SLAM output:
    keyframes), not seconds or meters — evo's ``--delta ... --delta_unit
    s|m`` numbers are NOT directly comparable; use this RPE for in-tree
    regression and ATE RMSE for cross-paper comparison."""
    ts_gt, t_gt, q_gt = load_tum_trajectory(gt_file)
    ts_est, t_est, q_est = load_tum_trajectory(traj_file)
    ia, ib = associate(ts_gt, ts_est, max_diff)
    if len(ia) < delta + 2:
        raise ValueError(f"only {len(ia)} associated poses")
    Rg = _quat_to_R(q_gt[ia])
    Re = _quat_to_R(q_est[ib])
    tg, te = t_gt[ia], t_est[ib]
    n = len(ia) - delta
    # relative motions i -> i+delta in each trajectory, batched
    dRg = np.einsum("nji,njk->nik", Rg[:n], Rg[delta:])
    dtg = np.einsum("nji,nj->ni", Rg[:n], tg[delta:] - tg[:n])
    dRe = np.einsum("nji,njk->nik", Re[:n], Re[delta:])
    dte = np.einsum("nji,nj->ni", Re[:n], te[delta:] - te[:n])
    terr = np.linalg.norm(dte - dtg, axis=1)
    tr = np.einsum("nji,nji->n", dRg, dRe)   # trace(dRg^T dRe)
    rerr = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    return {
        "trans_rmse": float(np.sqrt(np.mean(terr ** 2))),
        "rot_rmse_deg": float(np.sqrt(np.mean(rerr ** 2))),
        "n_pairs": int(n),
        "delta": int(delta),
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Sim3-aligned ATE RMSE")
    p.add_argument("gt")
    p.add_argument("traj")
    p.add_argument("--max-diff", type=float, default=0.02)
    p.add_argument("--no-scale", action="store_true")
    p.add_argument("--rpe-delta", type=int, default=0,
                   help="> 0: also print RPE over pose pairs this many "
                        "frames apart")
    args = p.parse_args(argv)
    res = ate_rmse(args.gt, args.traj, args.max_diff,
                   with_scale=not args.no_scale)
    print(f"ATE RMSE: {res['rmse']:.6f} m  (mean {res['mean']:.6f}, "
          f"median {res['median']:.6f}, pairs {res['n_pairs']}, "
          f"scale {res['scale']:.4f})")
    if args.rpe_delta > 0:
        r = rpe(args.gt, args.traj, args.rpe_delta, args.max_diff)
        print(f"RPE(delta={r['delta']}): trans {r['trans_rmse']:.6f} m, "
              f"rot {r['rot_rmse_deg']:.4f} deg  (pairs {r['n_pairs']})")


if __name__ == "__main__":
    main()
