"""Readings that the limits of ``check.py`` are set from: for each seed, a
short window of the cell as the benchmark runs it, the program's numbers,
and the control's, in one process.

    python -m gpubench.calibrate --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The control is the reference put in the program's place one precision step
below what the configuration states (its ``control`` map: fp8 operands where
the program computes in bf16, TF32 where it computes in float32), judged by
the same comparison: for the network, the reference network at that
precision on the sampled calls' inputs; for the poses, the scan's poses
composed in bfloat16. Each of the configuration's ``part_controls`` lowers
one part alone (attention, heads, trunk) and keeps the others at the stated
precision, and is judged the same way. The benchmark's own runs never run
this. One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from gpubench import check, harness, record
from gpubench import run as run_mod
from gpubench.reference import scene


def traj_bf16(n, phase, step_scale):
    """``scene.make_traj`` composed with every product rounded to
    bfloat16: (n, 7) positions and quaternions."""
    T = torch.tensor(scene.se3_exp(np.array(
        [0.011, -0.007, 0.004, 0.0, 0.002, 0.001]) * phase),
        dtype=torch.bfloat16)
    mats = [T]
    for i in range(1, n):
        xi = np.array([0.03, 0.01 * np.sin((i + 3.0 * phase) / 5.0), 0.008,
                       0.0, 0.012, 0.002]) * step_scale
        T = (T @ torch.tensor(scene.se3_exp(xi), dtype=torch.bfloat16))
        mats.append(T)
    out = []
    for T in mats:
        M = T.double().numpy()
        U, _, Vt = np.linalg.svd(M[:3, :3])
        out.append(np.concatenate([M[:3, 3], scene.mat_to_quat(U @ Vt)]))
    return np.asarray(out)


def pose_control(scans, mix):
    """``check.pose_numbers`` of the scans' poses composed in bfloat16, at
    the frames the program answered for."""
    def answers(r, which):
        orbit = int(mix["orbit_frames"])
        lo = traj_bf16(orbit, r["phase"], float(mix["step_scale"]))[
            scene.scan_index(len(r["traj"]), orbit)]
        ids = r["track_ids"] if which == "track" else r["kf_idx"]
        return lo[np.asarray(ids)]

    return check.pose_numbers(scans, answers)


def one(workload, seed, seconds, device="cuda", sizes=None):
    run = harness.Run(workload, seed, seconds, device=device, sizes=sizes)
    run.setup()
    run.window()
    e2e = {m["name"]: harness.load_reader(m["name"])(run_mod.Context(run))
           for m in run.end_to_end}
    scans = run.host_results()
    run.net = None
    gc.collect()
    if run.dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, readings, detail = run.checks(scans)
    samples = [s for kind in record.KINDS for s in run.sampler.kept[kind]]
    trajs = {r["scan"]: r["traj"] for r in run.scans}
    prog = check.net_errors(samples, run.weights, run.m, trajs)
    ctl = check.net_errors(samples, run.weights, run.m, trajs,
                           prec=run.config["control"], program=False)
    parts = {name: check.net_numbers(check.net_errors(
                 samples, run.weights, run.m, trajs, prec=prec,
                 program=False))
             for name, prec in run.config.get("part_controls", {}).items()}
    pose_ctl = pose_control(scans, run.mix)
    run.shim.uninstall()
    run.waiter = None

    return {"workload": workload, "seed": seed, "seconds": seconds,
            "program": readings,
            "compared": {n: [v, lim] for n, v, lim in checks},
            "control": dict(check.net_numbers(ctl), **pose_ctl),
            "part_controls": parts,
            "net_errors": prog, "control_errors": ctl,
            "detail": detail, "e2e": e2e,
            "scans": [(r["scan"], r["finished"], len(r["track_ids"]),
                       r["stats"]["keyframes"]) for r in scans]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for s in args.seeds:
        t = time.perf_counter()
        res = one(args.workload, s, args.seconds)
        res["wall_s"] = time.perf_counter() - t
        print(json.dumps(res), flush=True)
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
