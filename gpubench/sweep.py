"""The rate sweep that fixes the ``live`` mix's camera rate: the cell run at
each rate in turn, and whether its backlog grows.

    python -m gpubench.sweep --workload tpu_fast.live.w1 --seconds 30 --seed 1 --rates 6 8 10 12

For each rate: the frames' latencies (due to done on the device), their
median and 95th percentile, and the growth of the backlog: the mean
latency of the window's last third less that of its first third. A rate
is sustained when that growth stays under one frame interval. The rate
the mix runs at is four fifths of the highest sustained one; this script
reports, the mix file holds the number. One JSON line a rate.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np
import torch

from gpubench import harness


def one(workload, seed, seconds, rate, device="cuda", sizes=None):
    sizes = dict(sizes or {})
    sizes["mix"] = dict(sizes.get("mix", {}), arrival={"rate_hz": rate})
    run = harness.Run(workload, seed, seconds, device=device, sizes=sizes)
    run.setup()
    run.window()
    fr = sorted(run.rec.frames, key=lambda f: f[2])
    lat = np.array([f[4] - f[2] for f in fr])
    third = max(len(lat) // 3, 1)
    growth = float(lat[-third:].mean() - lat[:third].mean())
    run.shim.uninstall()
    out = {"rate_hz": rate, "frames": len(lat),
           "p50_ms": 1e3 * float(np.percentile(lat, 50)),
           "p95_ms": 1e3 * float(np.percentile(lat, 95)),
           "max_ms": 1e3 * float(lat.max()),
           "backlog_growth_ms": 1e3 * growth,
           "sustained": growth < 1.0 / rate}
    del run
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    for r in args.rates:
        print(json.dumps(one(args.workload, args.seed, args.seconds, r)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
