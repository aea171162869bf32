"""Run one cell of the benchmark once and print its result line.

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program
(``mast3r_slam_tpu_torch/``). Set-up (imports, weights from the seed on
the device, the retrieval codebook, the kernels' build on a checkout's
first run, one warm scan, the window's scan and its system) is timed as
``setup_s``; then the window drives ``SLAMSystem.run`` over one long scan
for ``--seconds``. With ``--trace 1`` the window's last seconds run under
``torch.profiler`` and the per-layer metrics are printed instead of the
end-to-end ones. Every metric, end to end or per layer, is read by its own
reader, ``metrics/<name>.py``. The check (``check.py``) follows,
once the program's state is freed. The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that object. Without a CUDA
device, or with fewer than the cell asks for, it exits 3 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
# kernel and compiler caches at fixed places inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton_cache")):
    os.environ[var] = str(REPO / sub)
# one process with few host threads, so that runs spread less
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "2")

import torch  # noqa: E402

from gpubench import harness, trace  # noqa: E402
from gpubench.harness import log  # noqa: E402

# seconds of the window's end that a traced run profiles
TRACE_SECONDS = 10.0
RANGES = ("trace_window", "system_init", "make_frame", "process_frame",
          "dispatch_window", "consume_window", "backend_step",
          "net.encode", "net.inference_mono", "net.inference_asymmetric",
          "net.inference_symmetric")


class Context:
    """What a reader reads: the window's spans, network calls and frames
    (scan, frame, due, taken, done), its close, the set-up time, the model
    sizes, and, in a traced run, the traced part's device intervals, busy
    and window seconds and its start on the host clock."""

    def __init__(self, run, device=None, window=None):
        self.m = run.m
        self.calls = run.rec.calls
        self.spans = run.rec.spans
        self.frames = run.rec.frames
        self.seconds = run.seconds
        self.setup_s = run.setup_s
        self.t0, self.t1 = run.clock.t0, run.clock.closes
        self.device = device
        self.busy_s = self.window_s = 0.0
        self.trace_t0 = run.tracer.t0 if run.tracer is not None else None
        if device is not None:
            lo, hi = window
            self.window_s = hi - lo
            self.busy_s, _ = trace.busy_and_gaps(device, lo, hi)
        self.notes = []

    def note(self, msg):
        self.notes.append(msg)
        log(msg)

    def window_spans(self, names):
        return [s for s in self.spans if s[0] == "window" and s[1] in names]

    def span_seconds(self, name):
        """Seconds of the window inside spans ``name``, clipped to it."""
        spans = self.window_spans((name,))
        if not spans:
            return None
        return sum(max(0.0, min(s[3], self.t1) - max(s[2], self.t0))
                   for s in spans)

    def traced_calls(self):
        """The network calls made while the profiler ran."""
        if self.trace_t0 is None:
            return []
        return [c for c in self.calls
                if c[0] == "window" and c[3] >= self.trace_t0]


def card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None, device="cuda", sizes=None, root=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = root or harness.REPO
    cell = harness.cell_spec(args.workload, root)[0]
    if device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark measures the GPU only")
            return 3
        if torch.cuda.device_count() < int(cell["chips"]):
            log(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {cell['chips']}")
            return 3
    run = harness.Run(args.workload, args.seed, args.seconds,
                      device=device, sizes=sizes, root=root,
                      t_start=T_START if device == "cuda" else None)
    run.setup(trace=bool(args.trace))
    run.window(TRACE_SECONDS if args.trace else 0.0)
    result = {}
    has_dev = run.dev.type == "cuda"
    if args.trace and run.tracer.prof is not None:
        t = time.perf_counter()
        device_ev, ranges = trace.read_profile(run.tracer.prof, RANGES)
        run.tracer.prof = None
        span = [r for r in ranges if r[0] == "trace_window"]
        lo, hi = (span[0][1], span[0][2]) if span else (0.0, 0.0)
        ctx = Context(run, device_ev if has_dev else None, (lo, hi))
        if has_dev:
            result["breakdown"] = trace.breakdown(device_ev, ranges, lo, hi)
        log(f"profile read in {time.perf_counter() - t:.1f} s: "
            f"{len(device_ev)} device events over {hi - lo:.2f} s")
    else:
        ctx = Context(run)
    if has_dev:
        peak = torch.cuda.max_memory_allocated()
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    # free the program's state before the reference runs
    scans = run.host_results()
    run.net = None
    gc.collect()
    if has_dev:
        torch.cuda.empty_cache()
    metrics = {}
    for m in (run.per_layer if args.trace else run.end_to_end):
        v = harness.load_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    t = time.perf_counter()
    checks, readings, detail = run.checks(scans)
    log(f"check took {time.perf_counter() - t:.1f} s")
    run.shim.uninstall()
    correct = all(v == v and v <= lim for _, v, lim in checks)
    found = harness.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 4
    frames = run.rec.frames
    failed = sum(r["stats"]["skipped"] + r["stats"]["frames_reloc"]
                 for r in scans)
    dev = {"platform": "gpu" if run.dev.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    if args.trace:
        dev["busy_s"], dev["window_s"] = ctx.busy_s, ctx.window_s
    out = {"correct": bool(correct), "attempted": len(frames),
           "failed": int(failed), "metrics": metrics, "device": dev}
    out.update(result)
    if has_dev:
        out["card"] = card()
    out["host"] = run.host
    out["scans"] = [{"scan": r["scan"], "finished": r["finished"],
                     "frames": r["frames_run"],
                     "tracked": len(r["track_ids"]),
                     "keyframes": r["stats"]["keyframes"],
                     "loop_closures": r["stats"]["loop_closures"],
                     "edges": len(r["ii"]) if r.get("checked") else None}
                    for r in scans]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for line in detail:
        log(line)
    log("readings: " + json.dumps(readings))
    print(json.dumps(out), flush=True)
    for n, v, lim in checks:
        log(f"check {n}: {v!r} (limit {lim!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
