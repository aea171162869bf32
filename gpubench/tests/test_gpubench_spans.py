"""Traced runs of the harness at the tiny size on the CPU, read through the
program's own spans (``gpubench/program.py``): each metric of a cell that
rests on them reads a number (``net_launch_idle.scan`` needs a device
trace and reads nothing here; ``pose_latency_p50_ms.live``, not listed in
the manifest yet, is read from the live run directly), the program's
``backend.step`` spans time what the harness's ``backend_step`` wrappers
time, and each ``mast3r.*`` span lies inside the harness's ``net.*`` span
around it."""

import json

import pytest

from gpubench import harness, program, run
from gpubench.tests.tiny import SIZES

DEVICE_ONLY = {"net_launch_idle.scan", "device_idle.scan",
               "roofline.rope_qk.scan"}
NEW = {"host_wait_share.scan", "host_syncs_per_frame.scan",
       "net_launch_idle.scan", "ba_share.scan", "retrieval_share.scan",
       "ba_iters_per_solve.scan"}


def _traced(capsys, monkeypatch, cell, seed):
    seen = {}
    load = harness.load_reader

    def capture(name):
        read = load(name)

        def wrapped(ctx):
            seen["ctx"] = ctx
            return read(ctx)
        return wrapped

    monkeypatch.setattr(harness, "load_reader", capture)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "3", "--trace", "1"], device="cpu", sizes=SIZES)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out, seen["ctx"]


def _harness_seconds(ctx, name, lo, hi):
    return program.seconds([(int(s[2] * 1e9), int(s[3] * 1e9))
                            for s in ctx.window_spans((name,))], lo, hi)


@pytest.mark.parametrize("cell,seed", [("tpu_fast.scan.w8", 2 ** 31 + 7),
                                       ("tpu_fast.live.w1", 11)])
def test_traced_run_reads_program_spans(capsys, monkeypatch, cell, seed):
    out, ctx = _traced(capsys, monkeypatch, cell, seed)
    assert out["correct"], out["checks"]
    listed = {m["name"] for m in harness.cell_spec(cell)[3]}
    assert set(out["metrics"]) == listed - DEVICE_ONLY
    for name in listed & NEW - DEVICE_ONLY:
        assert out["metrics"][name]["value"] > 0, name
    if cell.endswith(".live.w1"):
        assert not listed & NEW
        # take to pose: a tracking step of the tiny network on the CPU
        pose = harness.load_reader("pose_latency_p50_ms.live")(ctx)
        assert 0 < pose < 1e3 * (ctx.t1 - ctx.trace_t0)
    else:
        assert listed & NEW

    spans, lo, hi = program.traced(ctx)
    ours = program.seconds(program.on_main(spans,
                                           lambda n: n == "backend.step"),
                           lo, hi)
    theirs = _harness_seconds(ctx, "backend_step", lo, hi)
    assert theirs > 0 and abs(ours - theirs) <= 0.05 * theirs

    nets = [(s[1][4:], int(s[2] * 1e9), int(s[3] * 1e9))
            for s in ctx.window_spans(tuple(
                "net." + k for k in ("encode", "inference_mono",
                                     "inference_asymmetric",
                                     "inference_symmetric")))]
    kinds = {"mast3r.encode": "encode", "mast3r.mono": "inference_mono",
             "mast3r.asym": "inference_asymmetric",
             "mast3r.sym": "inference_symmetric"}
    calls = [s for s in spans if s.name in kinds and lo <= s.t0
             and s.t1 <= hi]
    assert calls
    for s in calls:
        assert any(k == kinds[s.name] and a - 2e5 <= s.t0 <= s.t1 <= b + 2e5
                   for k, a, b in nets), s
