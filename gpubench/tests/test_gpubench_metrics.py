"""Each per-layer reader on a synthetic recording."""

import math

import pytest

from gpubench import harness, trace
from gpubench.reference import work
from gpubench.tests.tiny import TINY

M = dict(TINY, patch_size=16, mlp_ratio=4, rope_base=100.0)


class Ctx:
    def __init__(self, device=None, window=(0.0, 1.0)):
        self.m = M
        self.seconds = 2.0
        self.t0, self.t1 = 10.0, 12.0
        self.calls = [("window", "encode", 2, 10.1, 10.2),
                      ("window", "inference_asymmetric", 1, 10.2, 10.3),
                      ("window", "encode", 1, 11.5, 11.6),
                      ("setup", "encode", 8, 1.0, 2.0)]
        self.trace_t0 = 11.5
        self.setup_s = 17.5
        # (scan, frame, due, taken, done): closed loop (no due), one done
        # after the close
        self.frames = [(0, i, None, 10.0 + 0.1 * i, 10.05 + 0.1 * i)
                       for i in range(25)]
        self.spans = [("window", "backend_step", 10.5, 10.9, {"did": True}),
                      ("window", "backend_step", 11.8, 12.4, {"did": False}),
                      ("window", "make_frame", 10.0, 10.1, {}),
                      ("window", "process_frame", 10.1, 10.4, {}),
                      ("setup", "backend_step", 1.0, 5.0, {"did": True})]
        self.device = device
        self.window_s = window[1] - window[0]
        self.busy_s = (trace.busy_and_gaps(device, *window)[0]
                       if device else 0.0)
        self.notes = []

    def note(self, msg):
        self.notes.append(msg)

    def window_spans(self, names):
        return [s for s in self.spans if s[0] == "window" and s[1] in names]

    def traced_calls(self):
        return [c for c in self.calls
                if c[0] == "window" and c[3] >= self.trace_t0]

    def span_seconds(self, name):
        sp = self.window_spans((name,))
        return sum(max(0.0, min(s[3], self.t1) - max(s[2], self.t0))
                   for s in sp) or None


def read(name, ctx):
    return harness.load_reader(name)(ctx)


def test_mfu():
    flops = (work.call_flops(M, "encode", 2) + work.call_flops(M, "encode", 1)
             + work.call_flops(M, "inference_asymmetric", 1))
    assert math.isclose(read("mfu.scan", Ctx()),
                        100 * flops / 2.0 / work.PEAK_BF16_FLOPS)


def test_backend_share_clips_to_window():
    # 0.4 s inside, then 0.2 of the 0.6 s span before the close
    assert math.isclose(read("backend_share.scan", Ctx()), 100 * 0.6 / 2.0)


def test_end_to_end_readers():
    ctx = Ctx()
    # frames 0-19 done by the close at 12.0, frame 20 at 12.05 is not
    assert math.isclose(read("fps", ctx), 20 / 2.0)
    assert read("frame_latency_p95_ms", ctx) is None
    ctx.frames = [(0, i, 10.0 + 0.1 * i, 0.0, 10.0 + 0.1 * i + 0.001 * i)
                  for i in range(101)]
    assert math.isclose(read("frame_latency_p95_ms", ctx), 95.0)
    assert read("setup_s", ctx) == 17.5
    ctx.frames = []
    assert read("fps", ctx) is None


def test_live_readers():
    assert math.isclose(read("tracking_ms_per_frame.live", Ctx()), 400.0)
    assert math.isclose(read("backend_ms_per_kf.live", Ctx()), 400.0)


def test_device_idle():
    dev = [("k1", 0.0, 0.25), ("k2", 0.2, 0.5), ("memcpy", 0.75, 1.0)]
    assert math.isclose(read("device_idle.scan", Ctx(dev)), 25.0)
    assert read("device_idle.scan", Ctx()) is None


def test_rope_roofline():
    (n, per), = work.rope_launches(M, "encode", 1)
    dev = [("rope_qk_kernel", 0.01 * i, 0.01 * i + 0.001) for i in range(n)]
    got = read("roofline.rope_qk.scan", Ctx(dev))
    assert math.isclose(got, 100 * n * per / work.PEAK_HBM_BYTES
                        / (n * 0.001), rel_tol=1e-9)
    # a launch the calls do not account for: nothing is reported
    ctx = Ctx(dev + [("rope_qk_kernel", 0.9, 0.91)])
    assert read("roofline.rope_qk.scan", ctx) is None and ctx.notes


def test_readers_return_nothing_without_data():
    ctx = Ctx()
    ctx.calls, ctx.spans = [], []
    for name in ("mfu.scan", "backend_share.scan",
                 "tracking_ms_per_frame.live", "backend_ms_per_kf.live",
                 "roofline.rope_qk.scan", "device_idle.scan"):
        assert read(name, ctx) is None


def test_breakdown():
    dev = [("a", 0.0, 0.3), ("b", 0.5, 0.6), ("a", 0.8, 0.9)]
    ranges = [("make_frame", 0.25, 0.55), ("backend_step", 0.6, 1.0),
              ("run", 0.0, 1.0)]
    bd = trace.breakdown(dev, ranges, 0.0, 1.0)
    assert bd["device_ops"][0] == ["a", pytest.approx(0.4)]
    gaps = dict(bd["idle_gaps"])
    assert gaps["make_frame"] == pytest.approx(0.2)
    assert gaps["backend_step"] == pytest.approx(0.3)
