"""The port's spans (``mast3r_slam_tpu_torch.utils.timing``) on the CPU.

* The span tree of ``SLAMSystem.run`` over a tiny oracle scan with the
  real (tiny) network, retrieval and bundle adjustment, at W = 1 and W = 8:
  each host read (``sync.*``) and BA iteration sits under the span of the
  work that makes it, spans carry the frame or keyframe they serve, and a
  solve issues ``max_iters`` ``ba.iter`` children, reads their step norms
  once and reports as ``iters`` those that ran before the stop rule.
* Nothing is recorded without a profiler or a ``recording()`` block, and
  ``span`` then returns one shared object.
* Under ``torch.profiler`` spans record by themselves, and the clock
  anchor maps them onto the profiler's clock (within 1 ms of an enclosing
  ``record_function`` range); ``ProfilerTrace`` writes them into its
  ``trace.json``.
* The profiler flag that switches recording on is where ``timing`` reads
  it, so a rename in torch fails here first.
"""

import json
import threading

import pytest
import torch

from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.models import mast3r, oracle, oracle_timing
from mast3r_slam_tpu_torch.slam import retrieval
from mast3r_slam_tpu_torch.slam.system import SLAMSystem
from mast3r_slam_tpu_torch.utils import timing

torch.set_num_threads(1)

CFG = mast3r.TINY
H, W = CFG.img_size
N_FRAMES = 26

# the span each host read and BA iteration must sit in
PARENTS = {"sync.track_stats": {"track.frame"},
           "sync.window_stats": {"track.consume"},
           "sync.edge_gate": {"fg.flush", "fg.add_factors"},
           "sync.retrieval": {"retrieval.update"},
           "sync.ba_deltas": {"ba.solve"},
           "sync.frame_upload": {"track.make_frame"},
           "sync.pose_upload": {"track.make_frame"},
           "sync.edge_upload": {"fg.add_factors"},
           "sync.pair_upload": {"fg.add_tracked_edge"},
           "ba.iter": {"ba.solve"},
           "retrieval.ivf": {"retrieval.update"},
           "mast3r.encoder": {"mast3r.encode"},
           "mast3r.decoder": {"mast3r.mono", "mast3r.asym", "mast3r.sym"},
           "mast3r.head": {"mast3r.mono", "mast3r.asym", "mast3r.sym"},
           "track.match": {"track.frame", "track.dispatch"},
           "track.gn": {"track.frame", "track.dispatch"}}
ROOTS = {"run.frame", "run.window", "backend.step", "fg.flush"}


class _Scan:
    """In-memory frames carrying their ids, at the working size."""

    img_size = W

    def __len__(self):
        return N_FRAMES

    def __getitem__(self, i):
        return float(i), oracle_timing.make_frame_image(i, H, W)


def _system(window):
    cfg = tconfig.tpu_fast_config()
    cfg["tracking"] = dict(cfg["tracking"], kf_every=4)
    cfg["runtime"] = dict(cfg["runtime"], tracking_window=window)
    cfg["single_thread"] = True
    g = torch.Generator().manual_seed(0)
    net = mast3r.init_params(CFG, g, device="cpu")
    orc = oracle.make_params(oracle.make_traj(N_FRAMES),
                             desc_dim=CFG.desc_dim, device="cpu")
    rparams = retrieval.init_retrieval_params(
        torch.Generator().manual_seed(1), backbone_dim=CFG.enc_embed_dim,
        codebook_size=256, device="cpu")
    return SLAMSystem(oracle_timing.make_params(net, orc), CFG, cfg, (H, W),
                      retrieval_params=rparams, keyframe_capacity=32,
                      edge_capacity=256, model_module=oracle_timing,
                      device="cpu")


@pytest.fixture(scope="module", params=[1, 8], ids=["w1", "w8"])
def traced_run(request):
    system = _system(request.param)
    with timing.recording() as rec:
        stats = system.run(_Scan())
    return request.param, stats, rec.spans


def _root(s):
    while s.parent is not None:
        s = s.parent
    return s


def _step_of(s):
    """The ``backend.step`` span ``s`` is or lies in, or None."""
    while s is not None and s.name != "backend.step":
        s = s.parent
    return s


def _names(spans):
    return {s.name for s in spans}


def test_span_tree(traced_run):
    window, stats, spans = traced_run
    names = _names(spans)
    assert stats["keyframes"] >= 4 and stats["skipped"] == 0
    main = threading.main_thread().native_id
    for s in spans:
        assert s.t1 is not None and s.t0 <= s.t1 and s.thread == main, s
        if s.parent is not None:
            assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1, s
        else:
            assert s.name in ROOTS, s
        if s.name in PARENTS:
            assert s.parent is not None, s
            assert s.parent.name in PARENTS[s.name], (s, s.parent)
        step = _step_of(s)
        if step is not None:
            # the backend's work serves the keyframe at the queue's head
            assert s.kf == step.kf and (s.kf is not None
                                        or not step.attrs["did"]), s
        elif _root(s).name in ("run.frame", "run.window"):
            assert s.frame is not None and s.kf is None, s
    solves = [s for s in spans if s.name == "ba.solve"]
    assert solves
    max_iters = tconfig.make_ba_config(tconfig.tpu_fast_config()).max_iters
    for sv in solves:
        iters = [s for s in spans if s.name == "ba.iter" and s.parent is sv]
        assert len(iters) == max_iters
        assert 0 < sv.attrs["iters"] <= max_iters
        assert sv.attrs["backend"] == "dense"
        assert sv.kf is not None and sv.attrs["n_kf"] >= 2
        assert [s.name for s in spans if s.parent is sv and s.name.startswith(
            "sync.")] == ["sync.ba_deltas"]
        assert not any(s.name.startswith("sync.") for s in spans
                       if s.parent in iters)
    assert {"retrieval.update", "retrieval.ivf", "sync.retrieval",
            "sync.frame_upload", "sync.edge_upload",
            "backend.step", "fg.add_factors", "mast3r.encode",
            "mast3r.encoder", "mast3r.asym", "mast3r.decoder", "mast3r.head",
            "oracle", "oracle.carry", "track.match", "track.gn",
            "run.load"} <= names
    frames = [s for s in spans if s.name in ("run.frame", "run.window")]
    assert sum(s.attrs["frames"] for s in frames) == N_FRAMES
    if window == 1:
        assert "run.window" not in names
        tracked = [s for s in spans if s.name == "sync.track_stats"]
        assert len(tracked) == stats["frames_tracking"]
        assert all(s.frame == s.parent.frame for s in tracked)
    else:
        wins = [s for s in spans if s.name == "run.window"]
        assert wins and all(s.attrs["n"] == window for s in wins)
        assert {"track.dispatch", "track.consume",
                "sync.window_stats"} <= names
        # the per-frame path takes the first frame and the scan's tail
        assert all(_root(s).name == "run.frame" for s in spans
                   if s.name == "sync.track_stats")
        reads = [s for s in spans if s.name == "sync.window_stats"]
        assert [_root(s).frame for s in reads] == [s.frame for s in wins]


def test_backend_step_spans_carry_the_keyframe(traced_run):
    _, stats, spans = traced_run
    steps = [s for s in spans if s.name == "backend.step"]
    did = [s for s in steps if s.attrs["did"]]
    assert len(did) == stats["keyframes"]
    assert [s.kf for s in did] == list(range(stats["keyframes"]))
    assert all(not s.attrs["reloc"] for s in steps)
    assert all(s.kf is None for s in steps if not s.attrs["did"])


def test_nothing_recorded_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    before = len(timing.spans())
    sp = timing.span("x", frame=1)
    assert sp is timing.span("y") and sp is timing._OFF
    with sp as inner:
        inner.set("iters", 3)
    a = timing.host_read("test", torch.arange(3))
    assert a.tolist() == [0, 1, 2]
    system = _system(1)
    system.process_frame(system.make_frame(0, _Scan()[0][1]))
    while system.backend_step():
        pass
    assert len(timing.spans()) == before


def test_threads_nest_apart():
    out = {}

    def other():
        with timing.span("b") as b:
            out["b"] = b

    with timing.recording() as rec:
        with timing.span("a", kf=3) as a:
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            with timing.span("c") as c:
                pass
    assert not t.is_alive()
    assert out["b"].parent is None and out["b"].kf is None
    assert c.parent is a and c.kf == 3
    assert out["b"].thread != a.thread
    assert {s.name for s in rec.spans} == {"a", "b", "c"}


def test_profiler_flag_switches_recording():
    """``timing`` reads torch's own flag; a rename in torch fails here."""
    from torch.profiler import ProfilerActivity, profile

    assert timing._profiler is torch.autograd.profiler
    assert torch.autograd.profiler._is_profiler_enabled is False
    n = len(timing.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        with timing.span("under.profiler"):
            torch.ones(4).sum()
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert [s.name for s in timing.spans()[n:]] == ["under.profiler"]


def test_anchor_maps_onto_profile():
    """A span inside a ``record_function`` range, mapped through the
    anchor, lies inside the range on the profiler's clock within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    inner = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with record_function(f"outer{k}"):
                with timing.span("inner") as sp:
                    (torch.ones(256, 256) @ torch.ones(256, 256)).sum()
                inner.append(sp)
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("outer")}
    for k, sp in enumerate(inner):
        lo, hi = ranges[f"outer{k}"]
        a, b = timing.to_unix_ns(sp.t0), timing.to_unix_ns(sp.t1)
        assert lo - 1e6 <= a <= b <= hi + 1e6, (k, a - lo, hi - b)
        assert abs((b - a) - (sp.t1 - sp.t0)) < 1e3


def test_profiler_trace_holds_program_spans(tmp_path):
    with timing.ProfilerTrace(tmp_path) as tr:
        with timing.span("outer.work", frame=7):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
            timing.host_read("probe", torch.ones(2))
    doc = json.loads((tmp_path / "trace.json").read_text())
    ev = doc["traceEvents"]
    ours = {e["name"]: e for e in ev if e.get("cat") == "program"}
    assert set(ours) == {"outer.work", "sync.probe"}
    assert ours["sync.probe"]["args"] == {"frame": 7}
    outer, probe = ours["outer.work"], ours["sync.probe"]
    assert outer["ts"] <= probe["ts"]
    assert probe["ts"] + probe["dur"] <= outer["ts"] + outer["dur"]
    mm = [e for e in ev if e.get("ph") == "X" and e.get("name") == "aten::mm"]
    assert mm and all(outer["ts"] - 1e3 <= e["ts"]
                      <= outer["ts"] + outer["dur"] + 1e3 for e in mm)
    assert any("mm" in e.key for e in tr.prof.key_averages())
