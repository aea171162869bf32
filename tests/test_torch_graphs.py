"""CUDA graphs of the network's inference passes (``models/graphs.py``).

On the CPU: ``encode``, ``inference_mono``, ``inference_asymmetric`` and
``inference_symmetric`` give bit for bit what the eager bodies
(``encode_body``, ``decode_pair_body``) give, with grad on and off; no
graph is made, and the outer span reads ``graph=eager``.

On the GPU (marker ``cuda``; ``python -m pytest tests/test_torch_graphs.py
--noconftest``): every kind replays bit for bit what the eager call gives,
at the benchmark cells' batches and at both configurations' head dtypes; a
key's first call is eager, its second captures, its third replays; a
call's outputs survive the next replay; two graphs sharing a pool replay
in either order; a new module captures after the last one died; each
replay adds the launches of ``rope_qk`` and ``conv2d_3xtf32`` that the
capture recorded; two threads on two streams; weights loaded in place after
capture show in the next replay; a profiler started after the capture sees
the replayed kernels. Replays equal the eager call exactly: the graph runs
the same kernels on the same inputs.

The backend's graphs, on the GPU: a bundle adjustment replayed from one
graph of its iteration equals the same loop called eagerly (poses,
iterations, step norms) at the cells' map size, stride 4 and 1, with the
stop rule firing and not, also as a fresh thread's first solve; the edge
chain after the decode replayed equals its eager body
for proposals of 1-4 edges, clamped appends and across a capacity doubling.
"""

import threading

import pytest
import torch
from torch.utils._pytree import tree_flatten

from mast3r_slam_tpu_torch.models import graphs, mast3r
from mast3r_slam_tpu_torch.ops import _kernels
from mast3r_slam_tpu_torch.utils import timing

KINDS = ("encode", "mono", "asym", "sym")
SPAN = {"encode": "mast3r.encode", "mono": "mast3r.mono",
        "asym": "mast3r.asym", "sym": "mast3r.sym"}
# a kind's batches in the benchmark's cells: W = 8 and W = 1 encodes, one
# tracked frame, edge batches of 1-4 (retrieval k = 3 plus the consecutive
# edge)
CELL_BATCHES = {"encode": (1, 8), "mono": (1,), "asym": (1,),
                "sym": (1, 2, 3, 4)}


def _model(dev, cfg, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return mast3r.init_params(cfg, g, device=dev)


def _inputs(kind, model, cfg, b, seed):
    """The call's tensor inputs: frames for ``encode``, else the features
    and positions of two batches of ``b`` frames."""
    h, w = cfg.img_size
    g = torch.Generator().manual_seed(seed)
    dev = next(model.parameters()).device
    img = torch.randint(0, 256, (2 * b, h, w, 3), generator=g,
                        dtype=torch.uint8).to(dev)
    if kind == "encode":
        return (img[:b],)
    with torch.no_grad():
        f, p = mast3r.encode_body(model, img, cfg)
    return f[:b], p[:b], f[b:], p[b:]


def _call(kind, model, cfg, x):
    if kind == "encode":
        return mast3r.encode(model, *x, cfg)
    if kind == "mono":
        return mast3r.inference_mono(model, *x[:2], cfg)
    if kind == "asym":
        return mast3r.inference_asymmetric(model, *x, cfg)
    return mast3r.inference_symmetric(model, *x, cfg)


@torch.no_grad()
def _eager(kind, model, cfg, x):
    """What the call gives from the eager bodies."""
    if kind == "encode":
        return mast3r.encode_body(model, *x, cfg)
    if kind == "mono":
        f, p = x[:2]
        res1, _ = mast3r.decode_pair_body(model, f, p, f, p, cfg)
        b = f.shape[0]
        return (res1["pts3d"].reshape(b, -1, 3),
                res1["conf"][..., None].reshape(b, -1, 1))
    if kind == "asym":
        res1, res2 = mast3r.decode_pair_body(model, *x, cfg)
        return tuple(torch.cat([res1[k], res2[k]])
                     for k in ("pts3d", "conf", "desc", "desc_conf"))
    return mast3r.symmetric_from_decode(mast3r.decode_pair_body, model, *x,
                                        cfg)


def _assert_same(got, want):
    got, spec = tree_flatten(got)
    want, spec_w = tree_flatten(want)
    assert spec == spec_w
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _modes(rec, kind):
    return [s.attrs["graph"] for s in rec.spans if s.name == SPAN[kind]]


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_calls_are_eager_and_bit_equal(kind, grad):
    cfg = mast3r.TINY
    model = _model("cpu", cfg)
    x = _inputs(kind, model, cfg, 2, seed=1)
    with torch.set_grad_enabled(grad), timing.recording() as rec:
        got = _call(kind, model, cfg, x)
    _assert_same(got, _eager(kind, model, cfg, x))
    assert graphs.entries(model) == {}
    assert _modes(rec, kind) == ["eager"]
    assert not [s for s in rec.spans if s.name == "mast3r.capture"]


# -- on the GPU -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _kernels.build_all()
    return torch.device("cuda")


VITL = mast3r.MASt3RConfig()           # ViT-L at 384 x 512, bf16 trunk
TINY = mast3r.TINY


@pytest.mark.cuda
@pytest.mark.parametrize("head_dtype", ["bfloat16", "float32"])
def test_replay_bit_equal_at_cells_batches(cuda, head_dtype):
    cfg = VITL._replace(head_dtype=head_dtype)
    model = _model(cuda, cfg)
    for kind, batches in CELL_BATCHES.items():
        for b in batches:
            x = _inputs(kind, model, cfg, b, seed=b)
            want = _eager(kind, model, cfg, x)
            with timing.recording() as rec:
                outs = [_call(kind, model, cfg, x) for _ in range(3)]
            # mono and asym at one batch share the decode's graph
            assert _modes(rec, kind)[-1] == "replay"
            for got in outs:
                _assert_same(got, want)
            # new inputs reach the graph
            y = _inputs(kind, model, cfg, b, seed=100 + b)
            _assert_same(_call(kind, model, cfg, y),
                         _eager(kind, model, cfg, y))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_first_call_eager_second_captures_third_replays(cuda, kind):
    model = _model(cuda, TINY)
    x = _inputs(kind, model, TINY, 2, seed=3)
    with timing.recording() as rec:
        for _ in range(3):
            _call(kind, model, TINY, x)
    assert _modes(rec, kind) == ["eager", "capture", "replay"]
    caps = [s for s in rec.spans if s.name == "mast3r.capture"]
    assert len(caps) == 1 and caps[0].parent.name == SPAN[kind]
    assert caps[0].attrs["batch"] == (4 if kind == "sym" else 2)
    # a replay runs none of the eager pass's inner spans
    outer = [s for s in rec.spans if s.name == SPAN[kind]]
    inner = {s.parent for s in rec.spans
             if s.name in ("mast3r.encoder", "mast3r.decoder")}
    assert outer[2] not in inner and outer[0] in inner
    (g,) = graphs.entries(model).values()
    assert isinstance(g, graphs.Graph)


@pytest.mark.cuda
def test_a_new_module_captures_after_the_last_one_died(cuda):
    """A module's graphs die with it; the stream's pool stays open for the
    next module's captures."""
    import gc

    for seed in range(2):
        model = _model(cuda, TINY, seed=seed)
        x = _inputs("asym", model, TINY, 1, seed=30 + seed)
        with timing.recording() as rec:
            outs = [_call("asym", model, TINY, x) for _ in range(3)]
        assert _modes(rec, "asym") == ["eager", "capture", "replay"]
        for got in outs:
            _assert_same(got, _eager("asym", model, TINY, x))
        del model, outs
        gc.collect()


@pytest.mark.cuda
def test_outputs_survive_the_next_replay(cuda):
    model = _model(cuda, TINY)
    xa = _inputs("asym", model, TINY, 1, seed=4)
    xb = _inputs("asym", model, TINY, 1, seed=5)
    for _ in range(2):
        _call("asym", model, TINY, xa)
    out_a = _call("asym", model, TINY, xa)
    kept = [t.clone() for t in out_a]
    out_b = _call("asym", model, TINY, xb)
    _assert_same(out_a, tuple(kept))
    assert not torch.equal(out_a[0], out_b[0])


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["ab", "ba"])
def test_two_graphs_share_a_pool_in_either_order(cuda, order):
    model = _model(cuda, TINY)
    kinds = {"a": ("asym", 1), "b": ("sym", 2)}
    for kind, b in kinds.values():
        x = _inputs(kind, model, TINY, b, seed=6)
        for _ in range(2):
            _call(kind, model, TINY, x)
    assert len(graphs.entries(model)) == 2
    for rnd in range(3):
        for k in order:
            kind, b = kinds[k]
            x = _inputs(kind, model, TINY, b, seed=10 * rnd + ord(k))
            with timing.recording() as rec:
                got = _call(kind, model, TINY, x)
            assert _modes(rec, kind) == ["replay"]
            _assert_same(got, _eager(kind, model, TINY, x))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["encode", "asym"])
def test_replay_counts_the_captured_launches(cuda, kind):
    from mast3r_slam_tpu_torch.utils import kernel_cases

    model = _model(cuda, TINY)
    x = _inputs(kind, model, TINY, 1, seed=7)
    per_call = []
    names = ("rope_qk", "conv2d_3xtf32")
    for _ in range(4):
        n0 = [_kernels.LAUNCHES[k] for k in names]
        _call(kind, model, TINY, x)
        torch.cuda.synchronize()
        per_call.append(tuple(_kernels.LAUNCHES[k] - n for k, n in
                              zip(names, n0)))
    attn = TINY.enc_depth if kind == "encode" else 4 * TINY.dec_depth
    # TINY's heads are fp32: every conv of both head_forwards
    convs = 0 if kind == "encode" else 2 * len(
        kernel_cases.dpt_conv_shapes(TINY, 1))
    assert per_call == [(attn, convs)] * 4
    (g,) = graphs.entries(model).values()
    assert g.launches == {k: n for k, n in zip(names, (attn, convs)) if n}


@pytest.mark.cuda
def test_two_threads_on_two_streams(cuda):
    model = _model(cuda, TINY)
    xs = [_inputs("asym", model, TINY, 1, seed=20 + i) for i in range(2)]
    wants = [_eager("asym", model, TINY, x) for x in xs]
    torch.cuda.synchronize()
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def work(i):
        try:
            s = torch.cuda.Stream()
            start.wait(timeout=60)
            with torch.cuda.stream(s):
                outs = [_call("asym", model, TINY, xs[i]) for _ in range(5)]
            s.synchronize()
            got[i] = outs
        except Exception as e:   # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for outs, want in zip(got, wants):
        for out in outs:
            _assert_same(out, want)
    keys = graphs.entries(model)
    assert len(keys) == 2 and all(isinstance(g, graphs.Graph)
                                  for g in keys.values())


@pytest.mark.cuda
def test_weights_loaded_in_place_show_in_the_next_replay(cuda):
    model = _model(cuda, TINY, seed=0)
    other = _model(cuda, TINY, seed=1)
    x = _inputs("asym", model, TINY, 1, seed=8)
    for _ in range(3):
        before = _call("asym", model, TINY, x)
    model.load_state_dict(other.state_dict())
    with timing.recording() as rec:
        after = _call("asym", model, TINY, x)
    assert _modes(rec, "asym") == ["replay"]
    _assert_same(after, _eager("asym", other, TINY, x))
    assert not torch.equal(after[0], before[0])


@pytest.mark.cuda
def test_profiler_started_after_capture_sees_the_replay(cuda):
    """The benchmark starts its profiler after the warm scan has captured
    the graphs; the trace must still list every replayed kernel."""
    from torch.profiler import ProfilerActivity, profile

    model = _model(cuda, TINY)
    x = _inputs("encode", model, TINY, 1, seed=9)
    for _ in range(2):
        _call("encode", model, TINY, x)
    torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    for _ in range(2):      # the profiler started twice
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _call("encode", model, TINY, x)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda_type]
        assert sum("rope_qk" in n for n in names) == TINY.enc_depth, names
        assert len(names) > 10 * TINY.enc_depth


# -- the backend's graphs: a BA solve, the edge chain ------------------------


def _ba_cell_graph(dev, n_kf=100, P=384 * 512, seed=0):
    """A chain of ``n_kf`` keyframes over one world at the cells' map size,
    edges to the 1st, 2nd, 4th and 8th next keyframe both ways (770 edges
    at 100 keyframes), noisy poses: the solver's arguments."""
    from mast3r_slam_tpu_torch.lie import sim3

    g = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    pts_w = randn(P, 3) + torch.tensor([0.0, 0.0, 4.0], device=dev)
    T_true = [sim3.identity(device=dev)]
    for _ in range(1, n_kf):
        T_true.append(sim3.mul(T_true[-1], sim3.exp(0.02 * randn(7))))
    T_true = torch.stack(T_true)
    Xs = sim3.act(sim3.inv(T_true)[:, None], pts_w[None])
    Cs = 1.0 + 4.0 * torch.rand((n_kf, P), generator=g, device=dev)
    pairs = [(i, i + d) for d in (1, 2, 4, 8) for i in range(n_kf - d)]
    ii = torch.tensor([p for a, b in pairs for p in (a, b)],
                      dtype=torch.int32, device=dev)
    jj = torch.tensor([p for a, b in pairs for p in (b, a)],
                      dtype=torch.int32, device=dev)
    E = ii.shape[0]
    idx = torch.arange(P, dtype=torch.int32, device=dev).expand(
        E, P).contiguous()
    valid = torch.rand((E, P), generator=g, device=dev) > 0.1
    Q = 5.0 * torch.rand((E, P), generator=g, device=dev)
    mask = torch.ones((E,), device=dev)
    noise = 0.01 * randn(n_kf, 7)
    noise[0] = 0.0
    return (sim3.retr(T_true, noise), Xs, Cs, ii, jj, idx, valid, Q, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["never", "third"])
@pytest.mark.parametrize("stride", [4, 1])
def test_ba_solve_replay_bit_equal_to_the_eager_loop(cuda, stride, rule):
    """A solve replayed from one graph of its iteration against the same
    loop called eagerly (``ba._gauss_newton(..., replay=False)``, the path
    of the CPU and the sharded solvers): poses, iterations and norms bit
    for bit, at the cells' map size with ~100 keyframes and ~800 edges; the
    rule that never fires (the cells' ``delta_norm``) and one that fires
    at the third iteration. The solve's spans: one ``ba.iter`` a replay
    issued, one capture, one read of the norms."""
    from mast3r_slam_tpu_torch.slam import ba

    args = _ba_cell_graph(cuda)
    n_kf = args[0].shape[0]
    cfg = ba.BAConfig(max_iters=10, point_stride=stride)
    eager = lambda c: ba._gauss_newton("rays", *args, n_kf, c, replay=False)
    with torch.no_grad():
        if rule == "third":
            d = eager(cfg._replace(delta_norm=0.0)).deltas
            assert d[2] < min(d[0], d[1])
            cfg = cfg._replace(
                delta_norm=float((d[2] * min(d[0], d[1])) ** 0.5))
        want = eager(cfg)
    assert want.graph == "eager"
    assert want.iters == (3 if rule == "third" else 10)
    n0 = _kernels.LAUNCHES["ba_edge_terms"]
    with timing.recording() as rec:
        res = ba.gauss_newton_rays(*args, n_kf, cfg)
    torch.cuda.synchronize()
    assert res.graph == "capture"
    assert res.iters == want.iters and res.deltas == want.deltas
    torch.testing.assert_close(res.T_WC, want.T_WC, rtol=0, atol=0)
    names = [s.name for s in rec.spans]
    assert names.count("ba.iter") == cfg.max_iters
    assert names.count("ba.capture") == 1
    assert names.count("sync.ba_deltas") == 1
    assert _kernels.LAUNCHES["ba_edge_terms"] - n0 == cfg.max_iters


@pytest.mark.cuda
def test_first_ba_solve_of_a_thread_captures(cuda):
    """A thread's first solve captures at once (``graphs.capture`` makes
    the thread's cuBLAS and cuSOLVER handles first): in a fresh thread, the
    replayed solve equals the eager loop's bits."""
    from mast3r_slam_tpu_torch.slam import ba

    args = _ba_cell_graph(cuda)
    n_kf = args[0].shape[0]
    cfg = ba.BAConfig(max_iters=10, point_stride=4)
    out = {}

    def first():
        out["res"] = ba.gauss_newton_rays(*args, n_kf, cfg)
        torch.cuda.synchronize()

    t = threading.Thread(target=first)
    t.start()
    t.join()
    with torch.no_grad():
        want = ba._gauss_newton("rays", *args, n_kf, cfg, replay=False)
    res = out["res"]
    assert res.graph == "capture" and res.deltas == want.deltas
    torch.testing.assert_close(res.T_WC, want.T_WC, rtol=0, atol=0)


def _chain_graph(dev, matcher, capacity, n_kf=5):
    """A factor graph at the cells' map size on the oracle (the benchmark's
    geometry): ``n_kf`` keyframes, ``matcher`` as the configuration's
    (dense at point stride 4, tpu_fast's; iter_proj at stride 1, base's)."""
    from mast3r_slam_tpu_torch.config import (BAConfig, FactorGraphConfig,
                                              MatchingConfig)
    from mast3r_slam_tpu_torch.models import oracle
    from mast3r_slam_tpu_torch.slam import factor_graph as fgm
    from mast3r_slam_tpu_torch.slam.frame import KeyframeStore

    cfg = VITL._replace(desc_dim=24)
    h, w = cfg.img_size
    params = oracle.make_params(oracle.make_traj(n_kf), desc_dim=24,
                                device=dev)
    kfs = KeyframeStore(8, h * w, cfg.num_patches, cfg.enc_embed_dim,
                        (h, w), device=dev)
    feat, pos = oracle.encode_fid(params, torch.arange(n_kf, device=dev),
                                  cfg)
    kfs.feat[:n_kf] = feat.to(kfs.feat.dtype)
    kfs.pos[:n_kf] = pos
    kfs.n_size = n_kf
    stride = 4 if matcher == "dense" else 1
    mcfg = (MatchingConfig(radius=1, dilation_max=1) if matcher == "dense"
            else MatchingConfig(radius=3, dilation_max=5))
    return fgm, fgm.FactorGraph(
        params, cfg, kfs,
        FactorGraphConfig(edge_capacity=capacity, matcher=matcher),
        BAConfig(point_stride=stride), mcfg, model_module=oracle)


def _chain(fgm, fg, bufs, ii, jj, e0, owner):
    dev = fg.device
    ii_a = torch.tensor(ii, device=dev)
    jj_a = torch.tensor(jj, device=dev)
    with timing.recording() as rec, timing.span("fg.add_factors") as sp:
        out = fgm._add_factors_body(
            bufs, fg.params, fg.frames.feat, fg.frames.pos, ii_a, jj_a,
            ii_a == jj_a - 1, torch.tensor(e0, dtype=torch.int32,
                                           device=dev), 0.1, False,
            float(fg.cfg.Q_conf), fg.model_cfg, fg.mcfg, fg.downsample,
            fg.cfg.matcher, fg.model_mod, fg.query_stride, owner=owner,
            span=sp)
    (mode,) = [(s.attrs or {}).get("graph") for s in rec.spans
               if s.name == "fg.add_factors"]
    return out, mode


# proposals of nb = 1-4 (retrieval k = 3 and the consecutive edge), each
# three times (eager, capture, replay), larger and smaller in turn
CHAIN_PROPOSALS = [([3], [4]), ([0, 3], [4, 4]), ([0, 1, 3], [4, 4, 4]),
                   ([0, 1, 2, 3], [4, 4, 4, 4]), ([1, 3], [4, 4])]


@pytest.mark.cuda
@pytest.mark.parametrize("matcher", ["dense", "iter_proj"])
def test_edge_chain_replay_bit_equal_to_its_eager_body(cuda, matcher):
    """The edge chain after the decode (match, gate, append) replayed from
    its graph against the same body run eagerly on a copy of the edge
    buffers: buffers, fractions and the device count bit for bit, for
    proposals of 1-4 edges, appends clamped at the capacity, and across a
    capacity doubling (new buffers, new graphs)."""
    fgm, fg = _chain_graph(cuda, matcher, capacity=16)
    for rnd in range(2):
        if rnd:
            assert fg.ensure_capacity(2 * fg.capacity)
            assert graphs.entries(fg) == {}
        cap = fg.capacity
        for ii, jj in CHAIN_PROPOSALS:
            modes = []
            for e0 in (0, 6, cap - 2 * len(ii) + 1):
                ref = tuple(b.clone() for b in fg._bufs)
                want, _ = _chain(fgm, fg, ref, ii, jj, e0, None)
                got, mode = _chain(fgm, fg, fg._bufs, ii, jj, e0, fg)
                modes.append(mode)
                _assert_same(got, want)
                # the rows past the capacity: the sentinel that dropped
                # rows go to, in no set order
                _assert_same([b[:-1] for b in fg._bufs],
                             [b[:-1] for b in ref])
            assert modes[-1] == "replay", modes
        assert any(isinstance(g, graphs.Graph)
                   for g in graphs.entries(fg).values())
    # the factor graph's own calls: eager, capture, replay
    fg2 = _chain_graph(cuda, matcher, capacity=64)[1]
    with timing.recording() as rec:
        for _ in range(3):
            fg2.add_factors([2, 3], [4, 4], 0.1, defer=True)
    assert [s.attrs["graph"] for s in rec.spans
            if s.name == "fg.add_factors"] == ["eager", "capture", "replay"]
    fg2.flush()
    assert fg2.n_edges == int(fg2.n_edges_dev) > 0
