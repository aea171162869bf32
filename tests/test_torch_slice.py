"""The whole slice: the port's per-frame SLAM frontend against the JAX
package's, on the oracle fixture of ``tests/test_e2e_oracle.py`` (same
config, trajectory and 10 frames), under both matcher presets, plus a
short ``oracle_timing`` run with the ``TINY`` network; then the backend,
and with a retrieval database a loop-closure run (``tpu_fast``: dense edge
matcher) and the two teleport runs of ``tests/test_failure_paths.py``
(relocalization that fails forever, and the re-initialization that ends
it), each against the JAX package on replayed oracle outputs with every
stat equal and poses at the backend tolerance (2e-4).

Two tolerances, for two different sources of difference:

* frontend: the port's frontend fed the JAX oracle's geometry must give
  the JAX per-frame poses within 1e-4 and keyframe maps within 1e-4 (both
  are the same fp32 algorithm; observed ~6e-7);
* oracle: the port's own raycast oracle differs from the jitted JAX one by
  a few ulps per op (XLA contracts multiply-adds in its fused CPU code),
  which grazing rays amplify to ~5e-5 in points; through 10 chained
  keyframes that gives pose differences up to ~1.5e-4. Runs on the port's
  own oracle are held to 5e-4 on poses and 1e-3 on keyframe points, with
  keyframe counts and every stat exactly equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import config as jconfig
from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.models import mast3r as jmast3r
from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu.models import oracle_timing as jot
from mast3r_slam_tpu.slam.system import SLAMSystem as JSystem
from mast3r_slam_tpu.utils.metrics import Metrics as JMetrics
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.models import oracle_timing as tot
from mast3r_slam_tpu_torch.slam.frame import Mode
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem
from mast3r_slam_tpu_torch.utils.metrics import Metrics as TMetrics

# the suite runs several test processes side by side on a few cores;
# one intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

N_FRAMES = 10
CFG_KW = dict(img_size=(64, 96), enc_embed_dim=64, desc_dim=8,
              dtype="float32")
JCFG = jmast3r.MASt3RConfig(**CFG_KW)
TCFG = tmast3r.MASt3RConfig(**CFG_KW)
H, W = CFG_KW["img_size"]


def _gt_trajectory(n):
    Ts = [jsim3.identity()]
    for i in range(1, n):
        xi = jnp.array([0.18, 0.04 * np.sin(i / 3), 0.04,
                        0.0, 0.06, 0.008, 0.0])
        Ts.append(jsim3.mul(Ts[-1], jsim3.exp(xi)))
    return jnp.stack(Ts)


def _cfg(mod, preset):
    cfg = mod.load_config(f"configs/{preset}.yaml")
    cfg["tracking"] = dict(cfg["tracking"], match_frac_thresh=0.95)
    cfg["runtime"] = dict(cfg["runtime"], tracking_window=1)
    return cfg


def _drive(system, make_image, n, backend=False):
    poses = []
    for i in range(n):
        system.process_frame(system.make_frame(i, make_image(i)))
        while backend and system.backend_step():
            pass
        poses.append(np.asarray(system.current_frame.T_WC))
    return np.stack(poses)


@pytest.fixture(scope="module")
def fixture():
    traj = _gt_trajectory(N_FRAMES)
    jp = joracle.make_params(traj, desc_dim=CFG_KW["desc_dim"])
    tp = convert.oracle_params_from_jax(jax.device_get(jp), device="cpu")
    runs = {}
    for preset in ("base", "tpu_fast"):
        s = JSystem(jp, JCFG, _cfg(jconfig, preset), (H, W),
                    keyframe_capacity=16, edge_capacity=64,
                    model_module=joracle)
        poses = _drive(s, lambda i: joracle.make_frame_image(i, H, W),
                       N_FRAMES)
        runs[preset] = (s, poses)
    return jp, tp, runs


@pytest.fixture(scope="module")
def backend_runs(fixture):
    """The JAX systems of ``fixture`` run again with the backend."""
    jp, _, _ = fixture
    runs = {}
    for preset in ("base", "tpu_fast"):
        s = JSystem(jp, JCFG, _cfg(jconfig, preset), (H, W),
                    keyframe_capacity=16, edge_capacity=64,
                    model_module=joracle)
        poses = _drive(s, lambda i: joracle.make_frame_image(i, H, W),
                       N_FRAMES, backend=True)
        s.factor_graph.flush()
        runs[preset] = (s, poses)
    return runs


def _replay_module(jp):
    """A port model module that returns the JAX oracle's outputs (as torch
    tensors): isolates the frontend from the oracle's own rounding."""
    def j(x):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return jnp.asarray(x.numpy())

    def t(outs):
        return tuple(torch.from_numpy(np.array(a)) for a in outs)

    return types.SimpleNamespace(
        encode=lambda p, img, cfg: t(joracle.encode(jp, j(img), JCFG)),
        inference_mono=lambda p, f, pos, cfg, ds=1: t(
            joracle.inference_mono(jp, j(f), j(pos), JCFG, ds)),
        inference_asymmetric=lambda p, ff, pf, fk, pk, cfg: t(
            joracle.inference_asymmetric(jp, j(ff), j(pf), j(fk), j(pk),
                                         JCFG)),
        inference_symmetric=lambda p, fi, pi, fj, pj, cfg: {
            k: torch.from_numpy(np.array(v)) for k, v in
            joracle.inference_symmetric(jp, j(fi), j(pi), j(fj), j(pj),
                                        JCFG).items()})


def _compare(sj, pj, st, pt, pose_tol, map_tol):
    assert st.stats == sj.stats
    assert st.mode == Mode.TRACKING
    np.testing.assert_allclose(pt, pj, atol=pose_tol, rtol=0)
    k = len(st.keyframes)
    assert k == len(sj.keyframes)
    np.testing.assert_array_equal(st.keyframes.dataset_idx[:k].numpy(),
                                  np.asarray(sj.keyframes.dataset_idx[:k]))
    np.testing.assert_allclose(st.keyframes.T_WC[:k].numpy(),
                               np.asarray(sj.keyframes.T_WC[:k]),
                               atol=pose_tol, rtol=0)
    np.testing.assert_allclose(st.keyframes.X[:k].numpy(),
                               np.asarray(sj.keyframes.X[:k]), atol=map_tol,
                               rtol=0)
    np.testing.assert_allclose(st.keyframes.C[:k].numpy(),
                               np.asarray(sj.keyframes.C[:k]), atol=map_tol,
                               rtol=0)


@pytest.mark.parametrize("preset", ["base", "tpu_fast"])
def test_frontend_matches_jax_on_identical_geometry(fixture, preset):
    jp, tp, runs = fixture
    sj, pj = runs[preset]
    st = TSystem(None, TCFG, _cfg(tconfig, preset), (H, W),
                 keyframe_capacity=16, model_module=_replay_module(jp),
                 device="cpu")
    pt = _drive(st, lambda i: toracle.make_frame_image(i, H, W), N_FRAMES)
    _compare(sj, pj, st, pt, pose_tol=1e-4, map_tol=1e-4)


@pytest.mark.parametrize("preset", ["base", "tpu_fast"])
def test_port_oracle_slam_matches_jax(fixture, preset):
    jp, tp, runs = fixture
    sj, pj = runs[preset]
    st = TSystem(tp, TCFG, _cfg(tconfig, preset), (H, W),
                 keyframe_capacity=16, model_module=toracle, device="cpu")
    pt = _drive(st, lambda i: toracle.make_frame_image(i, H, W), N_FRAMES)
    _compare(sj, pj, st, pt, pose_tol=5e-4, map_tol=1e-3)


def _compare_backend(sj, st):
    fj, ft = sj.factor_graph, st.factor_graph
    ft.flush()
    st.check_invariants()
    assert not st.backend_queue and not sj.backend_queue
    assert ft.n_edges == fj.n_edges > 0
    assert int(ft.n_edges_dev) == int(fj.n_edges_dev)
    assert ft.edges_dropped == fj.edges_dropped == 0
    e = ft.n_edges
    np.testing.assert_array_equal(ft.ii[:e].numpy(), np.asarray(fj.ii[:e]))
    np.testing.assert_array_equal(ft.jj[:e].numpy(), np.asarray(fj.jj[:e]))
    same = (ft.idx_ii2jj[:e].numpy() == np.asarray(fj.idx_ii2jj[:e])).mean()
    assert same > 0.999


@pytest.mark.parametrize("preset", ["base", "tpu_fast"])
def test_backend_slice_matches_jax_on_identical_geometry(fixture,
                                                         backend_runs, preset):
    """Frontend + backend. ``tpu_fast`` leaves ``local_opt.matcher: dense``
    in place: its consecutive edges come from the tracker's match, so the
    dense matcher is never reached (reaching it raises)."""
    jp, _, _ = fixture
    sj, pj = backend_runs[preset]
    st = TSystem(None, TCFG, _cfg(tconfig, preset), (H, W),
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=_replay_module(jp), device="cpu")
    pt = _drive(st, lambda i: toracle.make_frame_image(i, H, W), N_FRAMES,
                backend=True)
    _compare(sj, pj, st, pt, pose_tol=2e-4, map_tol=1e-4)
    _compare_backend(sj, st)
    assert st.factor_graph.cfg.matcher == (
        "dense" if preset == "tpu_fast" else "iter_proj")


@pytest.mark.parametrize("preset", ["base", "tpu_fast"])
def test_backend_slice_port_oracle_matches_jax(fixture, backend_runs, preset):
    _, tp, runs = fixture
    sj, pj = backend_runs[preset]
    st = TSystem(tp, TCFG, _cfg(tconfig, preset), (H, W),
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=toracle, device="cpu")
    pt = _drive(st, lambda i: toracle.make_frame_image(i, H, W), N_FRAMES,
                backend=True)
    _compare(sj, pj, st, pt, pose_tol=1e-3, map_tol=1e-3)
    _compare_backend(sj, st)
    # the backend moved the keyframe poses away from the frontend-only run
    k = len(st.keyframes)
    front = np.asarray(runs[preset][0].keyframes.T_WC[:k])
    assert np.abs(st.keyframes.T_WC[:k].numpy() - front).max() > 1e-5


def test_port_oracle_outputs_match_jax(fixture):
    jp, tp, _ = fixture
    imgs = [joracle.make_frame_image(i, H, W) for i in (3, 5)]
    fj = [joracle.encode(jp, jnp.asarray(im)[None], JCFG) for im in imgs]
    ft = [toracle.encode(tp, torch.from_numpy(im)[None], TCFG) for im in imgs]
    for (a, pa), (b, pb) in zip(fj, ft):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
        np.testing.assert_array_equal(pb.numpy(), np.asarray(pa))
    oj = joracle.inference_asymmetric(jp, *fj[0], *fj[1], JCFG)
    ot = toracle.inference_asymmetric(tp, *ft[0], *ft[1], TCFG)
    for a, b in zip(oj, ot):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_port_oracle_symmetric_matches_jax(fixture):
    """``inference_symmetric`` of the oracle: both directions of two edges
    (atol 1e-4, the oracle tolerance above)."""
    jp, tp, _ = fixture
    ids = jnp.asarray([2, 4, 5])
    fj, pj = joracle.encode_fid(jp, ids, JCFG)
    ft, pt = toracle.encode_fid(tp, torch.tensor([2, 4, 5]), TCFG)
    oj = joracle.inference_symmetric(jp, fj[:2], pj[:2], fj[1:], pj[1:], JCFG)
    ot = toracle.inference_symmetric(tp, ft[:2], pt[:2], ft[1:], pt[1:], TCFG)
    assert sorted(ot) == sorted(oj)
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   atol=1e-4, err_msg=k)
    # Xji is view j's map in view i's frame: it is not view i's own map
    assert float((ot["Xji"] - ot["Xii"]).abs().max()) > 1e-2


def test_oracle_timing_tiny_network_slice():
    """oracle_timing runs the real TINY network on every call and returns
    the oracle's outputs exactly; the SLAM run matches JAX's."""
    n = 5
    traj = _gt_trajectory(n)
    tiny_kw = {k: getattr(jmast3r.TINY, k) for k in jmast3r.TINY._fields}
    jcfg = jmast3r.MASt3RConfig(**tiny_kw)
    tcfg = tmast3r.MASt3RConfig(**tiny_kw)
    net_j = jax.device_get(jmast3r.init_params(jax.random.PRNGKey(0), jcfg))
    net_t = tmast3r.build(tcfg, device="cpu")
    net_t.load_state_dict(convert.from_jax_params(net_j))
    orc_j = joracle.make_params(traj, desc_dim=jcfg.desc_dim)
    orc_t = convert.oracle_params_from_jax(jax.device_get(orc_j),
                                           device="cpu")
    pj_params = jot.make_params(net_j, orc_j)
    pt_params = tot.make_params(net_t, orc_t)
    h, w = jcfg.img_size
    images = [jot.make_frame_image(i, h, w) for i in range(n)]

    # the wrapper returns the oracle's outputs exactly
    img = torch.from_numpy(images[2])[None]
    f_ot, p_ot = tot.encode(pt_params, img, tcfg)
    f_o, p_o = toracle.encode_fid(orc_t, torch.tensor([2]), tcfg)
    assert torch.equal(f_ot, f_o) and torch.equal(p_ot, p_o)
    real = tot.inference_asymmetric(pt_params, f_ot, p_ot, f_ot, p_ot, tcfg)
    orc = toracle.inference_asymmetric(orc_t, f_ot, p_ot, f_ot, p_ot, tcfg)
    assert all(torch.equal(a, b) for a, b in zip(real, orc))
    sym_r = tot.inference_symmetric(pt_params, f_ot, p_ot, f_ot, p_ot, tcfg)
    sym_o = toracle.inference_symmetric(orc_t, f_ot, p_ot, f_ot, p_ot, tcfg)
    assert all(torch.equal(sym_r[k], sym_o[k]) for k in sym_o)
    # NaN from the network never reaches the oracle outputs
    nan_total = tot._total(torch.tensor([1.0, float("nan")]))
    assert torch.isfinite(nan_total)
    assert torch.equal(tot._carry(f_o, nan_total), f_o)

    cj, ct = _cfg(jconfig, "tpu_fast"), _cfg(tconfig, "tpu_fast")
    sj = JSystem(pj_params, jcfg, cj, (h, w), keyframe_capacity=8,
                 edge_capacity=16, model_module=jot)
    st = TSystem(pt_params, tcfg, ct, (h, w), keyframe_capacity=8,
                 model_module=tot, device="cpu")
    pj = _drive(sj, lambda i: images[i], n)
    pt = _drive(st, lambda i: images[i], n)
    _compare(sj, pj, st, pt, pose_tol=5e-4, map_tol=1e-3)


# -- retrieval: loop closures, relocalization, re-initialization ---------------


def _retrieval_params(seed=1, dim=CFG_KW["enc_embed_dim"], n_words=256):
    """A random retrieval head and codebook as numpy, for both packages."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {"prewhiten": {"m": np.zeros(dim, np.float32),
                          "p": np.eye(dim, dtype=np.float32)},
            "projector": {"w": f(dim, dim) / np.sqrt(dim),
                          "b": np.zeros(dim, np.float32)},
            "postwhiten": {"m": np.zeros(dim, np.float32),
                           "p": np.eye(dim, dtype=np.float32)},
            "centroids": f(n_words, dim)}
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.retrieval_params_from_jax(tree, device="cpu"))


def _compare_counts_and_poses(sj, pj, st, pt, pose_tol=2e-4):
    assert st.stats == sj.stats
    assert st.mode.name == sj.mode.name
    k = len(st.keyframes)
    assert k == len(sj.keyframes)
    np.testing.assert_array_equal(st.keyframes.dataset_idx[:k].numpy(),
                                  np.asarray(sj.keyframes.dataset_idx[:k]))
    np.testing.assert_allclose(pt, pj, atol=pose_tol, rtol=0)
    np.testing.assert_allclose(st.keyframes.T_WC[:k].numpy(),
                               np.asarray(sj.keyframes.T_WC[:k]),
                               atol=pose_tol, rtol=0)
    assert st.retrieval.kf_counter == sj.retrieval.kf_counter


@pytest.mark.parametrize("prefetch", [False, True])
def test_loop_closure_slice_matches_jax_on_identical_geometry(fixture,
                                                              prefetch):
    """``tpu_fast`` as the YAML states it (``matcher: dense``,
    ``reuse_consec_edge``, ``point_stride: 4``) with a retrieval database:
    retrieved keyframes become loop-closure edges through ``match_dense``.
    With ``prefetch`` the retrieval's device half is enqueued before each
    frame (``backend_prefetch``): the same results."""
    jp, _, _ = fixture
    jr, tr = _retrieval_params()

    def drive(system):
        poses = []
        for i in range(N_FRAMES):
            if prefetch:
                system.backend_prefetch()
            system.process_frame(system.make_frame(
                i, toracle.make_frame_image(i, H, W)))
            while system.backend_step():
                pass
            poses.append(np.asarray(system.current_frame.T_WC))
        return np.stack(poses)

    sj = JSystem(jp, JCFG, _cfg(jconfig, "tpu_fast"), (H, W),
                 retrieval_params=jr, keyframe_capacity=16, edge_capacity=64,
                 model_module=joracle)
    st = TSystem(None, TCFG, _cfg(tconfig, "tpu_fast"), (H, W),
                 retrieval_params=tr, keyframe_capacity=16, edge_capacity=64,
                 model_module=_replay_module(jp), device="cpu")
    assert st.factor_graph.cfg.matcher == "dense"
    assert st.factor_graph.query_stride == sj.factor_graph.query_stride == 4
    pj, pt = drive(sj), drive(st)
    sj.factor_graph.flush()
    assert st.stats["loop_closures"] > 0
    assert not st._retrieval_prefetch
    _compare_counts_and_poses(sj, pj, st, pt)
    _compare_backend(sj, st)
    # more edges than the consecutive ones: loop closures made it in
    assert st.factor_graph.n_edges > 2 * (st.stats["keyframes"] - 1)


def _teleport_traj(n_good, n_bad):
    """``tests/test_failure_paths.py::_teleport_traj``: smooth motion, then
    a jump to a disjoint scene region, where tracking must fail."""
    step = jnp.array([0.15, 0.0, 0.03, 0.0, 0.05, 0.0, 0.0])
    Ts = [jsim3.identity()]
    for _ in range(1, n_good):
        Ts.append(jsim3.mul(Ts[-1], jsim3.exp(step)))
    far = jsim3.exp(jnp.array([60.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]))
    Ts.append(jsim3.mul(far, Ts[-1]))
    for _ in range(1, n_bad):
        Ts.append(jsim3.mul(Ts[-1], jsim3.exp(step)))
    return jnp.stack(Ts)


@pytest.mark.parametrize("reinit_after", [0, 2])
def test_teleport_relocalization_matches_jax(reinit_after):
    """``reinit_after=0``: every frame after the jump relocalizes and fails
    (``reloc_failed`` counts them, the run ends in RELOC).
    ``reinit_after=2``: after two failures tracking restarts from the
    current frame as a fresh keyframe and the rest tracks."""
    n_good, n_bad = 4, 5
    jp = joracle.make_params(_teleport_traj(n_good, n_bad),
                             desc_dim=CFG_KW["desc_dim"])
    jr, tr = _retrieval_params()

    def cfg(mod):
        c = mod.load_config("configs/base.yaml")
        c["tracking"] = dict(c["tracking"], match_frac_thresh=0.95)
        c["reloc"] = dict(c["reloc"], reinit_after=reinit_after)
        return c

    mj, mt = JMetrics(), TMetrics()
    sj = JSystem(jp, JCFG, cfg(jconfig), (H, W), retrieval_params=jr,
                 keyframe_capacity=16, edge_capacity=64, model_module=joracle,
                 metrics=mj)
    st = TSystem(None, TCFG, cfg(tconfig), (H, W), retrieval_params=tr,
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=_replay_module(jp), device="cpu", metrics=mt)
    image = lambda i: toracle.make_frame_image(i, H, W)
    pj = _drive(sj, image, n_good + n_bad, backend=True)
    pt = _drive(st, image, n_good + n_bad, backend=True)
    _compare_counts_and_poses(sj, pj, st, pt)
    events = lambda m: [(r["event"], r["frame"]) for r in m.rows]
    assert events(mt) == events(mj)
    stats = st.stats
    assert stats["skipped"] >= 1 and stats["relocs"] == 0
    if reinit_after == 0:
        assert st.mode == Mode.RELOC
        assert stats["reloc_failed"] >= 2 and stats["frames_reloc"] >= 2
        assert stats["reinits"] == 0
        failed = [r for r in mt.rows if r["event"] == "reloc_failed"]
        assert failed[-1]["streak"] == stats["reloc_failed"]
    else:
        assert st.mode == Mode.TRACKING
        assert stats["reinits"] == 1 and stats["reloc_failed"] == 2
        assert stats["skipped"] == 1 and stats["frames_tracking"] >= 2
        assert any(r["event"] == "reinit" for r in mt.rows)
        assert len(st.keyframes) >= 3


def test_relocalization_success_matches_jax(fixture):
    """A lost frame that still sees the mapped scene relocalizes: after a
    forced RELOC the retrieved keyframes accept it (``add_factors`` with
    ``is_reloc``), it becomes a keyframe seeded with the best candidate's
    pose, and tracking resumes."""
    jp, _, _ = fixture
    jr, tr = _retrieval_params()

    def cfg(mod):
        c = _cfg(mod, "base")
        # the frame after a forced loss is a neighbour of the keyframes
        c["reloc"] = dict(c["reloc"], min_match_frac=0.05)
        return c

    sj = JSystem(jp, JCFG, cfg(jconfig), (H, W), retrieval_params=jr,
                 keyframe_capacity=16, edge_capacity=64, model_module=joracle)
    st = TSystem(None, TCFG, cfg(tconfig), (H, W), retrieval_params=tr,
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=_replay_module(jp), device="cpu")
    poses = {}
    for name, system in (("j", sj), ("t", st)):
        out = []
        for i in range(6):
            if i == 4:                    # lose tracking on purpose
                system.mode = type(system.mode).RELOC
            system.process_frame(system.make_frame(
                i, toracle.make_frame_image(i, H, W)))
            while system.backend_step():
                pass
            out.append(np.asarray(system.current_frame.T_WC))
        poses[name] = np.stack(out)
    sj.factor_graph.flush()
    assert st.stats["relocs"] == 1 and st.stats["reloc_failed"] == 0
    assert st.mode == Mode.TRACKING
    _compare_counts_and_poses(sj, poses["j"], st, poses["t"])
    _compare_backend(sj, st)


def test_left_out_parts_raise(fixture):
    """``tpu_fast_config()`` as shipped builds (the windowed frontend,
    ``tests/test_torch_window.py``); ``runtime.backend_device`` follows the
    JAX package's rule on one device (``auto`` / True: None, the run goes
    on; an index with no device behind it: ``ValueError``); the
    step-by-step tracker runs (``tests/test_torch_steps.py``)."""
    from mast3r_slam_tpu_torch.parallel.backend_device import (
        pick_backend_device)

    _, tp, _ = fixture
    cfg = tconfig.tpu_fast_config()
    shipped = TSystem(None, TCFG, cfg, (H, W), keyframe_capacity=16,
                      model_module=toracle, device="cpu")
    assert shipped.window == cfg["runtime"]["tracking_window"] == 8
    assert shipped.mode == Mode.INIT
    # an empty retrieval tree means no retrieval, as in the JAX package
    assert TSystem(None, TCFG, cfg, (H, W), retrieval_params={},
                   keyframe_capacity=4, device="cpu").retrieval is None
    for spec in ("none", "None", "", None, 0, False, "auto", True):
        assert pick_backend_device(spec, "cpu") is None
    for spec in (1, "1", -1, 2):
        with pytest.raises(ValueError,
                           match="only 1 local devices"):
            pick_backend_device(spec, "cpu")
    cfg["runtime"]["backend_device"] = 1
    with pytest.raises(ValueError, match="backend_device=1 but only 1"):
        TSystem(None, TCFG, cfg, (H, W), model_module=toracle, device="cpu")
    cfg["runtime"]["backend_device"] = "auto"
    s = TSystem(tp, TCFG, cfg, (H, W), keyframe_capacity=4,
                model_module=toracle, device="cpu")
    assert s.backend_step() is False          # nothing queued: no work
    s.reloc_pending = True          # without retrieval a relocalization fails
    assert s.backend_step() is True
    assert s.stats["reloc_failed"] == 1 and not s.reloc_pending
    s.tracker.fused = False
    for i in range(2):
        s.process_frame(s.make_frame(i, toracle.make_frame_image(i, H, W)))
    assert s.mode == Mode.TRACKING and s.stats["frames_tracking"] == 1
    assert s.tracker.last_stats["match_frac"] > 0.5
