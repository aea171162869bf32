"""The whole slice: the port's per-frame SLAM frontend against the JAX
package's, on the oracle fixture of ``tests/test_e2e_oracle.py`` (same
config, trajectory and 10 frames), under both matcher presets, plus a
short ``oracle_timing`` run with the ``TINY`` network.

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
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.models import oracle_timing as tot
from mast3r_slam_tpu_torch.slam.frame import Mode
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem

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


def test_left_out_parts_raise():
    cfg = tconfig.tpu_fast_config()
    with pytest.raises(NotImplementedError, match="tracking_window"):
        TSystem(None, TCFG, cfg, (H, W), model_module=toracle, device="cpu")
    cfg["runtime"]["tracking_window"] = 1
    with pytest.raises(NotImplementedError):
        TSystem(None, TCFG, cfg, (H, W), retrieval_params={}, device="cpu")
    cfg["runtime"]["backend_device"] = 1
    with pytest.raises(NotImplementedError, match="backend_device"):
        TSystem(None, TCFG, cfg, (H, W), model_module=toracle, device="cpu")
    cfg["runtime"]["backend_device"] = "none"
    s = TSystem(None, TCFG, cfg, (H, W), keyframe_capacity=4,
                model_module=toracle, device="cpu")
    assert s.backend_step() is False          # nothing queued: no work
    s.reloc_pending = True                    # relocalization needs retrieval
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.backend_step()
    with pytest.raises(NotImplementedError):
        s.run(None)
    s.tracker.fused = False
    with pytest.raises(NotImplementedError):
        s.tracker.track(None)
