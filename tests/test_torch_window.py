"""The port's windowed frontend (``runtime.tracking_window`` W > 1).

* Against the port's own per-frame path on the oracle, with the backend
  off, as ``tests/test_window.py`` holds the JAX package's (:68, :100,
  :126): the same keyframe ids and backend queue, keyframe poses within
  1e-5, maps within 1e-4, equal ``N``; a skip mid-window halts the chain
  and leaves the same state as per-frame stepping; the dense backend
  matcher runs behind windows.
* Against the JAX package at W = 4 on the JAX oracle's replayed outputs,
  driven as ``run()`` drives a window (retrieval prefetch, dispatch, the
  backend drained, consume): every stat equal, poses within 5e-4 (the
  backend tolerance of ``tests/test_torch_run.py``).
* ``tpu_fast_config()`` as shipped (W = 8) through ``run()`` on PNG frames:
  the window branch is taken and the run gives the W = 1 run's keyframes
  and counts, with keyframe poses within 5e-4 (bundle adjustment runs
  between windows instead of between frames).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import config as jconfig
from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu.slam.system import SLAMSystem as JSystem
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.io import datasets as tdatasets
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.slam.frame import Mode
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem
from test_torch_run import T_PNG_ORACLE, _dataset
from test_torch_slice import CFG_KW, JCFG, TCFG, _replay_module

torch.set_num_threads(1)

H, W = CFG_KW["img_size"]


def _traj(n, jump_at=None):
    """``tests/test_window.py::_traj``."""
    Ts = [jsim3.identity()]
    for i in range(1, n):
        xi = jnp.array([0.18, 0.04 * np.sin(i / 3), 0.04,
                        0.0, 0.06, 0.008, 0.0])
        if jump_at is not None and i == jump_at:
            xi = jnp.array([8.0, 5.0, -3.0, 0.0, 2.5, 0.0, 0.0])
        Ts.append(jsim3.mul(Ts[-1], jsim3.exp(xi)))
    return jnp.stack(Ts)


def _oracle_params(n, jump_at=None):
    return toracle.make_params(torch.from_numpy(np.array(_traj(n, jump_at))),
                               desc_dim=CFG_KW["desc_dim"], device="cpu")


def _cfg(mod, window, preset=None):
    cfg = (mod.load_config(f"configs/{preset}.yaml") if preset
           else mod.default_config())
    cfg["tracking"] = dict(cfg["tracking"], match_frac_thresh=0.95)
    cfg["single_thread"] = True
    cfg["runtime"] = dict(cfg.get("runtime", {}), tracking_window=window)
    return cfg


def _system(params, window):
    return TSystem(params, TCFG, _cfg(tconfig, window), (H, W),
                   keyframe_capacity=16, edge_capacity=64,
                   model_module=toracle, device="cpu")


def _drive(system, n, window, image, backend=False):
    """``tests/test_window.py::_run_frames``; with ``backend`` the order of
    ``run()``: prefetch, dispatch, the backend drained, consume."""
    i = 0
    while i < n:
        if (window > 1 and system.mode.name == "TRACKING"
                and i + window <= n):
            ids = list(range(i, i + window))
            if not backend:
                i += system.process_window(ids, [image(t) for t in ids])
                continue
            system.backend_prefetch()
            pending = system.dispatch_window(ids, [image(t) for t in ids])
            system.factor_graph.flush()
            while system.backend_step(flush_deferred=False):
                pass
            i += system.consume_window(pending)
        else:
            system.process_frame(system.make_frame(i, image(i)))
            while backend and system.backend_step():
                pass
            i += 1


def _image(i):
    return toracle.make_frame_image(i, H, W)


def _assert_same_keyframes(a, b, pose_tol=1e-5, map_tol=1e-4):
    na, nb = len(a.keyframes), len(b.keyframes)
    assert na == nb
    ka, kb = a.keyframes, b.keyframes
    np.testing.assert_array_equal(np.asarray(ka.dataset_idx[:na]),
                                  np.asarray(kb.dataset_idx[:nb]))
    np.testing.assert_allclose(np.asarray(ka.T_WC[:na]),
                               np.asarray(kb.T_WC[:nb]), atol=pose_tol,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(ka.X[:na]), np.asarray(kb.X[:nb]),
                               atol=map_tol, rtol=0)
    np.testing.assert_allclose(np.asarray(ka.C[:na]), np.asarray(kb.C[:nb]),
                               atol=map_tol, rtol=0)
    np.testing.assert_array_equal(np.asarray(ka.N[:na]),
                                  np.asarray(kb.N[:nb]))


@pytest.mark.parametrize("window", [2, 4])
def test_window_matches_per_frame(window):
    n = 9
    params = _oracle_params(n)
    sys_a, sys_b = _system(params, 1), _system(params, window)
    _drive(sys_a, n, 1, _image)
    _drive(sys_b, n, window, _image)
    assert sys_b.stats == sys_a.stats and sys_b.stats["skipped"] == 0
    assert len(sys_b.keyframes) >= 4
    assert sys_a.backend_queue == sys_b.backend_queue
    _assert_same_keyframes(sys_a, sys_b)
    np.testing.assert_allclose(sys_a.current_frame.T_WC.numpy(),
                               sys_b.current_frame.T_WC.numpy(), atol=1e-5)
    # the match warm start: None after a keyframe is the identity
    warm = lambda s: (torch.arange(H * W) if s.tracker.idx_f2k is None
                      else s.tracker.idx_f2k)
    np.testing.assert_array_equal(warm(sys_a).numpy(), warm(sys_b).numpy())


def test_window_halts_at_skip():
    """A failure mid-window commits the prefix, enters RELOC at the
    offending frame (its image, pose, pointmap and features in
    ``current_frame``) and leaves the rest to the per-frame path."""
    n, jump_at = 9, 6
    params = _oracle_params(n, jump_at)
    sys_a, sys_b = _system(params, 1), _system(params, 4)
    _drive(sys_a, n, 1, _image)
    halted = {}
    consume = sys_b.consume_window

    def spy(pending):
        k = consume(pending)
        if sys_b.mode == Mode.RELOC and not halted:
            halted.update(frame=sys_b.current_frame, consumed=k,
                          active=pending[0].hoststats[:, 7].numpy())
        return k

    sys_b.consume_window = spy
    _drive(sys_b, n, 4, _image)
    assert sys_a.stats["skipped"] >= 1
    assert sys_b.stats == sys_a.stats and sys_a.mode == sys_b.mode
    _assert_same_keyframes(sys_a, sys_b)
    # frame 0, the window 1-4, then the window 5-8 halted at frame 6:
    # frames 7 and 8 never ran in it
    f = halted["frame"]
    assert halted["consumed"] == 2 and f.frame_id == jump_at
    np.testing.assert_array_equal(halted["active"], [1, 1, 0, 0])
    ref = sys_a.make_frame(jump_at, _image(jump_at))
    torch.testing.assert_close(f.feat, ref.feat, rtol=0, atol=0)
    assert torch.equal(f.img, ref.img)
    assert f.X_canon.shape == (H * W, 3) and f.C.shape == (H * W, 1)


def test_window_with_dense_backend_matcher():
    """Windows with the dense backend matcher: the backend builds its
    edges by ``match_dense`` between windows."""
    n = 8
    system = _system(_oracle_params(n), 2)
    system.factor_graph.cfg = system.factor_graph.cfg._replace(
        matcher="dense")
    _drive(system, n, 2, _image, backend=True)
    system.check_invariants()
    assert system.mode in (Mode.TRACKING, Mode.RELOC)
    assert len(system.keyframes) >= 4
    assert system.factor_graph.n_edges >= 1


def test_window_matches_jax_on_replayed_oracle():
    """W = 4 in both packages, base settings, the backend drained between
    windows, on the JAX oracle's outputs."""
    n = 9
    jp = joracle.make_params(_traj(n), desc_dim=CFG_KW["desc_dim"])
    sj = JSystem(jp, JCFG, _cfg(jconfig, 4, "base"), (H, W),
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=joracle)
    st = TSystem(None, TCFG, _cfg(tconfig, 4, "base"), (H, W),
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=_replay_module(jp), device="cpu")
    _drive(sj, n, 4, _image, backend=True)
    _drive(st, n, 4, _image, backend=True)
    sj.factor_graph.flush()
    st.factor_graph.flush()
    assert st.stats == sj.stats and st.mode.name == sj.mode.name
    assert st.factor_graph.n_edges == sj.factor_graph.n_edges > 0
    _assert_same_keyframes(sj, st, pose_tol=5e-4, map_tol=1e-4)
    np.testing.assert_allclose(st.current_frame.T_WC.numpy(),
                               np.asarray(sj.current_frame.T_WC), atol=5e-4)


def test_tpu_fast_as_shipped_runs_windows(tmp_path):
    """``tpu_fast_config()`` unmodified (W = 8, kf by match fraction, the
    dense matcher, consecutive edges from the tracker's match) through
    ``run()`` on 17 PNG frames: frame 0 alone, then two windows."""
    import PIL.Image

    from mast3r_slam_tpu_torch.models import oracle_timing as tot

    n = 17
    params = _oracle_params(n)
    for i in range(n):
        PIL.Image.fromarray(tot.make_frame_image(i, H, W)).save(
            tmp_path / f"{i:04d}.png")
    cfg = tconfig.tpu_fast_config()
    assert cfg["runtime"]["tracking_window"] == 8
    runs = {}
    for window in (8, 1):
        cfg["runtime"] = dict(cfg["runtime"], tracking_window=window)
        system = TSystem(params, TCFG, cfg, (H, W), keyframe_capacity=16,
                         edge_capacity=64, model_module=T_PNG_ORACLE,
                         device="cpu")
        calls = []
        dispatch = system.dispatch_window
        system.dispatch_window = lambda ids, imgs: (
            calls.append(ids) or dispatch(ids, imgs))
        stats = system.run(_dataset(tdatasets, tmp_path))
        runs[window] = (system, stats, calls)
    (s8, st8, calls8), (s1, st1, calls1) = runs[8], runs[1]
    assert calls8 == [list(range(1, 9)), list(range(9, 17))] and not calls1
    assert st8 == st1 and st8["keyframes"] >= 2 and st8["skipped"] == 0
    assert s8.factor_graph.n_edges == s1.factor_graph.n_edges > 0
    s8.check_invariants()
    k = len(s8.keyframes)
    np.testing.assert_array_equal(s8.keyframes.dataset_idx[:k].numpy(),
                                  s1.keyframes.dataset_idx[:k].numpy())
    np.testing.assert_allclose(s8.keyframes.T_WC[:k].numpy(),
                               s1.keyframes.T_WC[:k].numpy(), atol=5e-4,
                               rtol=0)
