"""The port's viewer (``viz.py``, ``viz_server.py``) against the JAX
package's, on the same keyframe stores made from seeded numpy data.

Tolerances: the scene's points and line endpoints within 1e-5 (the JAX
package applies ``sim3.act`` in XLA, which contracts multiply-adds; the
port's PyTorch ops round each step), everything discrete exactly equal:
the point count, the selection and its order, the colours, the line
colours. The ``/scene`` wire format and the HTML page are byte for byte
the JAX package's for the same scene.
"""

import base64
import re
import threading
import time
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import viz as jviz
from mast3r_slam_tpu import viz_server as jserver
from mast3r_slam_tpu.slam.frame import KeyframeStore as JStore
from mast3r_slam_tpu_torch import viz as tviz
from mast3r_slam_tpu_torch import viz_server as tserver
from mast3r_slam_tpu_torch.slam.frame import Frame
from mast3r_slam_tpu_torch.slam.frame import KeyframeStore as TStore

torch.set_num_threads(1)

PTS_TOL = 1e-5


def _data(n=5, h=12, w=16, seed=0):
    """Poses, pointmaps, confidences (C summed over N updates), images and
    edges of ``n`` keyframes."""
    rng = np.random.default_rng(seed)
    P = h * w
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.concatenate([rng.standard_normal((n, 3)), q,
                        rng.uniform(0.5, 2.0, (n, 1))], 1).astype(np.float32)
    X = (rng.standard_normal((n, P, 3)) + [0, 0, 3]).astype(np.float32)
    N = rng.integers(1, 4, n).astype(np.int32)
    C = (rng.uniform(0.0, 3.0, (n, P)) * N[:, None]).astype(np.float32)
    uimg = rng.uniform(-0.1, 1.1, (n, h, w, 3)).astype(np.float32)
    e = 7 if n else 0
    ii = rng.integers(0, max(n, 1), e).astype(np.int32)
    jj = rng.integers(0, max(n, 1), e).astype(np.int32)
    return dict(T=T, X=X, N=N, C=C, uimg=uimg, ii=ii, jj=jj, hw=(h, w))


def _jax_store(d, cap=8):
    n = len(d["T"])
    kfs = JStore(cap, d["X"].shape[1], 4, 8, d["hw"], donate=False)
    kfs.n_size = n
    for name, key in (("T_WC", "T"), ("X", "X"), ("C", "C"), ("N", "N")):
        setattr(kfs, name,
                getattr(kfs, name).at[:n].set(jnp.asarray(d[key])))
    kfs.uimg[:n] = d["uimg"]
    fg = types.SimpleNamespace(n_edges=len(d["ii"]), ii=jnp.asarray(d["ii"]),
                               jj=jnp.asarray(d["jj"]))
    return kfs, fg


def _port_store(d, cap=8):
    n = len(d["T"])
    kfs = TStore(cap, d["X"].shape[1], 4, 8, d["hw"], device="cpu")
    kfs.n_size = n
    for name, key in (("T_WC", "T"), ("X", "X"), ("C", "C"), ("N", "N")):
        getattr(kfs, name)[:n] = torch.from_numpy(d[key])
    for i in range(n):
        kfs.set_uimg(i, d["uimg"][i])
    fg = types.SimpleNamespace(n_edges=len(d["ii"]),
                               ii=torch.from_numpy(d["ii"]),
                               jj=torch.from_numpy(d["jj"]))
    return kfs, fg


def _assert_scene_equal(st, sj):
    assert len(st["pts"]) == len(sj["pts"])
    np.testing.assert_allclose(st["pts"], sj["pts"], atol=PTS_TOL, rtol=0)
    np.testing.assert_array_equal(st["cols"], sj["cols"])
    np.testing.assert_allclose(st["lpts"], sj["lpts"], atol=PTS_TOL, rtol=0)
    np.testing.assert_array_equal(st["lcols"], sj["lcols"])
    np.testing.assert_allclose(st["center"], sj["center"], atol=PTS_TOL)
    np.testing.assert_allclose(st["scale"], sj["scale"], rtol=1e-5)
    for k in ("pts", "cols", "lpts", "lcols", "center"):
        assert st[k].dtype == sj[k].dtype, k


@pytest.mark.parametrize("thr,max_points,edges", [
    (1.5, 600_000, True),     # every confident point
    (1.0, 400, True),         # the even stride: 80 of ~130 points a keyframe
    (0.3, 90, False),         # a stride of 2-3, no edges
    (10.0, 600_000, True),    # nothing passes
])
def test_build_scene_matches_jax(thr, max_points, edges):
    d = _data()
    kj, fj = _jax_store(d)
    kt, ft = _port_store(d)
    sj = jviz.build_scene(kj, thr, max_points, fj if edges else None)
    st = tviz.build_scene(kt, thr, max_points, ft if edges else None)
    _assert_scene_equal(st, sj)
    if thr < 10:
        assert len(st["pts"]) > 0
    if max_points < 600_000:
        assert len(st["pts"]) <= max_points


def test_build_scene_of_empty_store_matches_jax():
    d = _data(n=0)
    kj, _ = _jax_store(d)
    kt, _ = _port_store(d)
    _assert_scene_equal(tviz.build_scene(kt), jviz.build_scene(kj))


def test_pack_scene_gives_the_jax_bytes():
    d = _data()
    kj, fj = _jax_store(d)
    scene = jviz.build_scene(kj, 1.0, 400, fj)
    for kw in ({}, {"n_kf": 5, "frame": 17, "paused": True}):
        blob = tserver.pack_scene(scene, **kw)
        assert blob == jserver.pack_scene(scene, **kw)
        out = tserver.unpack_scene(blob)
        np.testing.assert_array_equal(out["pts"], scene["pts"])
        np.testing.assert_array_equal(out["lcols"], scene["lcols"])
    assert tserver._EMPTY == jserver._EMPTY


def _embedded(html):
    """The five base64 arrays and the centre/scale of an exported page."""
    m = re.search(r'setScene\(new Float32Array\(dec\("([^"]*)"\)\.buffer\),'
                  r'dec\("([^"]*)"\),\nnew Float32Array\(dec\("([^"]*)"\)'
                  r'\.buffer\),dec\("([^"]*)"\),\n([^\n]*),true\);', html)
    assert m is not None
    dec = lambda s, dt: np.frombuffer(base64.b64decode(s), dt)
    return (dec(m[1], np.float32), dec(m[2], np.uint8),
            dec(m[3], np.float32), dec(m[4], np.uint8), m[5])


def test_export_html_viewer_matches_jax(tmp_path):
    d = _data()
    kj, fj = _jax_store(d)
    kt, ft = _port_store(d)
    hj = jviz.export_html_viewer(kj, tmp_path / "j.html", 1.0, 400,
                                 fj).read_text()
    ht = tviz.export_html_viewer(kt, tmp_path / "t.html", 1.0, 400,
                                 ft).read_text()
    ej, et = _embedded(hj), _embedded(ht)
    np.testing.assert_allclose(et[0], ej[0], atol=PTS_TOL, rtol=0)
    np.testing.assert_array_equal(et[1], ej[1])
    np.testing.assert_allclose(et[2], ej[2], atol=PTS_TOL, rtol=0)
    np.testing.assert_array_equal(et[3], ej[3])
    # the page around the arrays is the same
    strip = lambda h: re.sub(r'dec\("[^"]*"\)|\n\[[^\n]*,true\);', "", h)
    assert strip(ht) == strip(hj)
    assert tviz.live_html("abc") == jviz.live_html("abc")


def test_png_renders_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    d = _data()
    kt, ft = _port_store(d)
    outs = [tviz.plot_trajectory(kt, tmp_path / "a" / "traj.png"),
            tviz.render_pointcloud(kt, tmp_path / "cloud.png", 1.0,
                                   max_points=100, factor_graph=ft),
            tviz.keyframe_mosaic(kt, tmp_path / "kf.png")]
    for p in outs:
        assert p.exists() and p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    empty, _ = _port_store(_data(n=0))
    assert tviz.keyframe_mosaic(empty, tmp_path / "none.png") is None


def _get(base, path):
    return urllib.request.urlopen(f"{base}{path}", timeout=5).read()


def _ctrl(base, q, token):
    req = urllib.request.Request(f"{base}/ctrl?{q}&t={token}", method="POST")
    return urllib.request.urlopen(req, timeout=5)


def test_live_viewer_endpoints_token_and_pause_step():
    d = _data()
    kt, ft = _port_store(d)
    viewer = tserver.LiveViewer(port=0, c_conf_threshold=1.0,
                                max_points=400, refresh_s=0.0).start()
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        html = _get(base, "/").decode()
        assert viewer.token in html and 'method:"POST"' in html
        assert tserver.unpack_scene(_get(base, "/scene"))["n_kf"] == 0
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, "/nothing")
        assert e.value.code == 404

        system = types.SimpleNamespace(keyframes=kt, factor_graph=ft,
                                       last_frame_idx=9,
                                       state_lock=threading.Lock())
        viewer.update(system, force=True)
        out = tserver.unpack_scene(_get(base, "/scene"))
        assert out["n_kf"] == 5 and out["frame"] == 9 and not out["paused"]
        ref = tviz.build_scene(kt, 1.0, 400, ft)
        np.testing.assert_array_equal(out["pts"], ref["pts"])
        np.testing.assert_array_equal(out["cols"], ref["cols"])
        assert viewer.last_render["points"] == len(ref["pts"])

        # /ctrl needs POST and the token
        with pytest.raises(urllib.error.HTTPError) as e:
            _ctrl(base, "pause=1", "wrong")
        assert e.value.code == 403 and not viewer.paused
        with pytest.raises(urllib.error.HTTPError):
            _get(base, f"/ctrl?pause=1&t={viewer.token}")
        assert not viewer.paused
        _ctrl(base, "step=1", viewer.token)      # running: no latched step
        assert not viewer._step.is_set()

        _ctrl(base, "pause=1", viewer.token)
        assert viewer.paused
        released = threading.Event()

        def waiter():
            viewer.wait_if_paused()
            released.set()

        threading.Thread(target=waiter, daemon=True).start()
        time.sleep(0.15)
        assert not released.is_set()
        _ctrl(base, "step=1", viewer.token)
        assert released.wait(timeout=5.0) and viewer.paused
        _ctrl(base, "toggle=1", viewer.token)
        assert not viewer.paused
        viewer.wait_if_paused()

        # the throttle: no refresh is due, nothing is rebuilt
        viewer.refresh_s = 3600.0
        system.last_frame_idx = 10
        viewer.update(system)
        assert tserver.unpack_scene(_get(base, "/scene"))["frame"] == 9
    finally:
        viewer.stop()


def test_snapshot_owns_its_data():
    """Rows of the store written in place after ``update()`` (a keyframe
    replaced through ``set_frame``, a pose moved as bundle adjustment
    moves them) change neither the served scene nor a re-render at a new
    threshold from the same snapshot."""
    d = _data()
    kt, ft = _port_store(d)
    before, _ = _port_store(d)          # an untouched copy of the store
    viewer = tserver.LiveViewer(port=0, c_conf_threshold=1.0,
                                max_points=400, refresh_s=0.0).start()
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        system = types.SimpleNamespace(keyframes=kt, factor_graph=ft,
                                       last_frame_idx=3,
                                       state_lock=threading.Lock())
        viewer.update(system, force=True)
        served = _get(base, "/scene")

        P = kt.X.shape[1]
        h, w = d["hw"]
        kt.set_frame(1, Frame(
            frame_id=7, img=None, uimg=np.zeros((h, w, 3), np.float32),
            T_WC=torch.tensor([5.0, 5, 5, 0, 0, 0, 1, 1]),
            X_canon=torch.full((P, 3), 9.0), C=torch.full((P, 1), 0.1),
            feat=torch.zeros(4, 8), pos=torch.zeros(4, 2, dtype=torch.int64),
            N=1, N_updates=1))
        kt.T_WC[0] = torch.tensor([-3.0, 0, 0, 0, 0, 0, 1, 2])
        kt.X[2].mul_(-1.0)
        assert _get(base, "/scene") == served

        viewer.set_conf_threshold(0.5)
        again = tserver.unpack_scene(_get(base, "/scene"))
        ref = tviz.build_scene(before, 0.5, 400, ft)
        np.testing.assert_array_equal(again["pts"], ref["pts"])
        np.testing.assert_array_equal(again["cols"], ref["cols"])
        np.testing.assert_array_equal(again["lpts"], ref["lpts"])

        # the next update sees the new rows
        viewer.update(system, force=True)
        now = tserver.unpack_scene(_get(base, "/scene"))
        ref = tviz.build_scene(kt, 0.5, 400, ft)
        np.testing.assert_array_equal(now["pts"], ref["pts"])
        np.testing.assert_array_equal(now["cols"], ref["cols"])
    finally:
        viewer.stop()


def test_run_with_viewer_matches_run_without_and_the_jax_scene(tmp_path):
    """``run(viewer=)`` on the JAX oracle's replayed outputs over PNG frames
    (``tests/test_torch_run.py``'s setting): the viewer changes no stat and
    no pose, it is updated after every frame and once more at the end, and
    its final scene is the JAX package's ``build_scene`` of the JAX run's
    store: the same points in the same order (within 1e-3, the PLY
    tolerance of that file: the poses after bundle adjustment differ by up
    to 2e-4), the same colours and lines."""
    import PIL.Image

    from mast3r_slam_tpu import config as jconfig
    from mast3r_slam_tpu.io import datasets as jdatasets
    from mast3r_slam_tpu.models import oracle as joracle
    from mast3r_slam_tpu.models import oracle_timing as jot
    from mast3r_slam_tpu.slam.system import SLAMSystem as JSystem
    from mast3r_slam_tpu_torch import config as tconfig
    from mast3r_slam_tpu_torch.io import datasets as tdatasets
    from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem
    from test_torch_run import (H, J_PNG_ORACLE, JCFG, N_FRAMES, TCFG, W,
                                _cfg, _dataset, _gt_trajectory,
                                _replay_module)

    jp = joracle.make_params(_gt_trajectory(N_FRAMES),
                             desc_dim=JCFG.desc_dim)
    for i in range(N_FRAMES):
        PIL.Image.fromarray(jot.make_frame_image(i, H, W)).save(
            tmp_path / f"{i:04d}.png")
    sj = JSystem(jp, JCFG, _cfg(jconfig, "base"), (H, W),
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=J_PNG_ORACLE)
    sj.run(_dataset(jdatasets, tmp_path))

    def port_run(viewer):
        st = TSystem(None, TCFG, _cfg(tconfig, "base"), (H, W),
                     keyframe_capacity=16, edge_capacity=64,
                     model_module=_replay_module(jp), device="cpu")
        return st, st.run(_dataset(tdatasets, tmp_path), viewer=viewer)

    calls = []
    viewer = tserver.LiveViewer(port=0, refresh_s=0.0).start()
    update = viewer.update
    viewer.update = lambda s, force=False: (calls.append(force)
                                            or update(s, force))
    try:
        s1, stats1 = port_run(viewer)
        blob = _get(f"http://127.0.0.1:{viewer.port}", "/scene")
    finally:
        viewer.stop()
    s0, stats0 = port_run(None)
    assert stats1 == stats0 == sj.stats
    k = len(s1.keyframes)
    np.testing.assert_array_equal(s1.keyframes.T_WC[:k].numpy(),
                                  s0.keyframes.T_WC[:k].numpy())
    assert calls == [False] * N_FRAMES + [True]
    out = tserver.unpack_scene(blob)
    assert out["n_kf"] == k == len(sj.keyframes) and out["frame"] == N_FRAMES
    ref = jviz.build_scene(sj.keyframes, 1.5, 400_000, sj.factor_graph)
    assert len(out["pts"]) == len(ref["pts"]) > 0
    np.testing.assert_allclose(out["pts"], ref["pts"], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(out["cols"], ref["cols"])
    np.testing.assert_allclose(out["lpts"], ref["lpts"], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(out["lcols"], ref["lcols"])
