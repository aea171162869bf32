"""The backend on its own device (``parallel/backend_device.py``): the
port's ``BackendMirror`` run against the port's one-device run and against
the JAX package's mirrored run, on the oracle fixture of
``tests/test_backend_device.py`` (8 frames, 64x96).

``runtime.backend_device: 1`` reaches the mirror on the CPU through
``SLAMSystem(local_devices=[cpu, cpu])``: a device list that repeats the
CPU stands in for the JAX tests' second virtual device. The mirrored run
must equal the port's one-device run (stats and edges equal, poses within
1e-5, as ``tests/test_backend_device.py:49`` holds JAX) and match JAX's
mirrored run (counts equal, poses within 5e-4: the port's own oracle
against JAX's, the slice tolerance of ``tests/test_torch_slice.py``).
"""

import jax
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.parallel import backend_device as bdev
from mast3r_slam_tpu_torch.slam import checkpoint
from mast3r_slam_tpu_torch.slam.frame import KeyframeStore
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem

from test_backend_device import CFG as JCFG
from test_backend_device import _run as _jrun
from test_backend_device import _traj

torch.set_num_threads(1)

CPU = torch.device("cpu")
TCFG = tmast3r.MASt3RConfig(img_size=JCFG.img_size,
                            enc_embed_dim=JCFG.enc_embed_dim,
                            desc_dim=JCFG.desc_dim, dtype="float32")
H, W = JCFG.img_size
N_FRAMES = 8
MIRROR = {"runtime": {"backend_device": 1}}
REUSE = {"local_opt": {"reuse_consec_edge": True}}


def _config(*overrides):
    cfg = dict(tconfig.default_config())
    cfg["tracking"] = dict(cfg["tracking"], match_frac_thresh=0.95)
    for over in overrides:
        for k, v in over.items():
            cfg[k] = dict(cfg.get(k, {}), **v)
    return cfg


def _system(params, *overrides):
    return TSystem(params, TCFG, _config(*overrides), (H, W),
                   keyframe_capacity=16, edge_capacity=64,
                   model_module=toracle, device="cpu",
                   local_devices=[CPU, CPU])


def _drive(system, frames):
    for i in frames:
        system.process_frame(system.make_frame(
            i, toracle.make_frame_image(i, H, W)))
        while system.backend_step():
            pass
    system.factor_graph.flush()
    return system


@pytest.fixture(scope="module")
def runs():
    """JAX's mirrored run, and the port's runs on the same trajectory: one
    device and mirrored, each without and with ``reuse_consec_edge``."""
    jp = jax.device_get(joracle.make_params(_traj(N_FRAMES),
                                            desc_dim=JCFG.desc_dim))
    j_mirror = _jrun(jp, MIRROR, N_FRAMES, H, W)
    tp = convert.oracle_params_from_jax(jp, device="cpu")
    frames = range(N_FRAMES)
    port = {(m, r): _drive(_system(tp, *([MIRROR] * m + [REUSE] * r)),
                           frames)
            for m in (0, 1) for r in (0, 1)}
    return tp, j_mirror, port


def _poses(system):
    n = len(system.keyframes)
    return np.asarray(system.keyframes.T_WC[:n])


def _assert_same_run(a, b, tol):
    fa, fb = a.factor_graph, b.factor_graph
    assert a.stats == b.stats and len(a.keyframes) == len(b.keyframes)
    e = fa.n_edges
    assert e == fb.n_edges > 0
    for name in ("ii", "jj"):
        np.testing.assert_array_equal(np.asarray(getattr(fa, name)[:e]),
                                      np.asarray(getattr(fb, name)[:e]))
    np.testing.assert_allclose(np.asarray(fa.Q[:e]), np.asarray(fb.Q[:e]),
                               atol=1e-5)
    np.testing.assert_allclose(_poses(a), _poses(b), atol=tol)


@pytest.mark.parametrize("reuse", [0, 1])
def test_mirror_matches_one_device_run(runs, reuse):
    """``tests/test_backend_device.py:49`` and ``:82``: the mirrored run
    builds a ``BackendMirror`` through ``SLAMSystem`` (the factor graph
    reads it, its buffers are its own) and equals the one-device run; with
    ``reuse_consec_edge`` the tracker's matches reach the backend and
    every consecutive pair is an edge both ways."""
    _, _, port = runs
    one, mirrored = port[(0, reuse)], port[(1, reuse)]
    bm = mirrored._backend_mirror
    assert one._backend_mirror is None and bm is not None
    assert mirrored.factor_graph.frames is bm and bm.device == CPU
    for name in ("X", "C", "N", "feat", "pos", "T_WC"):
        assert (getattr(bm, name).data_ptr()
                != getattr(mirrored.keyframes, name).data_ptr())
    n_kf = len(mirrored.keyframes)
    assert n_kf >= 3 and len(bm) == n_kf
    _assert_same_run(one, mirrored, 1e-5)
    # the solved poses went back to the frontend's store
    np.testing.assert_array_equal(np.asarray(bm.T_WC[:n_kf]),
                                  _poses(mirrored))
    if reuse:
        fg = mirrored.factor_graph
        e = fg.n_edges
        pairs = set(zip(fg.ii[:e].tolist(), fg.jj[:e].tolist()))
        assert e >= 2 * (n_kf - 1)
        for k in range(1, n_kf):
            assert (k, k - 1) in pairs and (k - 1, k) in pairs


def test_mirror_matches_jax_mirror(runs):
    """The port's mirrored run against JAX's (``backend_device: 1`` on its
    second virtual device): the same counts and edges, poses within the
    slice tolerance."""
    _, j_mirror, port = runs
    t = port[(1, 0)]
    assert j_mirror._backend_mirror is not None
    assert len(t.keyframes) == len(j_mirror.keyframes)
    assert t.stats == j_mirror.stats
    e = t.factor_graph.n_edges
    assert e == j_mirror.factor_graph.n_edges
    np.testing.assert_array_equal(np.asarray(t.factor_graph.ii[:e]),
                                  np.asarray(j_mirror.factor_graph.ii[:e]))
    n = len(t.keyframes)
    np.testing.assert_allclose(_poses(t),
                               np.asarray(j_mirror.keyframes.T_WC[:n]),
                               atol=5e-4)


def test_mirror_after_checkpoint_resume(runs, tmp_path):
    """A mirrored run saved after 4 frames and resumed in a fresh mirrored
    system (``load_state`` re-mirrors the restored store wholesale) ends
    as the uninterrupted mirrored run: the same keyframes and edges, poses
    within 1e-5 (the stats are not part of a checkpoint)."""
    tp, _, port = runs
    first = _drive(_system(tp, MIRROR), range(4))
    path = checkpoint.save_state(tmp_path / "m.npz", first)
    resumed = _system(tp, MIRROR)
    checkpoint.load_state(path, resumed)
    bm = resumed._backend_mirror
    n = len(resumed.keyframes)
    for name in ("X", "T_WC", "feat"):
        assert torch.equal(getattr(bm, name)[:n],
                           getattr(resumed.keyframes, name)[:n])
    assert resumed.resume_frame == 4
    _drive(resumed, range(4, N_FRAMES))
    done = port[(1, 0)]
    assert len(resumed.keyframes) == len(done.keyframes)
    e = done.factor_graph.n_edges
    assert resumed.factor_graph.n_edges == e
    for name in ("ii", "jj"):
        np.testing.assert_array_equal(
            np.asarray(getattr(resumed.factor_graph, name)[:e]),
            np.asarray(getattr(done.factor_graph, name)[:e]))
    np.testing.assert_allclose(_poses(resumed), _poses(done), atol=1e-5)


def test_mirror_rows_stale_until_sync():
    """The mirror owns its buffers: a row the frontend changes after a sync
    is stale in the mirror until the next ``sync()``, which copies the
    rows appended since the last sync, the previous latest row and every
    pose, and no older row. ``update_T_WCs`` writes both stores,
    ``seed_pose`` too."""
    kfs = KeyframeStore(6, 10, 2, 4, (2, 5), device="cpu")
    g = torch.Generator().manual_seed(0)
    rows = lambda n: torch.rand((n, 10, 3), generator=g)
    kfs.n_size = 2
    kfs.X[:2] = rows(2)
    bm = bdev.BackendMirror(kfs, "cpu")
    assert torch.equal(bm.X, kfs.X) and bm.X.data_ptr() != kfs.X.data_ptr()
    kfs.X[0] = rows(1)[0]          # an old row: never copied again
    kfs.X[1] = rows(1)[0]          # the latest row, still fusing
    kfs.n_size = 3
    kfs.X[2] = rows(1)[0]          # appended
    kfs.T_WC[0, 7] = 2.0
    assert not torch.equal(bm.X[1], kfs.X[1])
    assert not torch.equal(bm.X[2], kfs.X[2]) and bm.T_WC[0, 7] == 1.0
    bm.sync()
    assert torch.equal(bm.X[1:3], kfs.X[1:3]) and bm.T_WC[0, 7] == 2.0
    assert not torch.equal(bm.X[0], kfs.X[0])
    kfs.X[2] = rows(1)[0]
    assert not torch.equal(bm.X[2], kfs.X[2])
    bm.sync()
    assert torch.equal(bm.X[2], kfs.X[2])
    T = torch.rand((3, 8), generator=g)
    bm.update_T_WCs(T)
    assert torch.equal(kfs.T_WC[:3], T) and torch.equal(bm.T_WC[:3], T)
    bm.seed_pose(4, T[1])
    assert torch.equal(kfs.T_WC[4], T[1]) and torch.equal(bm.T_WC[4], T[1])
    np.testing.assert_array_equal(bm.average_confs(3).numpy(),
                                  kfs.average_confs(3).numpy())


def test_pick_backend_device_local_devices():
    """``pick_backend_device`` over a given list of local devices (which
    may repeat one) follows the JAX rule; without the list the rule is the
    one-device rule; ``params_to`` keeps the objects on their own
    device."""
    two = [CPU, torch.device("cpu")]
    for off in (None, "none", "None", "", 0, False):
        assert bdev.pick_backend_device(off, "cpu", two) is None
    for spec in ("auto", True, 1, "1"):
        assert bdev.pick_backend_device(spec, "cpu", two) == CPU
    for spec in (2, -1):
        with pytest.raises(ValueError, match="only 2 local devices"):
            bdev.pick_backend_device(spec, "cpu", two)
    assert bdev.pick_backend_device("auto", "cpu") is None
    assert bdev.pick_backend_device(1, "cuda", ["cuda:0", "cuda:0"]) == (
        torch.device("cuda", 0))
    net = torch.nn.Linear(2, 2)
    params = {"net": net, "orc": {"traj": torch.zeros(2)}, "n": 3}
    moved = bdev.params_to(params, "cpu")
    assert moved["net"] is net and moved["n"] == 3
    assert moved["orc"]["traj"] is params["orc"]["traj"]
    with pytest.raises(ValueError, match="dense BA backend only"):
        _system(None, MIRROR, {"parallel": {"ba_backend": "schur"}})


def test_kernel_launches_on_its_tensors_device(monkeypatch):
    """A hand kernel launches on the device that holds its tensors, with
    that device current and on that device's stream, whatever device the
    calling thread has current: so the backend's kernels on a second GPU
    (the mirror's factor graph) are ordered with the PyTorch work on that
    GPU. Tensors on two devices, or none, raise before any launch. CUDA is
    faked here: the launcher records the device current during the call
    and the stream it was given."""
    import contextlib
    import types

    from mast3r_slam_tpu_torch.ops import _kernels

    current = ["cuda:0"]
    streams = {"cpu": 11, "cuda:0": 22}
    calls = []

    @contextlib.contextmanager
    def device(dev):
        prev, current[0] = current[0], str(dev)
        try:
            yield
        finally:
            current[0] = prev

    def launcher(*args):
        calls.append((current[0], args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=streams[str(dev or current[0])]))
    monkeypatch.setattr(_kernels, "library", lambda name:
                        types.SimpleNamespace(gather_rows_launch=launcher))
    monkeypatch.setitem(_kernels.LAUNCHES, "gather_rows", 0)
    table = torch.zeros((4, 4))
    idx = torch.zeros((2,), dtype=torch.int32)
    out = torch.zeros((2, 4))
    _kernels.launch("gather_rows", table, idx, out, 2, 4, 0)
    [(dev, args)] = calls
    assert dev == "cpu" and current[0] == "cuda:0"
    assert [a.value for a in args[:3]] == [t.data_ptr()
                                          for t in (table, idx, out)]
    assert args[3:6] == (2, 4, 0) and args[6].value == streams["cpu"]
    assert _kernels.LAUNCHES["gather_rows"] == 1
    for tensors in ((table, torch.zeros((2,), device="meta"), out), ()):
        with pytest.raises(ValueError, match="not on one device"):
            _kernels.launch("gather_rows", *tensors, 2, 4, 0)
    assert len(calls) == 1 and _kernels.LAUNCHES["gather_rows"] == 1
