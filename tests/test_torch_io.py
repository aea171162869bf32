"""The port's host-side modules against the JAX package's, on seeded numpy
inputs: ``io.image.resize_img``, ``io.datasets`` (adapters and
``load_dataset`` on trees the tests write, as ``tests/test_datasets.py``
does), ``io.export``, the rest of ``eval.ate``, ``config.default_config``
and ``utils.timing`` on the CPU.

Everything here is host numpy, or PyTorch on the CPU, copying the JAX
package's arithmetic: arrays, text and bytes are held equal (the world
points of ``save_reconstruction`` within 1e-5: the two packages rotate the
points in fp32 with their own operation order).
"""

import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import config as jconfig
from mast3r_slam_tpu.eval import ate as jate
from mast3r_slam_tpu.io import datasets as jdatasets
from mast3r_slam_tpu.io import export as jexport
from mast3r_slam_tpu.io import image as jimage
from mast3r_slam_tpu.slam.frame import KeyframeStore as JStore
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.eval import ate as tate
from mast3r_slam_tpu_torch.io import datasets as tdatasets
from mast3r_slam_tpu_torch.io import export as texport
from mast3r_slam_tpu_torch.io import image as timage
from mast3r_slam_tpu_torch.slam.frame import KeyframeStore as TStore
from mast3r_slam_tpu_torch.utils import timing

torch.set_num_threads(1)


# -- resize_img ---------------------------------------------------------------


@pytest.mark.parametrize("shape,size", [
    ((384, 512), 512),      # the working size: no resize
    ((48, 64), 512),        # upscaled (BICUBIC)
    ((480, 640), 512),      # downscaled (LANCZOS)
    ((500, 375), 512),      # portrait
    ((64, 64), 96),         # square: 4:3 crop
    ((70, 90), 90),         # crop only, to multiples of 16
])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_img_equals_jax(shape, size, dtype):
    rng = np.random.default_rng(shape[0] + size)
    img = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
    if dtype == "float32":
        img = img.astype(np.float32) / 255.0
    rj, tj = jimage.resize_img(img, size, return_transformation=True)
    rt, tt = timage.resize_img(img, size, return_transformation=True)
    assert tt == tj
    assert rt["true_shape"] == rj["true_shape"]
    for k in ("img", "img_u8", "unnormalized"):
        assert rt[k].dtype == rj[k].dtype
        np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)
    assert max(rt["true_shape"]) <= size and rt["true_shape"][1] % 16 == 0


# -- datasets -----------------------------------------------------------------


def _png(path, h, w, gray=False):
    rng = np.random.default_rng(abs(hash(path.name)) % 2**32)
    img = rng.integers(0, 255, (h, w) if gray else (h, w, 3), np.uint8)
    cv2.imwrite(str(path), img)


def _tum(root):
    d = root / "tum" / "rgbd_dataset_freiburg1_test"
    (d / "rgb").mkdir(parents=True)
    lines = []
    for i in range(3):
        name = f"rgb/{1000.0 + 0.1 * i:.6f}.png"
        _png(d / name, 120, 160)
        lines.append(f"{1000.0 + 0.1 * i:.6f} {name}")
    (d / "rgb.txt").write_text("\n".join(lines) + "\n")
    return d


def _euroc(root):
    d = root / "euroc" / "V1_01_easy"
    (d / "mav0/cam0/data").mkdir(parents=True)
    names = []
    for i in range(2):
        _png(d / "mav0/cam0/data" / f"{100 + i}.png", 48, 72, gray=True)
        names.append(f"{100 + i},{100 + i}.png")
    (d / "mav0/cam0/data.csv").write_text("\n".join(names) + "\n")
    (d / "mav0/cam0/sensor.yaml").write_text(
        "resolution: [72, 48]\n"
        "intrinsics: [60.0, 60.0, 36.0, 24.0]\n"
        "distortion_coefficients: [-0.28, 0.07, 0.0002, 0.00002]\n")
    return d


def _seven_scenes(root):
    d = root / "7-scenes" / "chess"
    (d / "seq-01").mkdir(parents=True)
    for i in [0, 2, 10, 1]:
        _png(d / "seq-01" / f"frame-{i}.color.png", 24, 32)
    return d


def _eth3d(root):
    d = root / "eth3d" / "train" / "sofa_1"
    (d / "rgb").mkdir(parents=True)
    lines = []
    for i in range(2):
        _png(d / f"rgb/{i}.png", 36, 48)
        lines.append(f"{i}.0 rgb/{i}.png")
    (d / "rgb.txt").write_text("\n".join(lines) + "\n")
    (d / "calibration.txt").write_text("40.0 40.0 24.0 18.0\n")
    return d


def _rgb_dir(root):
    d = root / "some_frames"
    d.mkdir()
    for i in (0, 1, 2, 10):
        _png(d / f"{i}.png", 24, 32)
    return d


@pytest.mark.parametrize("layout,kind", [
    (_tum, "TUMDataset"), (_euroc, "EurocDataset"),
    (_seven_scenes, "SevenScenesDataset"), (_eth3d, "ETH3DDataset"),
    (_rgb_dir, "RGBFiles")])
@pytest.mark.parametrize("use_calib", [False, True])
def test_load_dataset_equals_jax(tmp_path, layout, kind, use_calib):
    d = layout(tmp_path)
    dj = jdatasets.load_dataset(str(d), use_calib=use_calib)
    dt = tdatasets.load_dataset(str(d), use_calib=use_calib)
    assert type(dj).__name__ == type(dt).__name__ == kind
    assert dt.timestamps == dj.timestamps
    assert dt.rgb_files == dj.rgb_files
    assert len(dt) == len(dj) > 0
    assert dt.use_calibration == dj.use_calibration
    assert dt.has_calib() == dj.has_calib()
    if dj.has_calib():
        ij, it = dj.camera_intrinsics, dt.camera_intrinsics
        for k in ("K_orig", "K", "K_frame", "distortion", "mapx", "mapy"):
            np.testing.assert_array_equal(getattr(it, k), getattr(ij, k))
    assert dt.get_img_shape() == dj.get_img_shape()
    for i in range(len(dj)):
        (sj, ij), (st, it) = dj[i], dt[i]
        assert st == sj
        np.testing.assert_array_equal(it, ij)
    dj.subsample(2)
    dt.subsample(2)
    assert dt.timestamps == dj.timestamps and dt.rgb_files == dj.rgb_files


def test_k_frame_rescale_equals_jax():
    calib = [500.0, 510.0, 321.0, 243.5]
    for cpp in (False, True):
        ij = jdatasets.Intrinsics.from_calib(512, 640, 480, calib,
                                             center_principle_point=cpp)
        it = tdatasets.Intrinsics.from_calib(512, 640, 480, calib,
                                             center_principle_point=cpp)
        np.testing.assert_array_equal(it.K_frame, ij.K_frame)
    assert tdatasets.Intrinsics.from_calib(512, 640, 480, calib,
                                           use_calib=False) is None


# -- exports ------------------------------------------------------------------


def _stores(n=3, cap=4, h=8, w=12, seed=0):
    """The same keyframes in a JAX and a port ``KeyframeStore``."""
    rng = np.random.default_rng(seed)
    P = h * w
    q = rng.standard_normal((cap, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.concatenate([rng.standard_normal((cap, 3)), q,
                        rng.uniform(0.5, 2.0, (cap, 1))], 1).astype(np.float32)
    data = {"T_WC": T,
            "X": rng.standard_normal((cap, P, 3)).astype(np.float32) * 3,
            "C": rng.uniform(0.0, 6.0, (cap, P)).astype(np.float32),
            "N": rng.integers(1, 4, cap).astype(np.int32),
            "dataset_idx": np.array([0, 3, 5, 0], np.int32)[:cap]}
    uimg = rng.random((cap, h, w, 3)).astype(np.float32)
    sj = JStore(cap, P, 2, 4, (h, w))
    st = TStore(cap, P, 2, 4, (h, w), device="cpu")
    for k, v in data.items():
        setattr(sj, k, jnp.asarray(v))
        getattr(st, k).copy_(torch.from_numpy(v))
    sj.uimg[:] = uimg
    st.uimg[:] = uimg
    sj.n_size = st.n_size = n
    return sj, st


@pytest.mark.parametrize("stamps", ["floats", "strings"])
def test_save_traj_equals_jax(tmp_path, stamps):
    sj, st = _stores()
    ts = [0.1 * i + 1000.0 for i in range(6)]
    if stamps == "strings":
        ts = [f"{t:.6f}" for t in ts]
    pj = jexport.save_traj(tmp_path / "j", "traj.txt", ts, sj)
    pt = texport.save_traj(tmp_path / "t", "traj.txt", ts, st)
    assert pt.read_text() == pj.read_text()
    assert len(pt.read_text().splitlines()) == 3


def test_save_ply_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((57, 3)) * 4
    cols = rng.uniform(0, 255, (57, 3))
    pj = jexport.save_ply(tmp_path / "j" / "c.ply", pts, cols)
    pt = texport.save_ply(tmp_path / "t" / "c.ply", pts, cols)
    assert pt.read_bytes() == pj.read_bytes()


@pytest.mark.parametrize("n", [0, 3])
def test_save_reconstruction_and_keyframes_equal_jax(tmp_path, n):
    sj, st = _stores(n=n)
    pj = jexport.save_reconstruction(tmp_path / "j", "r.ply", sj, 1.5)
    pt = texport.save_reconstruction(tmp_path / "t", "r.ply", st, 1.5)
    bj, bt = pj.read_bytes(), pt.read_bytes()
    end = bj.index(b"end_header\n") + len(b"end_header\n")
    assert bt[:end] == bj[:end] and len(bt) == len(bj)
    dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rj, rt = np.frombuffer(bj[end:], dt), np.frombuffer(bt[end:], dt)
    assert (n == 0) == (len(rj) == 0)
    np.testing.assert_array_equal(rt["rgb"], rj["rgb"])
    np.testing.assert_allclose(rt["xyz"], rj["xyz"], atol=1e-5, rtol=0)
    ts = [float(i) for i in range(6)]
    jexport.save_keyframes(tmp_path / "jk", ts, sj)
    texport.save_keyframes(tmp_path / "tk", ts, st)
    names = sorted(p.name for p in (tmp_path / "tk").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jk").iterdir())
    assert len(names) == len({0, 3, 5} if n else ())
    for name in names:
        a = cv2.imread(str(tmp_path / "jk" / name))
        b = cv2.imread(str(tmp_path / "tk" / name))
        np.testing.assert_array_equal(b, a)


# -- eval.ate -----------------------------------------------------------------


def _tum_files(tmp_path, n=40, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.02, 0.05, n))
    pos = np.cumsum(rng.standard_normal((n, 3)) * 0.1, axis=0)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    gt = tmp_path / "gt.txt"
    est = tmp_path / "est.txt"
    with open(gt, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(n):
            f.write(" ".join(f"{v:.9f}" for v in (t[i], *pos[i], *q[i]))
                    + "\n")
    keep = np.sort(rng.choice(n, n - 6, replace=False))
    s, jitter = 1.7, rng.standard_normal((n, 3)) * 0.01
    with open(est, "w") as f:
        for i in keep:
            p = s * pos[i] + [0.3, -0.2, 1.0] + jitter[i]
            f.write(" ".join(f"{v:.9f}" for v in (t[i] + 0.004, *p, *q[i]))
                    + "\n")
    return gt, est


def test_ate_functions_equal_jax(tmp_path):
    gt, est = _tum_files(tmp_path)
    for a, b in zip(tate.load_tum_trajectory(gt),
                    jate.load_tum_trajectory(gt)):
        np.testing.assert_array_equal(a, b)
    sa, _, qa = tate.load_tum_trajectory(gt)
    sb, _, _ = tate.load_tum_trajectory(est)
    for max_diff in (0.02, 0.003):
        for a, b in zip(tate.associate(sa, sb, max_diff),
                        jate.associate(sa, sb, max_diff)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tate._quat_to_R(qa), jate._quat_to_R(qa))
    for scale in (True, False):
        assert (tate.ate_rmse(gt, est, with_scale=scale)
                == jate.ate_rmse(gt, est, with_scale=scale))
    for delta in (1, 3):
        assert tate.rpe(gt, est, delta) == jate.rpe(gt, est, delta)
    with pytest.raises(ValueError, match="associated"):
        tate.ate_rmse(gt, est, max_diff=1e-6)


def test_ate_main_equals_jax(tmp_path, capsys):
    gt, est = _tum_files(tmp_path, seed=1)
    args = [str(gt), str(est), "--rpe-delta", "2", "--max-diff", "0.01"]
    jate.main(args)
    out_j = capsys.readouterr().out
    tate.main(args)
    out_t = capsys.readouterr().out
    assert out_t == out_j and "ATE RMSE" in out_t and "RPE" in out_t


# -- config and timing --------------------------------------------------------


def test_default_config_equals_jax():
    assert tconfig.default_config() == jconfig.default_config()


def test_profiler_trace_on_cpu(tmp_path):
    with timing.ProfilerTrace(tmp_path / "trace") as tr:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in tr.prof.key_averages())
