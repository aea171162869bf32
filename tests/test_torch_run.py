"""The run loop of the port against the JAX package's: ``SLAMSystem.run``
over a directory of PNG frames read by ``io.datasets.RGBFiles``, the
exports of the run, the threaded backend, and the command line.

The frames are the oracle frames of ``tests/test_e2e_oracle.py`` written as
PNG at the network's working size (64 x 96): the frame id rides in two
pixels, PNG is lossless and ``resize_img`` at the working size keeps every
pixel, so the oracle sees the ids the frames were made with.

Tolerances (those of ``tests/test_torch_slice.py``):

* on the JAX oracle's replayed outputs both runs see the same geometry:
  every stat and count equal, the saved TUM trajectories within 5e-4 and
  the PLY with the same header, colours and vertex count, its points within
  1e-3 (observed: about 1e-6);
* through ``oracle_timing`` with the TINY network each package runs its
  own oracle, which differ by a few ulps per op (XLA contracts
  multiply-adds): every stat equal, the trajectories within 5e-4 and the
  keyframe maps within 1e-3. The PLY holds the same vertex count; its world
  points are the keyframe maps moved by poses that differ by up to 5e-4,
  at points about 13 units from the origin, so they are compared through
  the keyframe maps and poses rather than one by one.
"""

import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from mast3r_slam_tpu import config as jconfig
from mast3r_slam_tpu.io import datasets as jdatasets
from mast3r_slam_tpu.io import export as jexport
from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.models import mast3r as jmast3r
from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu.models import oracle_timing as jot
from mast3r_slam_tpu.slam.system import SLAMSystem as JSystem
from mast3r_slam_tpu_torch import cli as tcli
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.io import datasets as tdatasets
from mast3r_slam_tpu_torch.io import export as texport
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.models import oracle_timing as tot
from mast3r_slam_tpu_torch.slam.frame import Mode
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem

torch.set_num_threads(1)

N_FRAMES = 8
TINY_KW = {k: getattr(jmast3r.TINY, k) for k in jmast3r.TINY._fields}
JCFG = jmast3r.MASt3RConfig(**TINY_KW)
TCFG = tmast3r.MASt3RConfig(**TINY_KW)
H, W = JCFG.img_size


def _gt_trajectory(n):
    Ts = [jsim3.identity()]
    for i in range(1, n):
        xi = jnp.array([0.18, 0.04 * np.sin(i / 3), 0.04,
                        0.0, 0.06, 0.008, 0.0])
        Ts.append(jsim3.mul(Ts[-1], jsim3.exp(xi)))
    return jnp.stack(Ts)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Oracle params of both packages and the PNG frames on disk."""
    jp = joracle.make_params(_gt_trajectory(N_FRAMES),
                             desc_dim=JCFG.desc_dim)
    tp = convert.oracle_params_from_jax(jax.device_get(jp), device="cpu")
    frames = tmp_path_factory.mktemp("frames")
    for i in range(N_FRAMES):
        PIL.Image.fromarray(jot.make_frame_image(i, H, W)).save(
            frames / f"{i:04d}.png")
    return jp, tp, frames


def _cfg(mod, preset, single_thread=True):
    cfg = mod.load_config(f"configs/{preset}.yaml")
    cfg["tracking"] = dict(cfg["tracking"], match_frac_thresh=0.95)
    cfg["runtime"] = dict(cfg["runtime"], tracking_window=1)
    cfg["single_thread"] = single_thread
    return cfg


def _dataset(mod, frames):
    ds = mod.RGBFiles(frames)
    ds.img_size = W          # the working size: resize_img keeps every pixel
    return ds


class _PngOracle:
    """The oracle with the frame id read from two uint8 pixels (the
    ``oracle_timing`` protocol, which PNG keeps; the plain oracle's float
    pixel would not survive it). Hashable, as JAX's static arguments must
    be."""

    def __init__(self, oracle, timing):
        self.encode = lambda p, img, cfg: oracle.encode_fid(
            p, timing._fid_from_image(img), cfg)
        self.inference_mono = oracle.inference_mono
        self.inference_asymmetric = oracle.inference_asymmetric
        self.inference_symmetric = oracle.inference_symmetric


J_PNG_ORACLE = _PngOracle(joracle, jot)
T_PNG_ORACLE = _PngOracle(toracle, tot)


def _replay_module(jp):
    """A port model module that returns the JAX oracle's outputs."""
    j = lambda x: jnp.asarray((x.float() if x.dtype == torch.bfloat16
                               else x).numpy())
    t = lambda outs: tuple(torch.from_numpy(np.array(a)) for a in outs)
    return types.SimpleNamespace(
        encode=lambda p, img, cfg: t(joracle.encode_fid(
            jp, jot._fid_from_image(j(img)), JCFG)),
        inference_mono=lambda p, f, pos, cfg, ds=1: t(
            joracle.inference_mono(jp, j(f), j(pos), JCFG, ds)),
        inference_asymmetric=lambda p, ff, pf, fk, pk, cfg: t(
            joracle.inference_asymmetric(jp, j(ff), j(pf), j(fk), j(pk),
                                         JCFG)),
        inference_symmetric=lambda p, fi, pi, fj, pj, cfg: {
            k: torch.from_numpy(np.array(v)) for k, v in
            joracle.inference_symmetric(jp, j(fi), j(pi), j(fj), j(pj),
                                        JCFG).items()})


def _read_ply(path):
    raw = pathlib.Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    rec = np.frombuffer(raw[end:], dtype=[
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
        ("green", "u1"), ("blue", "u1")])
    return raw[:end].decode("ascii"), rec


def _exports(tmp_path, sj, dj, st, dt):
    out = {}
    for tag, exp, s, ds in (("j", jexport, sj, dj), ("t", texport, st, dt)):
        out[tag] = (exp.save_traj(tmp_path, f"{tag}.txt", ds.timestamps,
                                  s.keyframes),
                    exp.save_reconstruction(tmp_path, f"{tag}.ply",
                                            s.keyframes, 1.5))
    return out


def _compare_runs(sj, st, stats_j, stats_t, traj_j, traj_t):
    assert stats_t == stats_j and st.stats == sj.stats
    assert st.mode == Mode.TERMINATED and sj.mode.name == "TERMINATED"
    assert st.factor_graph.n_edges == sj.factor_graph.n_edges > 0
    assert st.last_frame_idx == N_FRAMES
    st.check_invariants()
    a, b = np.loadtxt(traj_j), np.loadtxt(traj_t)
    assert a.shape == b.shape == (stats_t["keyframes"], 8)
    np.testing.assert_allclose(b, a, atol=5e-4, rtol=0)


@pytest.mark.parametrize("preset", ["base", "tpu_fast"])
def test_run_matches_jax_on_replayed_oracle(scene, tmp_path, preset):
    jp, _, frames = scene
    dj, dt = _dataset(jdatasets, frames), _dataset(tdatasets, frames)
    sj = JSystem(jp, JCFG, _cfg(jconfig, preset), (H, W),
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=J_PNG_ORACLE)
    st = TSystem(None, TCFG, _cfg(tconfig, preset), (H, W),
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=_replay_module(jp), device="cpu")
    stats_j, stats_t = sj.run(dj), st.run(dt)
    out = _exports(tmp_path, sj, dj, st, dt)
    _compare_runs(sj, st, stats_j, stats_t, out["j"][0], out["t"][0])
    hj, rj = _read_ply(out["j"][1])
    ht, rt = _read_ply(out["t"][1])
    assert ht == hj and len(rt) == len(rj) > 0
    for c in ("red", "green", "blue"):
        np.testing.assert_array_equal(rt[c], rj[c])
    for c in "xyz":
        np.testing.assert_allclose(rt[c], rj[c], atol=1e-3, rtol=0)


def test_run_oracle_timing_tiny_network_matches_jax(scene, tmp_path):
    """The real TINY network runs on every call in both packages."""
    _, _, frames = scene
    traj = _gt_trajectory(N_FRAMES)
    net_j = jax.device_get(jmast3r.init_params(jax.random.PRNGKey(0), JCFG))
    net_t = tmast3r.build(TCFG, device="cpu")
    net_t.load_state_dict(convert.from_jax_params(net_j))
    orc_j = joracle.make_params(traj, desc_dim=JCFG.desc_dim)
    orc_t = convert.oracle_params_from_jax(jax.device_get(orc_j),
                                           device="cpu")
    dj, dt = _dataset(jdatasets, frames), _dataset(tdatasets, frames)
    sj = JSystem(jot.make_params(net_j, orc_j), JCFG,
                 _cfg(jconfig, "tpu_fast"), (H, W), keyframe_capacity=16,
                 edge_capacity=64, model_module=jot)
    st = TSystem(tot.make_params(net_t, orc_t), TCFG,
                 _cfg(tconfig, "tpu_fast"), (H, W), keyframe_capacity=16,
                 edge_capacity=64, model_module=tot, device="cpu")
    stats_j, stats_t = sj.run(dj), st.run(dt)
    out = _exports(tmp_path, sj, dj, st, dt)
    _compare_runs(sj, st, stats_j, stats_t, out["j"][0], out["t"][0])
    k = len(st.keyframes)
    np.testing.assert_allclose(st.keyframes.X[:k].numpy(),
                               np.asarray(sj.keyframes.X[:k]), atol=1e-3,
                               rtol=0)
    hj, rj = _read_ply(out["j"][1])
    ht, rt = _read_ply(out["t"][1])
    assert ht == hj and len(rt) == len(rj) > 0


def test_run_threaded_backend(scene):
    """``single_thread: False``: the backend runs in a host thread beside
    the frontend; the counts depend on timing, so the run is held to its
    invariants: it ends in TERMINATED with the thread stopped, the queue
    drained, the graph consistent and every pose finite. A short switch
    interval makes the two threads interleave often."""
    import sys
    import threading

    _, tp, frames = scene
    st = TSystem(tp, TCFG, _cfg(tconfig, "base", single_thread=False),
                 (H, W), keyframe_capacity=16, edge_capacity=64,
                 model_module=T_PNG_ORACLE, device="cpu")
    assert not st.single_thread
    before = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        stats = st.run(_dataset(tdatasets, frames))
    finally:
        sys.setswitchinterval(interval)
    assert threading.active_count() == before        # the thread stopped
    assert st.mode == Mode.TERMINATED
    assert not st.backend_queue and not st.reloc_pending
    st.check_invariants()
    k = len(st.keyframes)
    assert stats["keyframes"] == k >= 2 and stats["skipped"] == 0
    assert st.factor_graph.n_edges > 0
    assert np.isfinite(st.keyframes.T_WC[:k].numpy()).all()
    assert st.last_frame_idx == N_FRAMES


def test_run_threaded_backend_failure_is_raised(scene, monkeypatch):
    """An exception in the backend thread stops the run with it."""
    _, tp, frames = scene
    st = TSystem(tp, TCFG, _cfg(tconfig, "base", single_thread=False),
                 (H, W), keyframe_capacity=16, edge_capacity=64,
                 model_module=T_PNG_ORACLE, device="cpu")

    def broken(*a, **k):
        raise ValueError("backend fault")

    monkeypatch.setattr(st, "backend_step", broken)
    with pytest.raises(RuntimeError, match="backend thread") as err:
        st.run(_dataset(tdatasets, frames), max_frames=3)
    assert isinstance(err.value.__cause__, ValueError)
    assert st.mode == Mode.TERMINATED


def test_run_max_frames_start_frame_and_unported_arguments(scene, tmp_path):
    """``max_frames`` / ``start_frame``; the checkpoint arguments write the
    state (each time the frame count passes a multiple of
    ``checkpoint_every``); the live viewer still raises."""
    from mast3r_slam_tpu_torch.slam import checkpoint

    _, tp, frames = scene
    st = TSystem(tp, TCFG, _cfg(tconfig, "base"), (H, W),
                 keyframe_capacity=16, edge_capacity=64,
                 model_module=T_PNG_ORACLE, device="cpu")
    ds = _dataset(tdatasets, frames)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        st.run(ds, viewer=object())
    assert st.mode == Mode.INIT and not len(st.keyframes)
    saved = []
    save = checkpoint.save_state
    ck = tmp_path / "state.npz"
    try:
        checkpoint.save_state = lambda path, system: saved.append(
            (path, system.last_frame_idx)) or save(path, system)
        st.run(ds, max_frames=5, start_frame=2, checkpoint_path=ck,
               checkpoint_every=2)
    finally:
        checkpoint.save_state = save
    assert saved == [(ck, 4)] and ck.exists()
    assert st.last_frame_idx == 5
    assert st.stats["frames_init"] + st.stats["frames_tracking"] == 3
    assert int(st.keyframes.dataset_idx[0]) == 2
    data = np.load(ck)
    assert int(data["last_frame_id"]) == 3 and int(data["kf_n_size"]) >= 1


# -- the command line ---------------------------------------------------------


def _narrow_cli_model(monkeypatch):
    """Both CLIs build the TINY network at the dataset's size, the port's
    with the JAX network's weights, and read frames at the working size."""
    def cfg(mod):
        def make(img_size, dtype, head_dtype, _cls=mod.MASt3RConfig):
            return _cls(**dict(TINY_KW, img_size=img_size, dtype=dtype,
                               head_dtype=head_dtype))
        return make

    import mast3r_slam_tpu.models as jmodels

    monkeypatch.setattr(jmodels, "MASt3RConfig", cfg(jmast3r))
    monkeypatch.setattr(tmast3r, "MASt3RConfig", cfg(tmast3r))

    def init_from_jax(model_cfg, generator, device):
        kw = dict(model_cfg._asdict())
        net_j = jmast3r.init_params(jax.random.PRNGKey(0),
                                    jmast3r.MASt3RConfig(**kw))
        net = tmast3r.build(model_cfg, device=device)
        net.load_state_dict(convert.from_jax_params(jax.device_get(net_j)))
        return net.eval().requires_grad_(False).store_compute_dtypes()

    monkeypatch.setattr(tmast3r, "init_params", init_from_jax)
    _read_at_working_size(monkeypatch)


def _read_at_working_size(monkeypatch):
    """Both CLIs read their dataset's frames at the working size."""
    for mod in (jdatasets, tdatasets):
        load = mod.load_dataset

        def at_working_size(*a, _load=load, **k):
            ds = _load(*a, **k)
            ds.img_size = W
            return ds

        monkeypatch.setattr(mod, "load_dataset", at_working_size)


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_cli_writes_the_jax_cli_outputs(tmp_path, monkeypatch, capsys):
    """``cli.main`` with random weights on the PNG dataset of
    ``scripts/make_synth_dataset.py`` (at the working size) writes the files
    the JAX CLI writes, in the same formats: a TUM line of 8 numbers per
    keyframe, a binary PLY and one PNG per keyframe."""
    from mast3r_slam_tpu import cli as jcli

    _narrow_cli_model(monkeypatch)
    repo = pathlib.Path(__file__).parent.parent
    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset", repo / "scripts" / "make_synth_dataset.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    # eval_no_calib.yaml keeps every 2nd frame
    seq = synth.make(tmp_path / "synth_seq", n_frames=8, h=H, w=W)
    config = repo / "configs"
    args = ["--dataset", str(seq), "--config",
            str(config / "eval_no_calib.yaml"), "--no-viz", "--max-frames",
            "3", "--save-as", "run"]
    trees = {}
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        work = tmp_path / tag
        work.mkdir()
        monkeypatch.chdir(work)
        main(args + extra)
        printed = capsys.readouterr().out
        assert "done: 3 frames in" in printed and "FPS" in printed
        trees[tag] = (work / "logs", _tree(work / "logs"))
    (lj, fj), (lt, ft) = trees["j"], trees["t"]
    assert ft == fj
    tj = np.atleast_2d(np.loadtxt(lj / "run" / "synth_seq.txt"))
    tt = np.atleast_2d(np.loadtxt(lt / "run" / "synth_seq.txt"))
    assert tt.shape == tj.shape and tt.shape[1] == 8
    assert len([f for f in ft if f.endswith(".png")]) == len(tt)
    hj, _ = _read_ply(lj / "run" / "synth_seq.ply")
    ht, rt = _read_ply(lt / "run" / "synth_seq.ply")
    strip = lambda h: [ln for ln in h.splitlines()
                       if not ln.startswith("element vertex")]
    assert strip(ht) == strip(hj)
    assert f"element vertex {len(rt)}" in ht


@pytest.mark.parametrize("flags,item", [
    (["--checkpoint", "m.pth"], 4),
    (["--retrieval-checkpoint", "r.pth"], 4),
    (["--codebook", "c.pkl"], 4),
    (["--save-state", "s.npz"], 4),
    (["--save-state-every", "5"], 4),
    (["--resume", "s.npz"], 4),
    (["--estimate-calib"], 4),
    (["--serve-viz", "0"], 6),
    ([], 6),                                  # the offline renders
    (["--ba-backend", "edge_sharded"], 7),
    (["--ba-backend", "schur"], 7),
    (["--coordinator", "localhost:1234"], 7),
    (["--num-hosts", "2"], 7),
    (["--host-id", "0"], 7),
])
def test_cli_unported_flags_raise(flags, item):
    """The flags of items 6 and 7 raise ``NotImplementedError`` naming
    their ROADMAP.md item. Item 4's flags are ported: they pass the check
    and the run fails where the JAX CLI fails, on the missing dataset (no
    frame to read: ``IndexError``)."""
    viz = [] if flags == [] or flags[0] == "--serve-viz" else ["--no-viz"]
    argv = ["--dataset", "nowhere", "--device", "cpu"] + viz + flags
    if item == 4:
        with pytest.raises(IndexError):
            tcli.main(argv)
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue 1 item {item}"):
        tcli.main(argv)


def test_cli_checkpoint_state_resume_and_focal_match_jax(tmp_path,
                                                        monkeypatch, capsys):
    """Both CLIs with ``--checkpoint`` (a TINY ``.pth`` that JAX's
    ``save_released_checkpoint`` writes), ``--estimate-calib``,
    ``--save-state`` / ``--save-state-every`` over the first 2 frames, then
    ``--resume`` for the rest: the same focal estimate (1e-4 relative), the
    same resume point, stats and output files, and state files with the
    same keys."""
    import re

    from mast3r_slam_tpu import cli as jcli
    from mast3r_slam_tpu.models import convert as jconvert

    _read_at_working_size(monkeypatch)
    repo = pathlib.Path(__file__).parent.parent
    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset", repo / "scripts" / "make_synth_dataset.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    seq = synth.make(tmp_path / "synth_seq", n_frames=8, h=H, w=W)
    net_j = jax.device_get(jmast3r.init_params(jax.random.PRNGKey(0), JCFG))
    pth = jconvert.save_released_checkpoint(net_j, JCFG, tmp_path / "m.pth")
    base = ["--dataset", str(seq), "--config",
            str(repo / "configs" / "eval_no_calib.yaml"), "--no-viz",
            "--checkpoint", str(pth), "--estimate-calib", "--save-as", "run"]
    out = {}
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        work = tmp_path / tag
        work.mkdir()
        monkeypatch.chdir(work)
        main(base + extra + ["--max-frames", "2", "--save-state", "a.npz",
                             "--save-state-every", "1"])
        first = capsys.readouterr().out
        main(base + extra + ["--resume", "a.npz", "--save-state", "b.npz"])
        second = capsys.readouterr().out
        out[tag] = (first, second, work)
    (fj, sj, wj), (ft, s_t, wt) = out["j"], out["t"]
    focal = lambda text: [float(v) for v in re.findall(
        r"estimated focal:? (\S+) px", text)]
    assert len(focal(ft)) == len(focal(s_t)) == 1
    np.testing.assert_allclose(focal(ft) + focal(s_t), focal(fj) + focal(sj),
                               rtol=1e-4)
    resumed = lambda text: re.search(r"resumed SLAM state from \S+ (.*)",
                                     text).group(1)
    assert resumed(s_t) == resumed(sj) and "next frame 2" in resumed(s_t)
    assert "loading checkpoint" in ft and "random weights" not in ft
    stats = lambda text: re.findall(r"stats: (.*)", text)
    assert stats(ft) == stats(fj) and stats(s_t) == stats(sj)
    assert _tree(wt / "logs") == _tree(wj / "logs")
    for name in ("a.npz", "b.npz"):
        a, b = np.load(wj / name), np.load(wt / name)
        assert sorted(a.files) == sorted(b.files), name
        assert int(a["kf_n_size"]) == int(b["kf_n_size"]), name
