"""The port's multi-host runs: processes that meet in ``torch.distributed``
through ``parallel/mesh.init_distributed`` (gloo, 127.0.0.1) and shard the
global bundle adjustment across each other; the counterpart of
``tests/test_multiprocess.py``.

* BA (``test_multiprocess.py:42-66``'s graph): two processes, two CPU
  shards each (``make_mesh_2d``), run the edge-sharded solve; the
  revisit graph of ``tests/test_schur.py`` goes through the Schur solve
  over two processes of one shard each. Each rank's poses are bit-identical
  to the other's and within 1e-4 of the port's one-process dense solve and
  of JAX's solve on the same inputs.
* ``SLAMSystem.run`` on the oracle's PNG frames with ``parallel.ba_backend:
  edge_sharded`` over a mesh of both ranks: the ranks' stats and keyframe
  poses equal each other, and the one-process run's stats, with poses
  within 1e-4.
* The command line with ``--coordinator``, ``--num-hosts 2`` and
  ``--host-id`` over the narrow network of ``test_torch_run.py``
  (``--device cpu --ba-backend edge_sharded``): each rank writes its own
  ``--save-as`` directory; the TUM files of the ranks are byte-identical
  and hold the one-process run's keyframe count.
* The refusal of a sharded backend across processes with
  ``single_thread: False``.

Every child process runs under a timeout; a child that fails or times out
fails the test.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from mast3r_slam_tpu.lie import sim3 as js
from mast3r_slam_tpu.models import mast3r as jmast3r
from mast3r_slam_tpu.parallel import mesh as jmesh
from mast3r_slam_tpu.parallel import schur as jschur
from mast3r_slam_tpu.slam import ba as jba
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.config import BAConfig
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.models import oracle_timing as tot
from mast3r_slam_tpu_torch.parallel import mesh
from mast3r_slam_tpu_torch.slam import ba as tba
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem

from test_torch_schur import _revisit

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-4
TIMEOUT = 300
# the network of test_torch_run.py's narrow CLI (the TINY widths)
NARROW = {k: getattr(jmast3r.TINY, k) for k in jmast3r.TINY._fields
          if k not in ("img_size", "dtype", "head_dtype")}
H, W = jmast3r.TINY.img_size
RUN_CFG = dict(img_size=(H, W), enc_embed_dim=64, desc_dim=8,
               dtype="float32")
N_RUN = 8

# One child process: joins the process group from SLAM_* and runs MODE.
_WORKER = r"""
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod
from mast3r_slam_tpu_torch.utils import timing

MODE = sys.argv[1]
CPU = torch.device("cpu")


def ba_mode(src, dst):
    from mast3r_slam_tpu_torch.config import BAConfig
    from mast3r_slam_tpu_torch.parallel import dist_ba, schur

    assert mesh_mod.init_distributed() is True
    import torch.distributed as dist

    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    g = {k: torch.from_numpy(v) for k, v in np.load(src).items()}
    m2 = mesh_mod.make_mesh_2d(devices=[CPU, CPU])
    assert m2.shape == (2, 2) and m2.size == 4
    assert m2.axis == ("host", "edge")
    cfg = BAConfig(max_iters=5)
    e = [g[k] for k in ("ii", "jj", "idx", "valid", "Q", "mask")]
    fills = (0, 0, 0, False, 0, 0)
    e = [mesh_mod.pad_to_multiple(a, 4, 0, f) for a, f in zip(e, fills)]
    res = dist_ba.gauss_newton_rays_dist(g["T"], g["Xs"], g["Cs"], *e,
                                         int(g["n_kf"]), m2, cfg)
    # Schur: one shard a process, the partition of the revisit graph
    m1 = mesh_mod.make_mesh([CPU])
    assert m1.size == 2 and m1.first_shard == dist.get_rank()
    re = [g["s_" + k] for k in ("ii", "jj", "idx", "valid", "Q", "mask")]
    part, order, keep = schur.schur_partition(
        re[0].numpy(), re[1].numpy(), re[5].numpy() > 0,
        K_cap=g["s_T"].shape[0], n_shards=2)
    assert not schur.separator_dominated(part, int(g["s_n_kf"]))
    sres = schur.gauss_newton_schur(
        g["s_T"], g["s_Xs"], g["s_Cs"], None, part.owner, part.int_slot,
        part.sep_slot, *schur.reorder_edges(order, keep, *re),
        int(g["s_n_kf"]), part.I_cap, part.S_cap, m1,
        BAConfig(max_iters=8))
    np.savez(dst, edge=res.T_WC.numpy(), edge_iters=res.iters,
             schur=sres.T_WC.numpy(), schur_iters=sres.iters)
    dist.destroy_process_group()


def run_mode(frames, dst):
    from mast3r_slam_tpu_torch import config as tconfig
    from mast3r_slam_tpu_torch.io import datasets
    from mast3r_slam_tpu_torch.models import mast3r, oracle
    from mast3r_slam_tpu_torch.models import oracle_timing as ot
    from mast3r_slam_tpu_torch.slam.system import SLAMSystem

    spec = json.loads(os.environ["RUN_SPEC"])
    assert mesh_mod.init_distributed() is True
    import torch.distributed as dist

    m = mesh_mod.make_mesh([CPU])
    traj = torch.from_numpy(np.load(spec["traj"]))
    params = oracle.make_params(traj, desc_dim=spec["cfg"]["desc_dim"],
                                device="cpu")
    png = type("PngOracle", (), {})()
    png.encode = lambda p, img, cfg: oracle.encode_fid(
        p, ot._fid_from_image(img), cfg)
    png.inference_mono = oracle.inference_mono
    png.inference_asymmetric = oracle.inference_asymmetric
    png.inference_symmetric = oracle.inference_symmetric
    cfg = tconfig.load_config(spec["config"])
    cfg["tracking"] = dict(cfg["tracking"], match_frac_thresh=0.95)
    cfg["runtime"] = dict(cfg["runtime"], tracking_window=1)
    cfg["single_thread"] = True
    cfg["parallel"] = dict(cfg.get("parallel", {}),
                           ba_backend="edge_sharded")
    mcfg = spec["cfg"]
    mcfg["img_size"] = tuple(mcfg["img_size"])
    system = SLAMSystem(params, mast3r.MASt3RConfig(**mcfg), cfg,
                        mcfg["img_size"], keyframe_capacity=16,
                        edge_capacity=64, model_module=png, device="cpu",
                        mesh=m)
    ds = datasets.RGBFiles(frames)
    ds.img_size = mcfg["img_size"][1]
    with timing.recording() as rec:
        stats = system.run(ds)
    k = len(system.keyframes)
    solves = [s for s in rec.spans if s.name == "ba.solve"]
    np.savez(dst, T=system.keyframes.T_WC[:k].numpy(),
             ids=system.keyframes.dataset_idx[:k].numpy(),
             n_edges=system.factor_graph.n_edges,
             backend=solves[-1].attrs["backend"],
             stats=json.dumps(stats))
    dist.destroy_process_group()


def cli_mode(argv):
    # the narrow network of test_torch_run.py: its widths at the dataset's
    # size, random weights from --seed, frames read at the working size
    from mast3r_slam_tpu_torch import cli
    from mast3r_slam_tpu_torch.io import datasets
    from mast3r_slam_tpu_torch.models import mast3r

    kw = json.loads(os.environ["NARROW_MODEL"])
    width = kw.pop("working_width")
    cls = mast3r.MASt3RConfig
    mast3r.MASt3RConfig = lambda img_size, dtype, head_dtype: cls(
        **dict(kw, img_size=img_size, dtype=dtype, head_dtype=head_dtype))
    load = datasets.load_dataset

    def at_working_size(*a, **k):
        ds = load(*a, **k)
        ds.img_size = width
        return ds

    datasets.load_dataset = at_working_size
    stats = cli.main(argv)
    print("STATS " + json.dumps(stats))


if MODE == "ba":
    ba_mode(*sys.argv[2:])
elif MODE == "run":
    run_mode(*sys.argv[2:])
else:
    cli_mode(sys.argv[2:])
print("OK")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children(tmp_path, argvs, envs, cwds=None):
    """Start one child per argv (the worker script), wait for all under
    ``TIMEOUT``; any nonzero exit or timeout fails. Returns their outputs."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = []
    for i, (argv, env) in enumerate(zip(argvs, envs)):
        env = dict(os.environ, PYTHONPATH=f"{REPO}:"
                   f"{os.environ.get('PYTHONPATH', '')}", **env)
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)] + argv, env=env,
            cwd=(cwds[i] if cwds else tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [i for i, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0 or "OK" not in out]
    assert not failed, "\n".join(f"child {i} (rc {procs[i].returncode}):\n"
                                  f"{outs[i][-3000:]}" for i in failed)
    return outs


def _ranks(port, n=2):
    return [{"SLAM_COORDINATOR": f"127.0.0.1:{port}",
             "SLAM_NUM_PROCESSES": str(n), "SLAM_PROCESS_ID": str(r),
             "SLAM_DIST_BACKEND": "gloo"} for r in range(n)]


def _mp_graph():
    """``test_multiprocess.py:42-66``: 5 keyframes, 64 points, a chain."""
    key = jax.random.PRNGKey(0)
    n_kf, P = 5, 64
    pts_w = jax.random.normal(key, (P, 3)) + jnp.array([0.0, 0.0, 4.0])
    T_true = [js.identity()]
    for i in range(1, n_kf):
        xi = 0.05 * jax.random.normal(jax.random.fold_in(key, i), (7,))
        T_true.append(js.mul(T_true[-1], js.exp(xi)))
    T_true = jnp.stack(T_true)
    Xs = jax.vmap(lambda T: js.act(js.inv(T), pts_w))(T_true)
    Cs = jnp.full((n_kf, P), 5.0)
    pairs = [(i, i + 1) for i in range(n_kf - 1)]
    ii = jnp.array([p for a, b in pairs for p in (a, b)], jnp.int32)
    jj = jnp.array([p for a, b in pairs for p in (b, a)], jnp.int32)
    E = ii.shape[0]
    idx = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32), (E, P))
    valid = jnp.ones((E, P), bool)
    Q = jnp.full((E, P), 4.0)
    mask = jnp.ones((E,), jnp.float32)
    noise = 0.03 * jax.random.normal(jax.random.fold_in(key, 9), (n_kf, 7))
    T_init = jax.vmap(js.retr)(T_true, noise.at[0].set(0.0))
    return T_init, Xs, Cs, ii, jj, idx, valid, Q, mask, n_kf


def test_two_process_edge_sharded_and_schur_ba(tmp_path):
    """Two processes: the edge-sharded solve over 2 x 2 CPU shards and the
    Schur solve over 2 x 1; the ranks agree bit for bit and both solves
    match the one-process dense solve and JAX's at 1e-4."""
    T, Xs, Cs, ii, jj, idx, valid, Q, mask, n_kf = _mp_graph()
    jcfg = jba.BAConfig(max_iters=5, point_chunk=64)
    j_dense = np.asarray(jba.gauss_newton_rays(
        T, Xs, Cs, ii, jj, idx, valid, Q, mask, jnp.asarray(n_kf), jcfg))
    _, sT, sXs, sCs, *sedges = _revisit()
    s_n = 24
    scfg = jba.BAConfig(max_iters=8, point_chunk=64)
    jpart, jorder, jkeep = jschur.schur_partition(
        *(np.asarray(a) for a in (sedges[0], sedges[1], sedges[5])),
        K_cap=s_n, n_shards=2)
    j_schur = np.asarray(jschur.gauss_newton_rays_schur(
        sT, sXs, sCs, jpart.owner, jpart.int_slot, jpart.sep_slot,
        *jschur.reorder_edges(jorder, jkeep, *sedges), jnp.asarray(s_n),
        jpart.I_cap, jpart.S_cap, jmesh.make_mesh(2), scfg))
    names = ("ii", "jj", "idx", "valid", "Q", "mask")
    g = dict(T=T, Xs=Xs, Cs=Cs, n_kf=n_kf,
             **dict(zip(names, (ii, jj, idx, valid, Q, mask))),
             s_T=sT, s_Xs=sXs, s_Cs=sCs, s_n_kf=s_n,
             **{"s_" + k: v for k, v in zip(names, sedges)})
    src = tmp_path / "graph.npz"
    np.savez(src, **{k: np.asarray(v) for k, v in g.items()})
    envs = _ranks(_free_port())
    _children(tmp_path, [["ba", str(src), str(tmp_path / f"rank{r}.npz")]
                         for r in range(2)], envs)
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    for name in ("edge", "schur", "edge_iters", "schur_iters"):
        np.testing.assert_array_equal(r0[name], r1[name])
    t = lambda *a: [torch.from_numpy(np.array(x)) for x in a]
    dense = tba.gauss_newton_rays(*t(T, Xs, Cs, ii, jj, idx, valid, Q, mask),
                                  n_kf, BAConfig(max_iters=5))
    np.testing.assert_allclose(r0["edge"], dense.T_WC.numpy(), atol=TOL)
    np.testing.assert_allclose(r0["edge"], j_dense, atol=TOL)
    assert int(r0["edge_iters"]) == dense.iters
    s_dense = tba.gauss_newton_rays(*t(sT, sXs, sCs, *sedges), s_n,
                                    BAConfig(max_iters=8))
    np.testing.assert_allclose(r0["schur"], s_dense.T_WC.numpy(), atol=TOL)
    np.testing.assert_allclose(r0["schur"], j_schur, atol=TOL)
    assert np.abs(r0["edge"] - np.asarray(T)).max() > 1e-3    # it moved
    assert np.abs(r0["schur"] - np.asarray(sT)).max() > 1e-3


def _traj(n):
    Ts = [js.identity()]
    for i in range(1, n):
        xi = jnp.array([0.18, 0.04 * np.sin(i / 3), 0.04,
                        0.0, 0.06, 0.008, 0.0])
        Ts.append(js.mul(Ts[-1], js.exp(xi)))
    return np.array(jnp.stack(Ts))


def test_two_process_slam_run_matches_one_process(tmp_path):
    """``SLAMSystem.run`` on both ranks with the edge-sharded backend over
    a mesh of both: the ranks' stats, keyframe ids and poses are equal,
    with the one-process run's stats and edges and its poses within
    1e-4."""
    traj = _traj(N_RUN)
    np.save(tmp_path / "traj.npy", traj)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(N_RUN):
        PIL.Image.fromarray(tot.make_frame_image(i, H, W)).save(
            frames / f"{i:04d}.png")
    config = str(REPO / "configs" / "base.yaml")
    spec = json.dumps({"traj": str(tmp_path / "traj.npy"), "cfg": RUN_CFG,
                       "config": config})
    envs = [dict(e, RUN_SPEC=spec) for e in _ranks(_free_port())]
    _children(tmp_path, [["run", str(frames), str(tmp_path / f"r{r}.npz")]
                         for r in range(2)], envs)
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    for name in ("T", "ids", "n_edges", "stats"):
        np.testing.assert_array_equal(r0[name], r1[name])
    assert str(r0["backend"]) == "edge_sharded"

    # the same run in this process, dense (a mesh of one process's one
    # device solves dense)
    from mast3r_slam_tpu_torch.io import datasets
    from test_torch_run import T_PNG_ORACLE

    cfg = tconfig.load_config(config)
    cfg["tracking"] = dict(cfg["tracking"], match_frac_thresh=0.95)
    cfg["runtime"] = dict(cfg["runtime"], tracking_window=1)
    cfg["single_thread"] = True
    cfg["parallel"] = dict(cfg.get("parallel", {}),
                           ba_backend="edge_sharded")
    params = toracle.make_params(torch.from_numpy(traj),
                                 desc_dim=RUN_CFG["desc_dim"], device="cpu")
    one = TSystem(params, tmast3r.MASt3RConfig(**RUN_CFG), cfg, (H, W),
                  keyframe_capacity=16, edge_capacity=64,
                  model_module=T_PNG_ORACLE, device="cpu")
    ds = datasets.RGBFiles(frames)
    ds.img_size = W
    stats = one.run(ds)
    k = len(one.keyframes)
    assert json.loads(str(r0["stats"])) == stats and stats["skipped"] == 0
    assert k >= 3 and int(r0["n_edges"]) == one.factor_graph.n_edges > 0
    np.testing.assert_array_equal(r0["ids"],
                                  one.keyframes.dataset_idx[:k].numpy())
    np.testing.assert_allclose(r0["T"], one.keyframes.T_WC[:k].numpy(),
                               atol=TOL, rtol=0)


def test_two_process_cli_writes_identical_trajectories(tmp_path):
    """``--coordinator 127.0.0.1:P --num-hosts 2 --host-id r`` on the narrow
    network: both ranks run, print the process group line, and write
    byte-identical TUM files with the one-process run's keyframe count."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset", REPO / "scripts" / "make_synth_dataset.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    seq = synth.make(tmp_path / "synth_seq", n_frames=8, h=H, w=W)
    port = _free_port()
    base = ["cli", "--dataset", str(seq), "--config",
            str(REPO / "configs" / "eval_no_calib.yaml"), "--no-viz",
            "--device", "cpu", "--ba-backend", "edge_sharded"]
    argvs = [base + ["--save-as", f"rank{r}", "--coordinator",
                     f"127.0.0.1:{port}", "--num-hosts", "2", "--host-id",
                     str(r)] for r in range(2)] + [base + ["--save-as", "one"]]
    narrow = json.dumps(dict(NARROW, working_width=W))
    envs = [{"NARROW_MODEL": narrow, "SLAM_DIST_BACKEND": "gloo"}] * 3
    outs = _children(tmp_path, argvs, envs)
    for r in range(2):
        assert (f"torch.distributed: process {r}/2 over gloo, 2 devices"
                in outs[r])
        assert "global BA: edge_sharded over 2 devices" in outs[r]
    assert "torch.distributed" not in outs[2]
    tum = [(tmp_path / "logs" / d / "synth_seq.txt").read_bytes()
           for d in ("rank0", "rank1", "one")]
    assert tum[0] == tum[1]
    stats = [json.loads(o.split("STATS ")[1].splitlines()[0]) for o in outs]
    assert stats[0] == stats[1]
    assert stats[0]["keyframes"] == stats[2]["keyframes"] == len(
        tum[0].decode().splitlines())
    np.testing.assert_allclose(np.atleast_2d(np.loadtxt(
        tmp_path / "logs" / "rank0" / "synth_seq.txt")), np.atleast_2d(
        np.loadtxt(tmp_path / "logs" / "one" / "synth_seq.txt")), atol=TOL)


def test_sharded_backend_across_processes_needs_single_thread():
    """A mesh that spans two processes with a sharded backend and the
    threaded backend (``single_thread: False``, configs/base.yaml's) is
    refused before any collective; one process, or the dense backend, or
    ``single_thread: True`` are accepted."""
    two = mesh.Mesh((torch.device("cpu"),), "edge", 0, 2, None)
    cfg_t = tconfig.default_config()
    assert cfg_t["single_thread"] is False
    cfg_t["parallel"] = dict(cfg_t.get("parallel", {}),
                             ba_backend="edge_sharded")
    make = lambda cfg, m: TSystem(None, tmast3r.MASt3RConfig(**RUN_CFG),
                                  cfg, (H, W),
                                  keyframe_capacity=4, edge_capacity=8,
                                  model_module=toracle, device="cpu", mesh=m)
    with pytest.raises(ValueError, match="single_thread"):
        make(cfg_t, two)
    make(cfg_t, mesh.make_mesh([torch.device("cpu")] * 2))
    make(dict(cfg_t, single_thread=True), two)
    make(dict(cfg_t, parallel={"ba_backend": "dense"}), two)

