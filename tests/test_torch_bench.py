"""The port's benchmark entry points (``mast3r_slam_tpu_torch/bench.py`` and
``bench_multichip.py``) against the JAX system's ``bench.py`` and
``bench_multichip.py``, on the CPU at the TINY network.

* The health gate: the degenerate and live runs of
  ``tests/test_bench_e2e.py`` get the same verdict from both gates; a run
  that dropped an edge passes JAX's gate (which only logs the count) and
  fails the port's.
* ``bench_e2e``: both packages' whole benchmark (warm pass, a gated timed
  pass) on the same weights, retrieval head and oracle (JAX's, carried
  across as ``tests/test_torch_run.py`` does): every stat, the edge and
  dropped counts and the keyframe ids equal, keyframe poses within 5e-4
  (the slice tolerance of ``tests/test_torch_portrait.py``; each package
  runs its own oracle, which differ by a few ulps).
* ``make_traj`` against ``bench._make_traj`` within 1e-6: both compose the
  same float32 steps, but XLA contracts the multiply-adds of JAX's
  ``jnp.cross`` and ``jnp.linalg.norm`` (a few ulps, observed 4.8e-7).
* ``bench_tracking`` and ``main`` run and report what ``bench.py`` reports;
  ``bench_multichip``'s 1-shard and N-shard solves (dense and Schur, 2 and
  4 CPU shards, one edge count that needs padding) within 1e-4 of JAX's
  N-device solve of the same graph.
"""

import json
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import bench as jbench
from mast3r_slam_tpu.models import mast3r as jmast3r
from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu.slam import retrieval as jretrieval
from mast3r_slam_tpu.slam.frame import Mode as JMode
from mast3r_slam_tpu_torch import bench as tbench
from mast3r_slam_tpu_torch import bench_multichip as tmulti
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.slam import ba
from mast3r_slam_tpu_torch.slam.frame import Mode as TMode
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem

torch.set_num_threads(1)

TINY_KW = {k: getattr(jmast3r.TINY, k) for k in jmast3r.TINY._fields}
JCFG = jmast3r.MASt3RConfig(**TINY_KW)
TCFG = tmast3r.MASt3RConfig(**TINY_KW)
H, W = JCFG.img_size
POSE_TOL = 5e-4


# -- the health gate -------------------------------------------------------------


def _system(mode, n_edges, dropped, **stats):
    st = {"skipped": 0, "keyframes": 0, "loop_closures": 0, "relocs": 0,
          "reloc_failed": 0, "reinits": 0, "frames_tracking": 0,
          "frames_reloc": 0, "frames_init": 1}
    st.update(stats)
    fg = types.SimpleNamespace(n_edges=n_edges, edges_dropped=dropped)
    return types.SimpleNamespace(stats=st, mode=mode, factor_graph=fg)


def _live(kf, n_frames):
    return dict(keyframes=kf, loop_closures=2, frames_tracking=n_frames - 1)


# (stats, n_edges, dropped, n_frames, kf_every, JAX's verdict, the port's)
GATE_CASES = {
    "reloc_storm": (dict(skipped=1, keyframes=1, reloc_failed=30,
                         frames_tracking=10, frames_reloc=30), 0, 0, 49, 4,
                    "UNHEALTHY", "UNHEALTHY"),
    "natural_storm": (_live(64, 65), 10, 0, 65, 0,
                      "degenerate natural cadence",
                      "degenerate natural cadence"),
    "natural_dead": (_live(1, 65), 10, 0, 65, 0,
                     "degenerate natural cadence",
                     "degenerate natural cadence"),
    "natural_live": (_live(10, 65), 10, 0, 65, 0, None, None),
    "edges_dropped": (_live(17, 65), 88, 2, 65, 4, None, "edges_dropped=2"),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_health_gate_matches_jax(case):
    stats, n_edges, dropped, n, kf_every, want_j, want_t = GATE_CASES[case]
    for gate, mode, want in (
            (jbench._assert_healthy, JMode.TERMINATED, want_j),
            (tbench.assert_healthy, TMode.TERMINATED, want_t)):
        system = _system(mode, n_edges, dropped, **stats)
        if want is None:
            gate(system, n, kf_every)
        else:
            with pytest.raises(RuntimeError, match=want):
                gate(system, n, kf_every)


# -- the end-to-end benchmark against JAX's ----------------------------------------


@pytest.fixture(scope="module")
def nets():
    """The TINY network and a retrieval head (256 words, proj 64) of JAX
    and the same weights in the port."""
    net_j = jax.device_get(jmast3r.init_params(jax.random.PRNGKey(0), JCFG))
    net_t = tmast3r.build(TCFG, device="cpu")
    net_t.load_state_dict(convert.from_jax_params(net_j))
    rp_j = jax.device_get(jretrieval.init_retrieval_params(
        jax.random.PRNGKey(1), backbone_dim=JCFG.enc_embed_dim, proj_dim=64,
        codebook_size=256))
    rp_t = convert.retrieval_params_from_jax(rp_j, device="cpu")
    return net_j, net_t, rp_j, rp_t


def _jax_oracle(monkeypatch):
    """The port's bench on JAX's trajectory and oracle params."""
    def make_traj(n, phase, step_scale=1.0):
        return torch.from_numpy(np.array(jbench._make_traj(n, phase,
                                                           step_scale)))

    def make_params(traj, desc_dim, desc_freq, device):
        orc = joracle.make_params(jnp.asarray(traj.cpu().numpy()),
                                  desc_dim=desc_dim, desc_freq=desc_freq)
        return convert.oracle_params_from_jax(jax.device_get(orc),
                                              device=device)

    monkeypatch.setattr(tbench, "make_traj", make_traj)
    monkeypatch.setattr(tbench, "oracle",
                        types.SimpleNamespace(make_params=make_params))


def test_bench_e2e_matches_jax(nets, monkeypatch):
    net_j, net_t, rp_j, rp_t = nets
    kw = dict(W=4, kf_every=4, n_frames=17)
    fps_j, sj, _ = jbench.bench_e2e(net_j, rp_j, JCFG, H, W, **kw)
    _jax_oracle(monkeypatch)
    fps_t, st, passes = tbench.bench_e2e(net_t, rp_t, TCFG, H, W, **kw,
                                         device="cpu")
    assert passes == [fps_t] and fps_t > 0 and fps_j > 0
    assert st.stats == sj.stats
    assert st.stats["keyframes"] == 5 and st.stats["loop_closures"] > 0
    fg_t, fg_j = st.factor_graph, sj.factor_graph
    assert fg_t.n_edges == fg_j.n_edges > 8
    assert fg_t.edges_dropped == fg_j.edges_dropped == 0
    k = len(st.keyframes)
    assert k == len(sj.keyframes)
    np.testing.assert_array_equal(st.keyframes.dataset_idx[:k].numpy(),
                                  np.asarray(sj.keyframes.dataset_idx[:k]))
    np.testing.assert_allclose(st.keyframes.T_WC[:k].numpy(),
                               np.asarray(sj.keyframes.T_WC[:k]),
                               atol=POSE_TOL, rtol=0)


@pytest.mark.parametrize("phase,step_scale", [(0.0, 1.0), (1.0, 1.0),
                                              (1.2, 1.0), (1.0, 3.0)])
def test_make_traj_matches_jax(phase, step_scale):
    got = tbench.make_traj(65, phase, step_scale)
    want = np.asarray(jbench._make_traj(65, phase, step_scale))
    assert got.dtype == torch.float32 and got.shape == (65, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_bench_tracking_runs(nets):
    _, net_t, _, _ = nets
    fps = tbench.bench_tracking(net_t, TCFG, H, W, 2, device="cpu")
    assert np.isfinite(fps) and fps > 0


def test_threaded_backend_failure_fails_the_bench(nets, monkeypatch):
    """An exception in the backend thread fails the pass and the bench."""
    _, net_t, _, rp_t = nets

    def broken(self, *a, **k):
        raise ValueError("backend fault")

    monkeypatch.setattr(TSystem, "backend_step", broken)
    with pytest.raises(RuntimeError, match="backend thread failed"):
        tbench.bench_e2e(net_t, rp_t, TCFG, H, W, W=4, kf_every=4,
                         n_frames=9, threaded=True, device="cpu")


def test_main_prints_jax_keys(monkeypatch, capsys):
    """``main`` at the TINY network: one JSON line with ``bench.py``'s keys
    plus ``edges_dropped`` and ``gpu`` (null on the CPU), from a healthy
    run."""
    monkeypatch.setattr(tbench, "model_config", lambda: TCFG)
    for k, v in {"BENCH_WINDOW": "4", "BENCH_E2E_FRAMES": "9",
                 "BENCH_E2E_REPEATS": "2", "BENCH_CODEBOOK": "256"}.items():
        monkeypatch.setenv(k, v)
    result = tbench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result
    assert set(result) == {
        "metric", "unit", "window", "kf_every", "tracking_fps_per_chip",
        "fps_passes", "value", "vs_baseline", "keyframes", "loop_closures",
        "edges", "edges_dropped", "skipped", "reloc_failed", "gpu"}
    assert result["metric"] == "end_to_end_fps_per_chip"
    assert result["keyframes"] == 3 and result["edges"] > 0
    assert result["skipped"] == result["reloc_failed"] == 0
    assert len(result["fps_passes"]) == 2 and result["gpu"] is None


# -- the BA scaling benchmark ------------------------------------------------------


def _jax_solve(graph, n_kf, n_dev, schur_solver, P):
    """JAX's solve of the same graph, as ``bench_multichip.py`` calls it, on
    an ``n_dev``-device mesh of the CPU: the poses."""
    from mast3r_slam_tpu.parallel import dist_ba as jdist
    from mast3r_slam_tpu.parallel import mesh as jmesh
    from mast3r_slam_tpu.parallel import schur as jschur
    from mast3r_slam_tpu.slam import ba as jba

    T, Xs, Cs, ii, jj, idx, valid, Q, mask = (jnp.asarray(a.numpy())
                                              for a in graph)
    cfg = jba.BAConfig(max_iters=10, point_chunk=P)
    m = jmesh.make_mesh(n_dev)
    if schur_solver:
        part, order, keep = jschur.schur_partition(
            np.asarray(ii), np.asarray(jj), np.asarray(mask), K_cap=n_kf,
            n_shards=n_dev)
        return np.asarray(jschur.gauss_newton_rays_schur(
            T, Xs, Cs, *(jnp.asarray(a) for a in part[:3]),
            *jschur.reorder_edges(order, keep, ii, jj, idx, valid, Q, mask),
            jnp.asarray(n_kf), part.I_cap, part.S_cap, m, cfg))
    pad = lambda a, fill=0: jmesh.pad_to_multiple(a, n_dev, 0, fill)
    return np.asarray(jdist.gauss_newton_rays_dist(
        T, Xs, Cs, pad(ii), pad(jj), pad(idx), pad(valid, False), pad(Q),
        pad(mask), jnp.asarray(n_kf), m, cfg))


@pytest.mark.parametrize("schur,n_kf,shards", [
    (False, 8, 2), (True, 8, 2), (False, 7, 4), (True, 7, 4)])
def test_multichip_two_shards_match_one(schur, n_kf, shards, capsys):
    """``main``'s JSON line, and the port's 1-shard and N-shard solves of
    ``make_graph`` within 1e-4 of JAX's N-device solve of the same graph
    (dense or Schur). At 7 keyframes the 18 edges do not split over 4
    shards, so the dense solve's padding runs."""
    P = 256
    argv = ["--cpu", "--devices", str(shards), "--n-kf", str(n_kf),
            "--points", str(P), "--iters", "1"] + (["--schur"] if schur
                                                   else [])
    out = tmulti.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert set(out) == {"metric", "value", "unit", "devices",
                        "kf_per_s_1dev", "kf_per_s_ndev", "platform",
                        "solver", "note"}
    assert out["metric"] == "ba_scaling_efficiency"
    assert out["platform"] == "cpu" and out["devices"] == shards
    assert out["solver"] == ("schur" if schur else "edge_sharded")
    assert out["kf_per_s_1dev"] > 0 and out["kf_per_s_ndev"] > 0

    cpu = torch.device("cpu")
    graph = tmulti.make_graph(n_kf, P, cpu)
    assert graph[3].shape[0] % shards == (2 if n_kf == 7 else 0)
    cfg = ba.BAConfig(max_iters=10, point_chunk=P)
    T_1 = tmulti.solver(graph, n_kf, [cpu], False, cfg)()
    T_n = tmulti.solver(graph, n_kf, [cpu] * shards, schur, cfg)()
    want = _jax_solve(graph, n_kf, shards, schur, P)
    assert torch.isfinite(T_n).all()
    np.testing.assert_allclose(T_1.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(T_n.numpy(), want, rtol=1e-4, atol=1e-4)
    # the solve moved the noised poses
    assert float((T_1 - graph[0]).abs().max()) > 1e-3
