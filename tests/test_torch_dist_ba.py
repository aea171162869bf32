"""The port's edge-sharded bundle adjustment (``parallel/dist_ba.py``) and
device list (``parallel/mesh.py``) against the JAX package's, on the
fixtures of ``tests/test_parallel.py`` and ``tests/test_schur.py`` and on
the synthetic graph of the JAX system's ``bench_multichip.py`` (edge-sharded
and Schur, 2 and 4 shards).

JAX shards over its 8 virtual CPU devices (``tests/conftest.py``); the port
over a list that repeats the CPU device (``make_mesh([cpu] * n)``). The
sharded poses are held to the port's dense solve and to JAX's sharded solve
at 1e-4 (the tolerance of ``__graft_entry__.py``'s sharded checks); the
summed partial systems to the dense system at 1e-6 of its largest entry
(fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import geometry as jgeometry
from mast3r_slam_tpu.lie import sim3 as js
from mast3r_slam_tpu.parallel import dist_ba as jdist
from mast3r_slam_tpu.parallel import mesh as jmesh
from mast3r_slam_tpu.parallel import schur as jschur
from mast3r_slam_tpu.slam import ba as jba
from mast3r_slam_tpu_torch import cli as tcli
from mast3r_slam_tpu_torch.config import BAConfig
from mast3r_slam_tpu_torch.parallel import dist_ba, mesh, schur
from mast3r_slam_tpu_torch.slam import ba as tba

from test_ba import _edges, _make_world

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-4


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _rays_world(key=0, n_kf=5, P=256):
    """``test_parallel.py:12``: a chain with one loop edge, poses noised."""
    key = jax.random.PRNGKey(key)
    T_true, Xs = _make_world(key, n_kf, P)
    Cs = jnp.full((n_kf, P), 5.0)
    edges = _edges(n_kf, P, extra=[(0, n_kf - 1)])
    noise = 0.05 * jax.random.normal(jax.random.fold_in(key, 7), (n_kf, 7))
    T_init = jax.vmap(js.retr)(T_true, noise.at[0].set(0.0))
    return (T_init, Xs, Cs) + tuple(edges)


def _calib_world():
    """``test_schur.py:171``: 9 keyframes on calibrated rays, 12x16."""
    key, kz = jax.random.PRNGKey(4), jax.random.PRNGKey(5)
    n_kf, hh, ww = 9, 12, 16
    P = hh * ww
    K_mat = jnp.array([[20.0, 0.0, ww / 2.0], [0.0, 20.0, hh / 2.0],
                       [0.0, 0.0, 1.0]])
    uv = jgeometry.pixel_coords((hh, ww))
    T_true = [js.identity()]
    for i in range(1, n_kf):
        xi = 0.03 * jax.random.normal(jax.random.fold_in(kz, i), (7,))
        T_true.append(js.mul(T_true[-1], js.exp(xi)))
    T_true = jnp.stack(T_true)
    z = 2.0 + 0.3 * jax.random.uniform(jax.random.fold_in(kz, 99),
                                       (n_kf, P, 1))
    Xs = jax.vmap(lambda zk: jgeometry.backproject(uv, zk, K_mat))(z)
    Cs = jnp.full((n_kf, P), 5.0)
    edges = _edges(n_kf, P, extra=[(0, n_kf - 1)])
    noise = 0.01 * jax.random.normal(jax.random.fold_in(key, 5), (n_kf, 7))
    T_init = jax.vmap(js.retr)(T_true, noise.at[0].set(0.0))
    return (T_init, Xs, Cs) + tuple(edges), K_mat, (hh, ww)


def _jpad(n):
    return lambda a, fill=0: jmesh.pad_to_multiple(a, n, 0, fill)


def _tpad(n):
    return lambda a, fill=0: mesh.pad_to_multiple(a, n, 0, fill)


def _padded(pad, ii, jj, idx, valid, Q, mask):
    return (pad(ii), pad(jj), pad(idx), pad(valid, False), pad(Q),
            pad(mask))


@pytest.fixture(scope="module")
def rays_runs():
    """JAX's dense and 8-way edge-sharded ray solves of the world."""
    T, Xs, Cs, *edges = _rays_world()
    n_kf = T.shape[0]
    cfg = jba.BAConfig(max_iters=5, point_chunk=256)
    dense = jba.gauss_newton_rays(T, Xs, Cs, *edges, jnp.asarray(n_kf), cfg)
    m = jmesh.make_mesh(8)
    sharded = jdist.gauss_newton_rays_dist(
        T, Xs, Cs, *_padded(_jpad(8), *edges), jnp.asarray(n_kf), m, cfg)
    return np.asarray(dense), np.asarray(sharded)


def test_mesh_helpers():
    """``make_mesh`` over a list that repeats a device and over GPU counts,
    ``pad_to_multiple`` as ``jnp.pad`` with a fill (int, bool, float, on
    axis 0 and 1), ``shard_edges`` and ``replicate``."""
    m = mesh.make_mesh([CPU] * 4)
    assert m.size == 4 and m.axis == "edge" and m.devices == (CPU,) * 4
    assert mesh.make_mesh(2).devices == (torch.device("cuda", 0),
                                         torch.device("cuda", 1))
    assert mesh.normalize_device("cpu") == CPU
    rng = np.random.default_rng(0)
    for a, fill, axis in ((rng.integers(0, 9, (5, 3)).astype(np.int32), 7,
                           0),
                          (rng.random((6, 3)) > 0.5, False, 0),
                          (rng.random((3, 5)).astype(np.float32), -1.5, 1)):
        got = mesh.pad_to_multiple(torch.from_numpy(a), 4, axis, fill)
        want = jmesh.pad_to_multiple(jnp.asarray(a), 4, axis, fill)
        assert got.dtype == torch.from_numpy(np.array(want)).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t = torch.arange(8)
    assert mesh.pad_to_multiple(t, 4) is t
    (chunks,) = mesh.shard_edges(m, t)
    assert [c.tolist() for c in chunks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_edges(m, torch.arange(6))
    (copies,) = mesh.replicate(m, t)
    assert len(copies) == 4 and all(torch.equal(c, t) for c in copies)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_dist_rays_matches_dense_and_jax(rays_runs, n_dev):
    """``test_parallel.py:12``: the edge-sharded ray solve over 2, 4 and 8
    shards equals the port's dense solve and JAX's 8-way sharded one."""
    j_dense, j_sharded = rays_runs
    T, Xs, Cs, *edges = _t(*_rays_world())
    n_kf = T.shape[0]
    cfg = BAConfig(max_iters=5)
    dense = tba.gauss_newton_rays(T, Xs, Cs, *edges, n_kf, cfg)
    res = dist_ba.gauss_newton_rays_dist(
        T, Xs, Cs, *_padded(_tpad(n_dev), *edges), n_kf,
        mesh.make_mesh([CPU] * n_dev), cfg)
    np.testing.assert_allclose(res.T_WC.numpy(), dense.T_WC.numpy(),
                               atol=TOL)
    np.testing.assert_allclose(res.T_WC.numpy(), j_sharded, atol=TOL)
    np.testing.assert_allclose(dense.T_WC.numpy(), j_dense, atol=TOL)
    assert res.iters == dense.iters == len(res.deltas)
    assert np.abs(res.T_WC.numpy() - T.numpy()).max() > 1e-3   # it moved


def test_dist_calib_matches_dense_and_jax():
    """``test_schur.py:171``: the pixel + log-depth residual through the
    edge-sharded solver equals the dense solver, in both packages."""
    args, K_mat, img_size = _calib_world()
    T, Xs, Cs, *edges = args
    n_kf = T.shape[0]
    jcfg = jba.BAConfig(max_iters=8, point_chunk=img_size[0] * img_size[1])
    j_sharded = jdist.gauss_newton_calib_dist(
        T, Xs, Cs, K_mat, *_padded(_jpad(8), *edges), jnp.asarray(n_kf),
        img_size, jmesh.make_mesh(8), jcfg)
    T, Xs, Cs, K_t, *edges = _t(T, Xs, Cs, K_mat, *edges)
    cfg = BAConfig(max_iters=8)
    dense = tba.gauss_newton_calib(T, Xs, Cs, K_t, *edges, n_kf, img_size,
                                   cfg)
    res = dist_ba.gauss_newton_calib_dist(
        T, Xs, Cs, K_t, *_padded(_tpad(4), *edges), n_kf, img_size,
        mesh.make_mesh([CPU] * 4), cfg)
    np.testing.assert_allclose(res.T_WC.numpy(), dense.T_WC.numpy(),
                               atol=TOL)
    np.testing.assert_allclose(res.T_WC.numpy(), np.asarray(j_sharded),
                               atol=TOL)
    assert np.abs(res.T_WC.numpy() - T.numpy()).max() > 1e-4


def test_kf_sharded_matches_jax():
    """``test_parallel.py:78``: keyframe maps in blocks over the devices
    (K = 5 padded to 8), each edge's endpoints gathered from the block that
    holds them, then the edge-local solve: JAX's keyframe-sharded solve and
    the port's dense one. The gathered points equal the replicated
    ``_edge_prep``'s."""
    world = _rays_world(key=3)
    T, Xs, Cs, *edges = world
    n_kf = T.shape[0]
    jcfg = jba.BAConfig(max_iters=5, point_chunk=256)
    m8 = jmesh.make_mesh(8)
    jp = _padded(_jpad(8), *edges)
    Xs_sh, Cs_sh = jdist.shard_keyframe_store(
        m8, jmesh.pad_to_multiple(Xs, 8, 0), jmesh.pad_to_multiple(Cs, 8, 0))
    pre = jdist.prep_edges_kf_sharded(m8, Xs_sh, Cs_sh, *jp[:4])
    j_res = jdist.gauss_newton_rays_dist_pre(
        T, pre, jp[0], jp[1], jp[3], jp[4], jp[5], jnp.asarray(n_kf), m8,
        jcfg)

    T, Xs, Cs, *edges = _t(*world)
    cfg = BAConfig(max_iters=5)
    dense = tba.gauss_newton_rays(T, Xs, Cs, *edges, n_kf, cfg)
    m = mesh.make_mesh([CPU] * 4)
    ii, jj, idx, vm, Q, mask = _padded(_tpad(4), *edges)
    Xs_b, Cs_b = dist_ba.shard_keyframe_store(
        m, mesh.pad_to_multiple(Xs, 4), mesh.pad_to_multiple(Cs, 4))
    assert [x.shape[0] for x in Xs_b] == [2, 2, 2, 2]
    pres = dist_ba.prep_edges_kf_sharded(m, Xs_b, Cs_b, ii, jj, idx, vm)
    whole = tba._edge_prep(Xs, Cs, ii, jj, idx, vm)
    for name in tba.EdgePre._fields:
        np.testing.assert_array_equal(
            torch.cat([getattr(p, name) for p in pres]).numpy(),
            getattr(whole, name).numpy())
    res = dist_ba.gauss_newton_rays_dist_pre(T, pres, ii, jj, vm, Q, mask,
                                             n_kf, m, cfg)
    np.testing.assert_allclose(res.T_WC.numpy(), dense.T_WC.numpy(),
                               atol=TOL)
    np.testing.assert_allclose(res.T_WC.numpy(), np.asarray(j_res), atol=TOL)


def test_padded_edges_add_nothing_at_pin_zero():
    """Padded edges have ii = jj = 0 and mask 0; at ``pin`` 0 keyframe 0 is
    free, so their blocks are not cut off: they must add exact zeros. The
    summed partial systems over 4 shards (6 edges of 16 are padding) equal
    the dense system, at pin 0 and at pin 1."""
    T, Xs, Cs, *edges = _t(*_rays_world())
    n_kf = T.shape[0]
    padded = _padded(_tpad(8), *edges)                     # 10 -> 16
    assert padded[0].shape[0] == 16 and float(padded[5][10:].sum()) == 0.0
    m = mesh.make_mesh([CPU] * 4)
    for pin in (0, 1):
        cfg = BAConfig(pin=pin)
        shards = dist_ba.replicated_shards(
            m, dist_ba.host_edges(padded[0], padded[1]), Xs, Cs, *padded,
            n_kf, n_kf, cfg)
        Hd, gd = dist_ba._system("rays", shards, T, n_kf, n_kf, cfg, None,
                                 m)
        _, _, Hd_ref, gd_ref = tba.edge_system_plain(
            "rays", T, Xs, Cs, *edges, n_kf, n_kf, pin, cfg)
        for got, ref in ((Hd, Hd_ref), (gd, gd_ref)):
            scale = float(ref.abs().max())
            assert scale > 0
            np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                       atol=1e-6 * scale, rtol=0)


def _jax_step_norms(T, Xs, Cs, ii, jj, idx, valid, Q, mask, n_kf, cfg):
    """The body of JAX's ``gauss_newton_rays`` (``ba.py:509-526``) one
    iteration at a time: the step norm of each iteration, with the same
    stop rule."""
    K_cap = T.shape[0]
    pre = jba._edge_prep(Xs, Cs, ii, jj, idx, valid,
                         stride=cfg.point_stride)

    @jax.jit
    def body(T):
        H, g = jba._edge_terms_rays(T, Xs, Cs, ii, jj, idx, valid, Q, mask,
                                    cfg, pre=pre)
        dx, free = jba._assemble_and_solve(H, g, ii, jj, jnp.asarray(n_kf),
                                           K_cap, cfg.pin, cfg.solver)
        T = jnp.where(free[:, None], js.retr(T, dx), T)
        return T, jnp.linalg.norm(jnp.where(free[:, None], dx, 0.0))

    deltas = []
    while len(deltas) < cfg.max_iters:
        T, delta = body(T)
        deltas.append(float(delta))
        if bool(delta < cfg.delta_norm):
            break
    return deltas


def _fp64_step_norms(T, Xs, Cs, edges, n_kf, cfg):
    """The port's dense solve in float64 (``edge_system_plain`` on float64
    copies and ``ba._solve``, through the solvers' one loop,
    ``ba.gn_loop``): its step norms."""
    ii, jj, idx, vm, Q, mask = edges
    pre = tba._edge_prep(Xs, Cs, ii, jj, idx, vm, cfg.point_stride)
    pre = tba.EdgePre(pre.XCi.double(), pre.XCj.double(), pre.safe_idx)

    def step(T):
        _, _, Hd, gd = tba.edge_system_plain(
            "rays", T, None, None, ii, jj, idx, vm, Q.double(),
            mask.double(), n_kf, n_kf, cfg.pin, cfg, pre)
        return tba._solve(Hd, gd, n_kf, n_kf, cfg.pin, cfg.solver)
    return list(tba.gn_loop(step, T.double(), cfg).deltas)


@pytest.mark.parametrize("key", [0, 3])
def test_ba_stop_iterations_match_jax(key):
    """The open stopping check of ``ROADMAP.md`` §3: both packages stop BA
    when the step norm falls below ``delta_norm`` (1e-8) or after
    ``max_iters``. In fp32 the step norm stalls near 1e-7 at the optimum,
    so the port's dense and edge-sharded solves and JAX's run the same
    number of iterations (all of them); the float64 solve resolves the
    optimum and stops earlier. ``chip_smoke.py`` phase 8 prints the fp32
    series of the loop run's graph on the card."""
    world = _rays_world(key=key)
    T, Xs, Cs, *edges = world
    n_kf = T.shape[0]
    jcfg = jba.BAConfig(max_iters=10, point_chunk=256)
    jax_deltas = _jax_step_norms(T, Xs, Cs, *edges, n_kf, jcfg)
    T, Xs, Cs, *edges = _t(*world)
    cfg = BAConfig(max_iters=10)
    dense = tba.gauss_newton_rays(T, Xs, Cs, *edges, n_kf, cfg)
    sharded = dist_ba.gauss_newton_rays_dist(
        T, Xs, Cs, *_padded(_tpad(2), *edges), n_kf,
        mesh.make_mesh([CPU] * 2), cfg)
    fp64 = _fp64_step_norms(T, Xs, Cs, edges, n_kf, cfg)
    assert dense.iters == sharded.iters == len(jax_deltas) == cfg.max_iters
    assert len(fp64) < cfg.max_iters and fp64[-1] < cfg.delta_norm
    np.testing.assert_allclose(dense.deltas[:3], jax_deltas[:3], rtol=1e-3)
    assert min(dense.deltas + sharded.deltas) > cfg.delta_norm


def test_cli_mesh_rule(capsys):
    """The CLI's rule (JAX ``cli.py:199-206``), from a device count: a mesh
    over every visible GPU when there are several, else the dense solver
    and the JAX CLI's message; ``dense`` builds no mesh."""
    cfg = {"parallel": {"ba_backend": "edge_sharded"}}
    m = tcli._ba_mesh(cfg, 4)
    assert m.size == 4 and m.devices[3] == torch.device("cuda", 3)
    assert "global BA: edge_sharded over 4 devices" in capsys.readouterr().out
    assert tcli._ba_mesh({"parallel": {"ba_backend": "schur"}}, 1) is None
    assert ("schur requested but only one device visible; using the dense "
            "solver") in capsys.readouterr().out
    assert tcli._ba_mesh({"parallel": {"ba_backend": "dense"}}, 8) is None
    assert tcli._ba_mesh({}, 8) is None


# -- a synthetic graph sized like a run ----------------------------------------


def make_graph(n_kf, P, seed=0):
    """A synthetic pose graph (the JAX system's ``bench_multichip.py:60-85``)
    from a seeded ``torch.Generator``: consecutive and (i, i + 4) edges in
    both directions, every point of every edge matched, C = 5, Q = 4, poses
    noised by 0.03 but the first. (T_init, Xs, Cs, ii, jj, idx, valid, Q,
    mask) on the CPU."""
    from mast3r_slam_tpu_torch.lie import sim3

    g = torch.Generator().manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=g)
    pts_w = randn(P, 3) + torch.tensor([0.0, 0.0, 4.0])
    T_true = [sim3.identity()]
    for _ in range(1, n_kf):
        T_true.append(sim3.mul(T_true[-1], sim3.exp(0.05 * randn(7))))
    T_true = torch.stack(T_true)
    Xs = sim3.act(sim3.inv(T_true)[:, None], pts_w[None])
    Cs = torch.full((n_kf, P), 5.0)
    pairs = ([(i, i + 1) for i in range(n_kf - 1)]
             + [(i, i + 4) for i in range(n_kf - 4)])
    ii = torch.tensor([p for a, b in pairs for p in (a, b)],
                      dtype=torch.int32)
    jj = torch.tensor([p for a, b in pairs for p in (b, a)],
                      dtype=torch.int32)
    E = ii.shape[0]
    idx = torch.arange(P, dtype=torch.int32).expand(E, P).contiguous()
    noise = 0.03 * randn(n_kf, 7)
    noise[0] = 0.0
    return (sim3.retr(T_true, noise), Xs, Cs, ii, jj, idx,
            torch.ones((E, P), dtype=torch.bool), torch.full((E, P), 4.0),
            torch.ones((E,)))


def _sharded_solve(graph, n_kf, n_dev, schur_solver, cfg):
    """The port's solve of ``graph`` over ``n_dev`` CPU shards: Schur, or
    edge-sharded with the edges padded to the mesh."""
    T, Xs, Cs, ii, jj, idx, valid, Q, mask = graph
    m = mesh.make_mesh([CPU] * n_dev)
    if schur_solver:
        part, order, keep = schur.schur_partition(
            ii.numpy(), jj.numpy(), mask.numpy() > 0, K_cap=n_kf,
            n_shards=n_dev)
        return schur.gauss_newton_rays_schur(
            T, Xs, Cs, part.owner, part.int_slot, part.sep_slot,
            *schur.reorder_edges(order, keep, ii, jj, idx, valid, Q, mask),
            n_kf, part.I_cap, part.S_cap, m, cfg).T_WC
    return dist_ba.gauss_newton_rays_dist(
        T, Xs, Cs, *_padded(_tpad(n_dev), ii, jj, idx, valid, Q, mask),
        n_kf, m, cfg).T_WC


def _jax_sharded_solve(graph, n_kf, n_dev, schur_solver, P):
    """JAX's solve of the same graph on an ``n_dev``-device mesh of the
    CPU, as its ``bench_multichip.py`` calls it: the poses."""
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
    return np.asarray(jdist.gauss_newton_rays_dist(
        T, Xs, Cs, *_padded(_jpad(n_dev), ii, jj, idx, valid, Q, mask),
        jnp.asarray(n_kf), m, cfg))


@pytest.mark.parametrize("schur_solver,n_kf,shards", [
    (False, 8, 2), (True, 8, 2), (False, 7, 4), (True, 7, 4)])
def test_sharded_solves_of_a_synthetic_graph_match_jax(schur_solver, n_kf,
                                                       shards):
    """The port's 1-shard and N-shard solves of ``make_graph`` (dense
    edge-sharded or Schur) within 1e-4 of JAX's N-device solve of the same
    graph. At 7 keyframes the 18 edges do not split over 4 shards, so the
    edge-sharded solve's padding runs."""
    P = 256
    graph = make_graph(n_kf, P)
    assert graph[3].shape[0] % shards == (2 if n_kf == 7 else 0)
    cfg = BAConfig(max_iters=10, point_chunk=P)
    T_1 = _sharded_solve(graph, n_kf, 1, False, cfg)
    T_n = _sharded_solve(graph, n_kf, shards, schur_solver, cfg)
    want = _jax_sharded_solve(graph, n_kf, shards, schur_solver, P)
    assert torch.isfinite(T_n).all()
    np.testing.assert_allclose(T_1.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(T_n.numpy(), want, rtol=1e-4, atol=1e-4)
    # the solve moved the noised poses
    assert float((T_1 - graph[0]).abs().max()) > 1e-3
