"""The port's Schur-complement bundle adjustment (``parallel/schur.py``) and
the factor graph's backend dispatch against the JAX package's, on the
graphs of ``tests/test_schur.py``.

The partition is host numpy in both packages: its integer outputs (owner,
slots, capacities, edge order, pad slots) and the fall-back decision must
be equal. The Schur solves are held to the port's dense solve and to JAX's
Schur solve at 1e-4 (``__graft_entry__.py``'s tolerance for the sharded
solvers); the factor graph's backends to its dense solve at JAX's 1e-3
(``test_schur.py:117``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.lie import sim3 as js
from mast3r_slam_tpu.parallel import mesh as jmesh
from mast3r_slam_tpu.parallel import schur as jschur
from mast3r_slam_tpu.slam import ba as jba
from mast3r_slam_tpu_torch.config import (BAConfig, FactorGraphConfig,
                                          MatchingConfig)
from mast3r_slam_tpu_torch.parallel import mesh, schur
from mast3r_slam_tpu_torch.slam import ba as tba
from mast3r_slam_tpu_torch.slam.factor_graph import FactorGraph
from mast3r_slam_tpu_torch.slam.frame import KeyframeStore
from mast3r_slam_tpu_torch.utils import timing

from test_ba import _edges, _make_world
from test_schur import _setup
from test_torch_dist_ba import _calib_world

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-4


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _chain(n):
    pairs = [(i, i + 1) for i in range(n - 1)]
    ii = np.array([p for a, b in pairs for p in (a, b)], np.int32)
    jj = np.array([p for a, b in pairs for p in (b, a)], np.int32)
    return ii, jj, np.ones(len(ii), np.float32)


def _revisit():
    """``test_schur.py:254``: a chain of 24 with loops 18..23 -> 0..5."""
    n_kf, P = 24, 64
    return _setup(jax.random.PRNGKey(3), n_kf, P,
                  extra=[(i, i + 18) for i in range(6)])


def _graphs():
    """(ii, jj, mask, K_cap, n_shards, method) of ``test_schur.py:31``,
    ``:231`` and ``:254``."""
    ii, jj, _, _, _, mask = _edges(12, 16, extra=[(0, 11), (2, 9)])
    g = [(ii, jj, mask, 12, 4, "contiguous"), (ii, jj, mask, 12, 4, "greedy")]
    for n, shards in ((16, 8), (64, 2)):
        g.append(_chain(n) + (n, shards, "greedy"))
    r = _revisit()
    for method in ("contiguous", "greedy"):
        g.append((r[4], r[5], r[9], 24, 2, method))
    return [tuple(np.asarray(a) for a in x[:3]) + x[3:] for x in g]


@pytest.mark.parametrize("case", range(6))
def test_partition_equals_jax(case):
    """``schur_partition`` and ``separator_dominated`` give JAX's integers
    on every graph; on the revisit graph greedy beats contiguous (the
    contiguous split is separator-dominated, greedy keeps fewer than a
    quarter of the keyframes as separators), a short chain over 8 shards
    is dominated and a long chain over 2 is not."""
    ii, jj, mask, K_cap, n, method = _graphs()[case]
    got = schur.schur_partition(ii, jj, mask, K_cap=K_cap, n_shards=n,
                                method=method)
    want = jschur.schur_partition(ii, jj, mask, K_cap=K_cap, n_shards=n,
                                  method=method)
    (pg, og, kg), (pw, ow, kw) = got, want
    for name in ("owner", "int_slot", "sep_slot"):
        a, b = getattr(pg, name), np.asarray(getattr(pw, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (pg.I_cap, pg.S_cap) == (pw.I_cap, pw.S_cap)
    np.testing.assert_array_equal(og, ow)
    np.testing.assert_array_equal(kg, kw)
    for n_active in (0, K_cap // 2, K_cap):
        assert (schur.separator_dominated(pg, n_active)
                == jschur.separator_dominated(pw, n_active))
    dominated = schur.separator_dominated(pg, K_cap)
    if case == 2:
        assert dominated
    if case == 3:
        assert not dominated
    if case == 4:
        assert dominated
    if case == 5:
        assert not dominated and (pg.sep_slot >= 0).sum() / K_cap < 0.25


def test_reorder_edges_equals_jax():
    """``reorder_edges`` on the device: JAX's arrays, pad slots masked."""
    ii, jj, idx, valid, Q, mask = _edges(12, 16, extra=[(0, 11), (2, 9)])
    part, order, keep = schur.schur_partition(
        np.asarray(ii), np.asarray(jj), np.asarray(mask), K_cap=12,
        n_shards=4)
    want = jschur.reorder_edges(order, keep, ii, jj, idx, valid, Q, mask)
    got = schur.reorder_edges(order, keep, *_t(ii, jj, idx, valid, Q, mask))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(got[5].sum()) == float(np.asarray(mask).sum())


def _schur_args(part, order, keep, edges):
    return ((part.owner, part.int_slot, part.sep_slot)
            + tuple(schur.reorder_edges(order, keep, *edges)))


@pytest.mark.parametrize("case", ["chain13", "all_separator", "revisit"])
def test_schur_rays_matches_dense_and_jax(case):
    """``test_schur.py:58`` (13 keyframes at capacity 16, two loop edges,
    8 shards), ``:89`` (every keyframe a separator) and ``:254`` (the
    revisit graph over 2 shards): the port's Schur solve equals its dense
    solve and JAX's Schur solve, and recovers the true poses."""
    key, n_kf, P, K_cap, extra, n_sh, iters = {
        "chain13": (0, 13, 128, 16, [(0, 12), (3, 10)], 8, 10),
        "all_separator": (2, 4, 128, None, [(0, 2), (0, 3), (1, 3)], 8, 8),
        "revisit": (3, 24, 64, None, [(i, i + 18) for i in range(6)], 2, 8),
    }[case]
    T_true, T_init, Xs, Cs, *edges = _setup(jax.random.PRNGKey(key), n_kf,
                                            P, K_cap=K_cap, extra=extra)
    K_cap = T_init.shape[0]
    part, order, keep = schur.schur_partition(
        np.asarray(edges[0]), np.asarray(edges[1]), np.asarray(edges[5]),
        K_cap=K_cap, n_shards=n_sh)
    if case == "all_separator":
        assert (part.sep_slot >= 0).all()
    jcfg = jba.BAConfig(max_iters=iters, point_chunk=P)
    j_sc = jschur.gauss_newton_rays_schur(
        T_init, Xs, Cs, *(jnp.asarray(a) for a in part[:3]),
        *jschur.reorder_edges(order, keep, *edges), jnp.asarray(n_kf),
        part.I_cap, part.S_cap, jmesh.make_mesh(n_sh), jcfg)

    T, Xs, Cs, *edges = _t(T_init, Xs, Cs, *edges)
    cfg = BAConfig(max_iters=iters)
    dense = tba.gauss_newton_rays(T, Xs, Cs, *edges, n_kf, cfg)
    res = schur.gauss_newton_rays_schur(
        T, Xs, Cs, *_schur_args(part, order, keep, edges), n_kf, part.I_cap,
        part.S_cap, mesh.make_mesh([CPU] * n_sh), cfg)
    got = res.T_WC.numpy()[:n_kf]
    np.testing.assert_allclose(got, dense.T_WC.numpy()[:n_kf], atol=TOL)
    np.testing.assert_allclose(got, np.asarray(j_sc)[:n_kf], atol=TOL)
    err = jax.vmap(lambda a, b: js.log(js.mul(js.inv(a), b)))(
        T_true[:n_kf], jnp.asarray(got))
    assert float(jnp.abs(err).max()) < 2e-3


def test_schur_calib_matches_dense_and_jax():
    """``test_schur.py:171``: the pixel + log-depth residual through the
    Schur solver over 8 shards equals the dense solver, in both
    packages."""
    args, K_mat, img_size = _calib_world()
    T, Xs, Cs, *edges = args
    n_kf = T.shape[0]
    part, order, keep = schur.schur_partition(
        np.asarray(edges[0]), np.asarray(edges[1]), np.asarray(edges[5]),
        K_cap=n_kf, n_shards=8)
    j_sc = jschur.gauss_newton_calib_schur(
        T, Xs, Cs, K_mat, *(jnp.asarray(a) for a in part[:3]),
        *jschur.reorder_edges(order, keep, *edges), jnp.asarray(n_kf),
        part.I_cap, part.S_cap, img_size, jmesh.make_mesh(8),
        jba.BAConfig(max_iters=8, point_chunk=img_size[0] * img_size[1]))
    T, Xs, Cs, K_t, *edges = _t(T, Xs, Cs, K_mat, *edges)
    cfg = BAConfig(max_iters=8)
    dense = tba.gauss_newton_calib(T, Xs, Cs, K_t, *edges, n_kf, img_size,
                                   cfg)
    res = schur.gauss_newton_calib_schur(
        T, Xs, Cs, K_t, *_schur_args(part, order, keep, edges), n_kf,
        part.I_cap, part.S_cap, img_size, mesh.make_mesh([CPU] * 8), cfg)
    np.testing.assert_allclose(res.T_WC.numpy(), dense.T_WC.numpy(),
                               atol=TOL)
    np.testing.assert_allclose(res.T_WC.numpy(), np.asarray(j_sc), atol=TOL)


def _graph(backend, m, n_kf, P, T_init, Xs, edges):
    """``test_schur.py:117``'s factor graph: the keyframes and edges written
    into a store and a graph (capacity 16 keyframes, 32 edges)."""
    kfs = KeyframeStore(16, P, 4, 8, (8, 16), device="cpu")
    kfs.n_size = n_kf
    kfs.T_WC[:n_kf] = T_init
    kfs.X[:n_kf] = Xs
    kfs.C[:n_kf] = 5.0
    kfs.N[:n_kf] = 1
    fg = FactorGraph(None, None, kfs, FactorGraphConfig(
        edge_capacity=32, ba_backend=backend), BAConfig(max_iters=8),
        MatchingConfig(), mesh=m)
    for e in range(edges[0].shape[0]):
        fg._append_edge(*(a[e] for a in edges[:5]))
    return fg


def _solved_by(rec):
    """The backend of the one solve recorded in ``rec``."""
    (solve,) = [s for s in rec.spans if s.name == "ba.solve"]
    return solve.attrs["backend"]


def test_factor_graph_backend_dispatch_matches_dense():
    """``test_schur.py:117``: ``solve_GN_rays`` with ``ba_backend`` schur
    and edge_sharded over a mesh of 8 equals the dense solve at 1e-3 (and
    at 1e-4 here); without a mesh, or with a mesh of one device, every
    backend solves dense. Schur falls back to edge_sharded exactly when
    ``separator_dominated`` says so; the poses reach the store through
    ``update_T_WCs``."""
    key = jax.random.PRNGKey(3)
    n_kf, P = 9, 128
    T_true, Xs = _make_world(key, n_kf, P)
    edges = _edges(n_kf, P, extra=[(0, n_kf - 1)])
    noise = 0.04 * jax.random.normal(jax.random.fold_in(key, 5), (n_kf, 7))
    T_init = jax.vmap(js.retr)(T_true, noise.at[0].set(0.0))
    T_init, Xs, *edges = _t(T_init, Xs, *edges)
    m = mesh.make_mesh([CPU] * 8)
    part, _, _ = schur.schur_partition(edges[0].numpy(), edges[1].numpy(),
                                       edges[5].numpy(), K_cap=n_kf,
                                       n_shards=8)
    fallback = schur.separator_dominated(part, n_kf)
    out = {}
    for backend, mm, solved_by in (
            ("dense", None, "dense"),
            ("schur", m, "edge_sharded" if fallback else "schur"),
            ("edge_sharded", m, "edge_sharded"),
            ("schur", None, "dense"),
            ("edge_sharded", mesh.make_mesh([CPU]), "dense")):
        fg = _graph(backend, mm, n_kf, P, T_init, Xs, edges)
        with timing.recording() as rec:
            fg.solve_GN_rays()
        assert _solved_by(rec) == solved_by
        out[(backend, mm is None)] = fg.frames.T_WC[:n_kf].numpy()
    dense = out[("dense", True)]
    assert np.abs(dense - T_init.numpy()).max() > 1e-3
    for k, got in out.items():
        np.testing.assert_allclose(got, dense, atol=TOL, err_msg=str(k))


def test_factor_graph_schur_eliminates():
    """The revisit graph of ``test_schur.py:254`` in a factor graph with a
    mesh of 2: not separator-dominated, so the factor graph solves by
    Schur, and the calibrated solve too; both equal the dense solve."""
    T_true, T_init, Xs, Cs, *edges = _revisit()
    n_kf, P = 24, 64
    T_init, Xs, *edges = _t(T_init, Xs, *edges)
    m = mesh.make_mesh([CPU] * 2)

    def graph(backend):
        kfs = KeyframeStore(32, P, 4, 8, (8, 8), device="cpu")
        kfs.n_size = n_kf
        kfs.T_WC[:n_kf] = T_init
        kfs.X[:n_kf] = Xs
        kfs.C[:n_kf] = 5.0
        kfs.N[:n_kf] = 1
        K = torch.tensor([[6.0, 0, 4], [0, 6.0, 4], [0, 0, 1]])
        fg = FactorGraph(None, None, kfs, FactorGraphConfig(
            edge_capacity=64, ba_backend=backend), BAConfig(max_iters=8),
            MatchingConfig(), K=K, mesh=m)
        for e in range(edges[0].shape[0]):
            fg._append_edge(*(a[e] for a in edges[:5]))
        return fg

    for solve in ("solve_GN_rays", "solve_GN_calib"):
        poses = {}
        for backend in ("dense", "schur"):
            fg = graph(backend)
            with timing.recording() as rec:
                getattr(fg, solve)()
            assert _solved_by(rec) == backend
            poses[backend] = fg.frames.T_WC[:n_kf].numpy()
        np.testing.assert_allclose(poses["schur"], poses["dense"], atol=TOL)
