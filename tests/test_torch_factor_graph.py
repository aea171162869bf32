"""Port factor graph == the JAX package's ``slam/factor_graph.py``.

Edge endpoints, counts and the buffers written by ``add_tracked_edge`` must
be equal. Match indices that come out of the matcher (``add_factors``) are
held to 99.9% equal rows-by-pixel even when the port is fed the JAX
oracle's own outputs (``_replay_module``): JAX runs decode + match as one
jitted program whose fused multiply-adds round differently from the
port's separate operations, which moves a cold-started Levenberg-Marquardt
match by a pixel at a few grazing rays (observed 2 of 49,152). Poses after
a solve from one carried-over state are held to 1e-4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.lie import sim3 as js
from mast3r_slam_tpu.models import mast3r as jmast3r
from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu.slam import ba as jba
from mast3r_slam_tpu.slam import factor_graph as jfg
from mast3r_slam_tpu.slam.frame import KeyframeStore as JStore
from mast3r_slam_tpu_torch.config import (BAConfig, FactorGraphConfig,
                                          MatchingConfig)
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.ops import dense_matcher as tdense
from mast3r_slam_tpu_torch.ops import matching as tmatching
from mast3r_slam_tpu_torch.slam import factor_graph as tfg
from mast3r_slam_tpu_torch.slam.frame import KeyframeStore as TStore
from mast3r_slam_tpu_torch.utils import timing

torch.set_num_threads(1)

CFG_KW = dict(img_size=(64, 96), enc_embed_dim=64, desc_dim=8,
              dtype="float32")
JCFG = jmast3r.MASt3RConfig(**CFG_KW)
TCFG = tmast3r.MASt3RConfig(**CFG_KW)
H, W = CFG_KW["img_size"]
N_KF = 4
MCFG_KW = dict(dilation_max=1, radius=2, coarse_iter=3, max_iter=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _small_graph(store_cls, fg_mod, ba_cfg_cls, P, capacity, max_cap=0,
                 kf_cap=8, n_kf=5, **kw):
    kfs = store_cls(kf_cap, P, 4, 8, (2, P // 2), **kw)
    kfs.n_size = n_kf
    return fg_mod.FactorGraph(
        None, None, kfs,
        fg_mod.FactorGraphConfig(edge_capacity=capacity,
                                 max_edge_capacity=max_cap),
        ba_cfg_cls(max_iters=1), fg_mod.MatchingConfig())


def _edge_state(fg):
    e = fg.n_edges
    return [np.asarray(a[:e]) for a in (fg.ii, fg.jj, fg.idx_ii2jj,
                                        fg.valid_match, fg.Q)]


def _assert_edges_equal(ft, fj, matcher_frac=None):
    """Counts and endpoints equal; idx / valid / Q equal, or (with
    ``matcher_frac``) equal at that share of the pixels."""
    assert ft.n_edges == fj.n_edges
    assert int(ft.n_edges_dev) == int(fj.n_edges_dev)
    assert ft.edges_dropped == fj.edges_dropped
    st, sj = _edge_state(ft), _edge_state(fj)
    for a, b in zip(st[:2], sj[:2]):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(st[2:], sj[2:]):
        if matcher_frac is None:
            np.testing.assert_array_equal(np.asarray(a), b)
        else:
            assert (np.asarray(a) == b).mean() >= matcher_frac


def test_add_tracked_edge_buffers_equal_jax():
    """Scatter-inverse with collisions and an invalid pixel
    (``tests/test_ba.py::test_add_tracked_edge_inversion_and_counts``)."""
    P = 8
    fj = _small_graph(JStore, jfg, jba.BAConfig, P, 8, donate=False)
    ft = _small_graph(TStore, tfg, BAConfig, P, 8, device="cpu")
    idx = np.array([3, 3, 0, 1, 5, 6, 7, 2], np.int32)
    valid = np.array([1, 1, 1, 0, 1, 1, 1, 1], bool)
    Q = np.arange(P, dtype=np.float32) + 10.0
    rng = np.random.default_rng(0)
    for k in range(3):
        fj.add_tracked_edge(k, k + 1, *map(jnp.asarray, (idx, valid, Q)))
        ft.add_tracked_edge(k, k + 1, _t(idx).long(), _t(valid), _t(Q))
        idx = rng.integers(0, P, P).astype(np.int32)     # more collisions
        valid = rng.random(P) > 0.3
    _assert_edges_equal(ft, fj)
    assert ft.n_edges == 6
    # smallest i-pixel wins the collision at j-pixel 3
    assert int(ft.idx_ii2jj[1, 3]) == 0 and bool(ft.valid_match[1, 3])
    assert not bool(ft.valid_match[1, 1]) and float(ft.Q[1, 1]) == 0.0


def test_add_tracked_edge_atomic_pair_at_odd_capacity_equals_jax():
    """With one slot left the whole pair is dropped
    (``tests/test_ba.py:577``)."""
    P = 8
    fj = _small_graph(JStore, jfg, jba.BAConfig, P, 7, 7, donate=False)
    ft = _small_graph(TStore, tfg, BAConfig, P, 7, 7, device="cpu")
    idx = np.arange(P, dtype=np.int32)
    valid, Q = np.ones(P, bool), np.full(P, 2.0, np.float32)
    for k in range(4):
        fj.add_tracked_edge(k, k + 1, *map(jnp.asarray, (idx, valid, Q)))
        ft.add_tracked_edge(k, k + 1, _t(idx), _t(valid), _t(Q))
    _assert_edges_equal(ft, fj)
    assert ft.n_edges == 6 and ft.edges_dropped == 2
    assert int(ft.ii[6]) == 0 and not bool(ft.valid_match[6].any())


def test_gate_edges_matches_jax():
    rng = np.random.default_rng(1)
    b, P = 3, 500
    m = {k: rng.uniform(0.5, 4.0, (b, P)).astype(np.float32)
         for k in ("Qii", "Qjj", "Qji", "Qij")}
    m["idx_i2j"] = rng.integers(0, P, (b, P)).astype(np.int32)
    m["idx_j2i"] = rng.integers(0, P, (b, P)).astype(np.int32)
    m["valid_match_j"] = rng.random((b, P, 1)) > 0.3
    m["valid_match_i"] = rng.random((b, P, 1)) > 0.6
    for qs in (1, 4):
        outj = jfg._gate_edges({k: jnp.asarray(v) for k, v in m.items()},
                               1.5, qs)
        outt = tfg._gate_edges({k: _t(v) for k, v in m.items()}, 1.5, qs)
        for a, b_ in zip(outt, outj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-6)


# -- add_factors with the oracle model ----------------------------------------


def _traj():
    Ts = [js.identity()]
    for _ in range(1, N_KF):
        Ts.append(js.mul(Ts[-1], js.exp(jnp.array(
            [0.18, 0.0, 0.04, 0.0, 0.06, 0.008, 0.0]))))
    return jnp.stack(Ts)


@pytest.fixture(scope="module")
def oracle_params():
    jp = joracle.make_params(_traj(), desc_dim=CFG_KW["desc_dim"])
    tp = convert.oracle_params_from_jax(jax.device_get(jp), device="cpu")
    return jp, tp


def _replay_module(jp):
    """A port model module returning the JAX oracle's outputs."""
    def j(x):
        return jnp.asarray((x.float() if x.dtype == torch.bfloat16
                            else x).numpy())

    def sym(p, fi, pi, fj_, pj, cfg):
        out = joracle.inference_symmetric(jp, j(fi), j(pi), j(fj_), j(pj),
                                          JCFG)
        return {k: _t(v) for k, v in out.items()}

    return types.SimpleNamespace(inference_symmetric=sym)


def _jax_graph(jp, capacity=16, max_cap=0, matcher="iter_proj",
               point_stride=1):
    kfs = JStore(8, H * W, JCFG.num_patches, JCFG.enc_embed_dim, (H, W),
                 donate=False)
    traj = _traj()
    for i in range(N_KF):
        feat, pos = joracle.encode_fid(jp, jnp.asarray([i]), JCFG)
        kfs.feat = kfs.feat.at[i].set(feat[0].astype(kfs.feat.dtype))
        kfs.pos = kfs.pos.at[i].set(pos[0])
        kfs.T_WC = kfs.T_WC.at[i].set(traj[i])
    kfs.n_size = N_KF
    return jfg.FactorGraph(
        jp, JCFG, kfs,
        jfg.FactorGraphConfig(edge_capacity=capacity,
                              max_edge_capacity=max_cap, matcher=matcher),
        jba.BAConfig(max_iters=2, point_chunk=1024,
                     point_stride=point_stride),
        jfg.MatchingConfig(**MCFG_KW), model_module=joracle)


def _port_graph(tp, model_module, capacity=16, max_cap=0, matcher="iter_proj",
                point_stride=1):
    kfs = TStore(8, H * W, TCFG.num_patches, TCFG.enc_embed_dim, (H, W),
                 device="cpu")
    traj = _t(_traj())
    for i in range(N_KF):
        feat, pos = toracle.encode_fid(tp, torch.tensor([i]), TCFG)
        kfs.feat[i] = feat[0].to(kfs.feat.dtype)
        kfs.pos[i] = pos[0]
        kfs.T_WC[i] = traj[i]
    kfs.n_size = N_KF
    return tfg.FactorGraph(
        tp, TCFG, kfs,
        FactorGraphConfig(edge_capacity=capacity, max_edge_capacity=max_cap,
                          matcher=matcher),
        BAConfig(max_iters=2, point_stride=point_stride),
        MatchingConfig(**MCFG_KW), model_module=model_module)


@pytest.mark.parametrize("min_frac", [0.1, 0.999])
def test_add_factors_equals_jax(oracle_params, min_frac):
    """Three consecutive pairs and one loop candidate (0, 3) in one batch.
    At 0.999 the gate rejects the loop candidate and keeps the exempt
    consecutive pairs."""
    jp, tp = oracle_params
    ii, jj = [0, 1, 2, 0], [1, 2, 3, 3]
    fj = _jax_graph(jp)
    okj = fj.add_factors(ii, jj, min_match_frac=min_frac)
    ft = _port_graph(tp, _replay_module(jp))
    okt = ft.add_factors(ii, jj, min_match_frac=min_frac)
    assert okt == okj and ft.n_edges == (8 if min_frac < 0.5 else 6)
    _assert_edges_equal(ft, fj, matcher_frac=0.999)
    # the port's own oracle: equal counts and endpoints
    fo = _port_graph(tp, toracle)
    assert fo.add_factors(ii, jj, min_match_frac=min_frac) == okj
    assert fo.n_edges == fj.n_edges
    e = fo.n_edges
    np.testing.assert_array_equal(fo.ii[:e].numpy(), np.asarray(fj.ii[:e]))
    np.testing.assert_array_equal(fo.jj[:e].numpy(), np.asarray(fj.jj[:e]))
    same = (fo.idx_ii2jj[:e].numpy() == np.asarray(fj.idx_ii2jj[:e])).mean()
    assert same > 0.999


def test_add_factors_hard_cap_clamps_and_counts(oracle_params):
    """The expectations of ``tests/test_ba.py::
    test_fused_add_factors_hard_cap_clamps_and_counts``."""
    _, tp = oracle_params
    fg = _port_graph(tp, toracle, capacity=4, max_cap=4)
    assert fg.add_factors([0, 1, 2], [1, 2, 3], min_match_frac=0.99)
    assert fg.n_edges == 4 and int(fg.n_edges_dev) == 4
    assert fg.edges_dropped == 2
    assert (fg.ii[:4].tolist(), fg.jj[:4].tolist()) == ([0, 1, 1, 2],
                                                         [1, 0, 2, 1])
    assert not fg.add_factors([0], [2], min_match_frac=0.0)
    assert fg.n_edges == 4 and fg.edges_dropped == 4
    assert int(fg.n_edges_dev) == 4
    # strict (relocalization) proposals: one bad candidate rejects all
    fs = _port_graph(tp, toracle)
    assert not fs.add_factors([0, 0], [1, 3], min_match_frac=0.999,
                              is_reloc=True)
    assert fs.n_edges == 0 and int(fs.n_edges_dev) == 0


def test_deferred_add_factors_equivalent_to_sync(oracle_params):
    _, tp = oracle_params
    fs = _port_graph(tp, toracle)
    fs.add_factors([0, 1], [1, 2], min_match_frac=0.1)
    fs.add_factors([2], [3], min_match_frac=0.1)
    fd = _port_graph(tp, toracle)
    assert fd.add_factors([0, 1], [1, 2], min_match_frac=0.1, defer=True)
    assert fd.add_factors([2], [3], min_match_frac=0.1, defer=True)
    # before the flush the host count lags and the device count is ahead
    assert fd.n_edges == 0 and fd._pending
    assert int(fd.n_edges_dev) == fs.n_edges == 6
    fd.flush()
    assert not fd._pending
    _assert_edges_equal(fd, fs)

    # deferred dispatch + solve with no flush in between: the device-count
    # mask makes the solve act on the new edges
    f2 = _port_graph(tp, toracle)
    f2.frames.X[:N_KF] = torch.stack([
        toracle.inference_mono(tp, f2.frames.feat[i:i + 1].float(),
                               f2.frames.pos[i:i + 1], TCFG)[0][0]
        for i in range(N_KF)])
    f2.frames.C[:N_KF] = 2.5
    f2.frames.N[:N_KF] = 1
    f2.add_factors([0, 1, 2], [1, 2, 3], min_match_frac=0.1, defer=True)
    T_true = f2.frames.T_WC[:N_KF].clone()
    from mast3r_slam_tpu_torch.lie import sim3 as ts
    f2.frames.T_WC[1] = ts.retr(T_true[1], 0.05 * torch.ones(7))
    with timing.recording() as rec:
        f2.solve_GN_rays()
    assert f2._pending and f2.n_edges == 0
    assert float((f2.frames.T_WC[1] - T_true[1]).abs().max()) < 0.02
    (solve,) = [s for s in rec.spans if s.name == "ba.solve"]
    assert solve.attrs["iters"] == 2


@pytest.mark.parametrize("ii,jj,point_stride", [
    ([0], [3], 4), ([0, 1], [3, 3], 4), ([2, 0, 1], [3, 3, 3], 4),
    ([1, 0], [3, 3], 1)])
def test_add_factors_dense_equals_jax(oracle_params, ii, jj, point_stride):
    """``matcher="dense"`` on batches of 1-3 loop-closure candidates against
    keyframe 3 (2, 4 and 6 image pairs into the matcher), as
    ``backend_step`` proposes them. At ``point_stride`` 4 only every 4th
    column is matched (``query_stride``) and the match fractions are
    normalized to that subset."""
    jp, tp = oracle_params
    fj = _jax_graph(jp, matcher="dense", point_stride=point_stride)
    ft = _port_graph(tp, _replay_module(jp), matcher="dense",
                     point_stride=point_stride)
    assert ft.query_stride == fj.query_stride == point_stride
    okj = fj.add_factors(ii, jj, min_match_frac=0.1)
    okt = ft.add_factors(ii, jj, min_match_frac=0.1)
    assert okt == okj
    assert ft.n_edges == 2 * len(ii)
    _assert_edges_equal(ft, fj, matcher_frac=0.999)
    if point_stride > 1:
        vm = ft.valid_match[:ft.n_edges].reshape(-1, H, W)
        assert not bool(vm[:, :, np.arange(W) % point_stride != 0].any())
        assert float(vm[:, :, ::point_stride].float().mean()) > 0.3


def test_add_factors_dense_is_reloc_equals_jax(oracle_params):
    """Relocalization proposals, as ``_relocalize`` makes them: the new
    keyframe against its candidates, synchronous and strict (one candidate
    under the threshold rejects them all, and nothing is written)."""
    jp, tp = oracle_params
    fj = _jax_graph(jp, matcher="dense", point_stride=4)
    ft = _port_graph(tp, _replay_module(jp), matcher="dense", point_stride=4)
    for frac, expect in ((0.9999, False), (0.1, True)):
        okj = fj.add_factors([3, 3], [0, 1], min_match_frac=frac,
                             is_reloc=True)
        okt = ft.add_factors([3, 3], [0, 1], min_match_frac=frac,
                             is_reloc=True, defer=True)   # defer is ignored
        assert okt == okj == expect
        assert not ft._pending
        assert ft.n_edges == fj.n_edges == (4 if expect else 0)
        assert int(ft.n_edges_dev) == ft.n_edges
    _assert_edges_equal(ft, fj, matcher_frac=0.999)
    # the port's own oracle agrees on the decisions
    fo = _port_graph(tp, toracle, matcher="dense", point_stride=4)
    assert not fo.add_factors([3, 3], [0, 1], min_match_frac=0.9999,
                              is_reloc=True)
    assert fo.add_factors([3, 3], [0, 1], min_match_frac=0.1, is_reloc=True)
    assert fo.n_edges == 4


def test_left_out_backends_raise(oracle_params):
    """An unknown matcher raises; the sharded BA backends build and, with
    no device mesh, solve dense (``test_sharded_backends_solve_dense``)."""
    _, tp = oracle_params
    fg = _port_graph(tp, toracle, matcher="nearest")
    with pytest.raises(ValueError, match="matcher"):
        fg.add_factors([0], [1], min_match_frac=0.1)
    for backend in ("schur", "edge_sharded"):
        g = tfg.FactorGraph(None, None, fg.frames,
                            FactorGraphConfig(ba_backend=backend), BAConfig(),
                            MatchingConfig())
        assert g.cfg.ba_backend == backend


@pytest.mark.parametrize("backend", ["edge_sharded", "schur"])
def test_sharded_backends_solve_dense(backend):
    """``ba_backend`` ``edge_sharded`` / ``schur`` without a mesh: the JAX
    graph with ``mesh=None`` solves dense (``factor_graph.py:604``), and so
    does the port; the same poses as the JAX solve (1e-4, the tolerance of
    ``test_growth_and_solve_from_jax_state``) and as the port's dense
    solve (bit-equal)."""
    key = jax.random.PRNGKey(3)
    n_kf, P = 4, 96
    pts_w = jax.random.normal(key, (P, 3)) + jnp.array([0.0, 0.0, 4.0])
    T_true = [js.identity()]
    for i in range(1, n_kf):
        T_true.append(js.mul(T_true[-1], js.exp(
            0.1 * jax.random.normal(jax.random.fold_in(key, i), (7,)))))
    T_true = jnp.stack(T_true)
    Xs = jax.vmap(lambda T: js.act(js.inv(T), pts_w))(T_true)
    noise = 0.03 * jax.random.normal(jax.random.fold_in(key, 9), (n_kf, 7))
    T_init = jax.vmap(js.retr)(T_true, noise.at[0].set(0.0))
    idx = np.arange(P, dtype=np.int32)
    pairs = [(i, i + 1) for i in range(n_kf - 1)] + [(0, n_kf - 1)]

    kfs = JStore(8, P, 4, 8, (8, 12), donate=False)
    kfs.n_size = n_kf
    kfs.T_WC = kfs.T_WC.at[:n_kf].set(T_init)
    kfs.X = kfs.X.at[:n_kf].set(Xs)
    kfs.C = kfs.C.at[:n_kf].set(5.0)
    kfs.N = kfs.N.at[:n_kf].set(1)
    fj = jfg.FactorGraph(None, None, kfs, jfg.FactorGraphConfig(
        edge_capacity=16, ba_backend=backend), jba.BAConfig(
            max_iters=10, point_chunk=P), jfg.MatchingConfig(), mesh=None)

    def port_graph(ba_backend):
        tk = TStore(8, P, 4, 8, (8, 12), device="cpu")
        tk.n_size = n_kf
        tk.T_WC[:n_kf] = _t(T_init)
        tk.X[:n_kf] = _t(Xs)
        tk.C[:n_kf] = 5.0
        tk.N[:n_kf] = 1
        return tfg.FactorGraph(None, None, tk, FactorGraphConfig(
            edge_capacity=16, ba_backend=ba_backend), BAConfig(max_iters=10),
            MatchingConfig())

    ft, fd = port_graph(backend), port_graph("dense")
    for i, j in pairs:
        for a, b in ((i, j), (j, i)):
            fj._append_edge(a, b, jnp.asarray(idx), jnp.ones(P, bool),
                            jnp.full(P, 4.0))
            for g in (ft, fd):
                g._append_edge(a, b, _t(idx).long(), torch.ones(P,
                                                                dtype=bool),
                               torch.full((P,), 4.0))
    fj.solve_GN_rays()
    ft.solve_GN_rays()
    fd.solve_GN_rays()
    got = ft.frames.T_WC[:n_kf].numpy()
    np.testing.assert_allclose(got, np.asarray(fj.frames.T_WC[:n_kf]),
                               atol=1e-4)
    np.testing.assert_array_equal(got, fd.frames.T_WC[:n_kf].numpy())
    assert np.abs(got - np.asarray(T_init)).max() > 1e-3   # it moved


# -- growth and the solve from one carried-over state --------------------------


def test_growth_and_solve_from_jax_state():
    """Edges past the initial capacity double the buffers
    (``tests/test_ba.py::test_factor_graph_edge_growth``); the JAX graph's
    state, carried over by ``convert.slam_state_from_jax``, solves to the
    same poses."""
    key = jax.random.PRNGKey(12)
    n_kf, P = 6, 128
    kw, kp = jax.random.split(key)
    pts_w = jax.random.normal(kp, (P, 3)) * jnp.array(
        [1.0, 1.0, 0.5]) + jnp.array([0.0, 0.0, 4.0])
    T_true = [js.identity()]
    for i in range(1, n_kf):
        T_true.append(js.mul(T_true[-1], js.exp(
            0.12 * jax.random.normal(jax.random.fold_in(kw, i), (7,)))))
    T_true = jnp.stack(T_true)
    Xs = jax.vmap(lambda T: js.act(js.inv(T), pts_w))(T_true)
    pairs = [(i, j) for i in range(n_kf) for j in range(i + 1, n_kf)]
    noise = 0.04 * jax.random.normal(jax.random.fold_in(key, 5), (n_kf, 7))
    T_init = jax.vmap(js.retr)(T_true, noise.at[0].set(0.0))

    kfs = JStore(8, P, 4, 8, (8, 16), donate=False)
    kfs.n_size = n_kf
    kfs.T_WC = kfs.T_WC.at[:n_kf].set(T_init)
    kfs.X = kfs.X.at[:n_kf].set(Xs)
    kfs.C = kfs.C.at[:n_kf].set(5.0)
    kfs.N = kfs.N.at[:n_kf].set(1)
    fj = jfg.FactorGraph(None, None, kfs, jfg.FactorGraphConfig(edge_capacity=8),
                         jba.BAConfig(max_iters=10, point_chunk=P),
                         jfg.MatchingConfig())
    idx = jnp.arange(P, dtype=jnp.int32)
    for i, j in pairs:
        for a, b in ((i, j), (j, i)):
            assert fj.ensure_capacity(fj.n_edges + 1)
            fj._append_edge(a, b, idx, jnp.ones(P, bool), jnp.full(P, 4.0))
    E = 2 * len(pairs)
    assert fj.n_edges == E == 30 and fj.capacity == 32

    tk = TStore(8, P, 4, 8, (8, 16), device="cpu")
    ft = tfg.FactorGraph(None, None, tk, FactorGraphConfig(edge_capacity=8),
                         BAConfig(max_iters=10), MatchingConfig())
    names = convert.KEYFRAME_FIELDS
    convert.slam_state_from_jax(
        {"n_size": kfs.n_size, **{n: np.asarray(getattr(kfs, n).astype(
            jnp.float32) if n == "feat" else getattr(kfs, n))
            for n in names}},
        {"n_edges": fj.n_edges, **{n: np.asarray(getattr(fj, n))
                                   for n in convert.EDGE_FIELDS}}, tk, ft)
    assert ft.capacity == 32 and ft.n_edges == E and len(tk) == n_kf
    assert float(ft.edge_mask.sum()) == E and ft.edges_dropped == 0
    assert ft.unique_kf_idx().tolist() == list(range(n_kf))
    _assert_edges_equal(ft, fj)

    fj.solve_GN_rays()
    ft.solve_GN_rays()
    np.testing.assert_allclose(tk.T_WC[:n_kf].numpy(),
                               np.asarray(fj.frames.T_WC[:n_kf]), atol=1e-4)
    err = jax.vmap(lambda a, b: js.log(js.mul(js.inv(a), b)))(
        T_true, jnp.asarray(tk.T_WC[:n_kf].numpy()))
    assert float(jnp.abs(err).max()) < 1e-3

    # the same growth in the port, row by row, and a hard cap
    f2 = tfg.FactorGraph(None, None, tk,
                         FactorGraphConfig(edge_capacity=8,
                                           max_edge_capacity=16),
                         BAConfig(max_iters=2), MatchingConfig())
    for i, j in pairs:
        for a, b in ((i, j), (j, i)):
            if not f2.ensure_capacity(f2.n_edges + 1):
                f2.edges_dropped += 1
                continue
            f2._append_edge(a, b, torch.arange(P), torch.ones(P, dtype=bool),
                            torch.full((P,), 4.0))
    assert f2.capacity == 16 and f2.n_edges == 16
    assert f2.edges_dropped == E - 16


# -- the edge chain after the decode (``factor_graph._edge_chain``) ------------


@torch.no_grad()
def _add_factors_reference(bufs, params, feat, pos, ii_arr, jj_arr, consec,
                           e0, min_match_frac, strict, Q_conf, cfg, mcfg,
                           matcher, model_mod, query_stride):
    """add_factors' device pipeline as one eager body, as it stood before
    the chain after the decode was split off for its CUDA graph: decode,
    match, gate, masked two-way append."""
    out = model_mod.inference_symmetric(
        params, feat.index_select(0, ii_arr), pos.index_select(0, ii_arr),
        feat.index_select(0, jj_arr), pos.index_select(0, jj_arr), cfg)
    b = ii_arr.shape[0]
    X11 = torch.cat([out["Xii"], out["Xjj"]], dim=0)
    X21 = torch.cat([out["Xji"], out["Xij"]], dim=0)
    D11 = torch.cat([out["Dii"], out["Djj"]], dim=0)
    D21 = torch.cat([out["Dji"], out["Dij"]], dim=0)
    if matcher == "dense":
        idx, valid = tdense.match_dense(
            X11, X21, D11, D21, dist_thresh=mcfg.dist_thresh,
            fine_radius=mcfg.radius,
            fine_dilation=max(int(mcfg.dilation_max), 1),
            lambda_init=mcfg.lambda_init,
            convergence_thresh=mcfg.convergence_thresh,
            query_stride=query_stride)
    else:
        kw = mcfg._asdict()
        kw["subpixel"] = False
        kw["max_iter"] = max(int(kw["max_iter"]), 10)
        idx, valid = tmatching.match(X11, X21, D11, D21, **kw)
    idx = idx.to(torch.int32)
    hw = X11.shape[1] * X11.shape[2]
    flat = lambda a: a.reshape(b, hw).contiguous()
    m = {"idx_i2j": idx[:b].contiguous(), "idx_j2i": idx[b:].contiguous(),
         "valid_match_j": valid[:b], "valid_match_i": valid[b:],
         "Qii": flat(out["Qii"]), "Qjj": flat(out["Qjj"]),
         "Qji": flat(out["Qji"]), "Qij": flat(out["Qij"])}
    Qj, Qi, frac_j, frac_i = tfg._gate_edges(m, Q_conf, query_stride)
    invalid = (torch.minimum(frac_j, frac_i) < min_match_frac) & ~consec
    keep = ~invalid
    if strict:
        keep = keep & ~invalid.any()
    ii_buf, jj_buf, idx_buf, vm_buf, Q_buf = bufs
    E_cap = ii_buf.shape[0] - 1
    kprefix = torch.cumsum(keep, 0) - keep.to(torch.int64)
    rows_fwd = e0.to(torch.int64) + 2 * kprefix
    rows_fwd = torch.where(keep & (rows_fwd + 1 < E_cap), rows_fwd,
                           torch.full_like(rows_fwd, E_cap))
    rows = torch.clamp(tfg._pairs(rows_fwd, rows_fwd + 1), max=E_cap)
    i32, j32 = ii_arr.to(torch.int32), jj_arr.to(torch.int32)
    ii_buf[rows] = tfg._pairs(i32, j32)
    jj_buf[rows] = tfg._pairs(j32, i32)
    idx_buf[rows] = tfg._pairs(m["idx_i2j"], m["idx_j2i"])
    vm_buf[rows] = tfg._pairs(m["valid_match_j"][..., 0],
                              m["valid_match_i"][..., 0])
    Q_buf[rows] = tfg._pairs(Qj, Qi)
    fits = torch.clamp((E_cap - e0) // 2, min=0)
    n_new = e0 + 2 * torch.minimum(keep.sum().to(torch.int32), fits)
    return torch.stack([frac_j, frac_i]), n_new


def _network_graph(tp):
    """``_port_graph`` with the real network of the test's configuration
    (random weights) in place of the oracle, and its features."""
    fg = _port_graph(tp, tmast3r)
    model = fg.params = tmast3r.init_params(
        TCFG, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    img = torch.randint(0, 256, (N_KF, H, W, 3), generator=g,
                        dtype=torch.uint8)
    feat, pos = tmast3r.encode(model, img, TCFG)
    fg.frames.feat[:N_KF] = feat.to(fg.frames.feat.dtype)
    fg.frames.pos[:N_KF] = pos
    return fg


# (ii, jj, min_match_frac, strict, capacity, e0, matcher, point_stride)
CHAIN_CASES = {
    "loop_batch": ([0, 1, 2, 0], [1, 2, 3, 3], 0.1, False, 16, 0,
                   "iter_proj", 1),
    "strict_rejects": ([3, 3], [0, 1], 0.9999, True, 16, 2, "dense", 4),
    "strict_keeps": ([3, 3], [0, 1], 0.1, True, 16, 2, "dense", 4),
    "capacity_clamped": ([0, 1, 2], [1, 2, 3], 0.0, False, 5, 2,
                         "iter_proj", 1),
    "dense_gated": ([2, 0, 1], [3, 3, 3], 0.999, False, 16, 4, "dense", 4),
    "network": ([0, 1, 0], [1, 3, 2], 0.05, False, 16, 0, "iter_proj", 1),
}


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_edge_chain_equals_the_eager_body(oracle_params, case):
    """Decode, then the factored chain (match -> gate -> append, the body
    that the CUDA graph captures) through ``_add_factors_body`` with the
    graph as its owner: the same edge buffers, fractions and device count
    as the pipeline written as one eager body, with strict proposals and
    with an append clamped at the capacity (a nonzero starting count)."""
    ii, jj, frac, strict, cap, e0, matcher, stride = CHAIN_CASES[case]
    _, tp = oracle_params
    fg = (_network_graph(tp) if case == "network" else
          _port_graph(tp, toracle, capacity=cap, matcher=matcher,
                      point_stride=stride))
    ii_a, jj_a = torch.tensor(ii), torch.tensor(jj)
    consec = ii_a == jj_a - 1
    e0 = torch.tensor(e0, dtype=torch.int32)
    common = (fg.params, fg.frames.feat, fg.frames.pos, ii_a, jj_a, consec,
              e0, frac, strict, float(fg.cfg.Q_conf), fg.model_cfg, fg.mcfg)
    ref_bufs = tuple(b.clone() for b in fg._bufs)
    want = _add_factors_reference(ref_bufs, *common, matcher, fg.model_mod,
                                  fg.query_stride)
    with timing.recording() as rec, timing.span("fg.add_factors") as sp:
        got = tfg._add_factors_body(fg._bufs, *common, fg.downsample,
                                    matcher, fg.model_mod, fg.query_stride,
                                    owner=fg, span=sp)
    assert [s.attrs["graph"] for s in rec.spans
            if s.name == "fg.add_factors"] == ["eager"]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(fg._bufs, ref_bufs):
        assert torch.equal(a, b)
    n_new = int(got[1])
    if case == "strict_rejects":
        assert n_new == int(e0)
    elif case == "capacity_clamped":
        assert n_new == cap - 1      # one pair fits beside the two rows
    else:
        assert n_new > int(e0)
