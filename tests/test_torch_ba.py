"""Port global bundle adjustment == the JAX package's ``slam/ba.py`` on the
same numpy inputs.

Tolerances: the per-edge Hessians and gradients are the same fp32 sums taken
in another order (JAX scans point chunks through einsums, the port's plain
version is one batched matmul), held to 1e-5 of the largest entry; the
assembled system is a scatter of those blocks, equal to 1e-6 relative; the
solves and the final poses of ``gauss_newton_*`` are held to 1e-4 (the
solvers' fixtures are those of ``tests/test_ba.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import geometry as jgeometry
from mast3r_slam_tpu.lie import sim3 as js
from mast3r_slam_tpu.slam import ba as jba
from mast3r_slam_tpu_torch.slam import ba as tba

torch.set_num_threads(1)

H, W = 24, 32
P = H * W
KMAT = np.array([[30.0, 0, 16], [0, 30, 12], [0, 0, 1]], np.float32)


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _edge_fixture(seed, degenerate=True):
    """4 keyframes on a short path, 8 two-way edges with random matches,
    confidences straddling the gates, one masked edge; with ``degenerate``
    a point at the origin and a point behind the camera."""
    rng = np.random.default_rng(seed)
    n_kf = 4
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    T = [js.identity()]
    for i in range(1, n_kf):
        xi = 0.06 * rng.standard_normal(7).astype(np.float32)
        T.append(js.mul(T[-1], js.exp(jnp.asarray(xi))))
    T = np.asarray(jnp.stack(T))
    Xs = []
    for k in range(n_kf):
        z = 3.0 + 0.5 * np.sin(u / 5.0 + k) * np.cos(v / 4.0)
        z = z + 0.01 * rng.standard_normal(z.shape)
        Xs.append(np.stack([(u - 16) / 30.0 * z, (v - 12) / 30.0 * z, z],
                           -1).reshape(P, 3))
    Xs = np.stack(Xs).astype(np.float32)
    Cs = rng.uniform(-0.3, 5.0, (n_kf, P)).astype(np.float32)
    pairs = [(0, 1), (1, 2), (2, 3), (0, 3)]
    ii = np.array([a for p in pairs for a in p], np.int32)
    jj = np.array([a for p in pairs for a in p[::-1]], np.int32)
    E = ii.shape[0]
    # matches near the identity, so the residuals are small and the Huber
    # weight takes both branches
    jitter = rng.integers(-2, 3, (E, P))
    idx = np.clip(np.arange(P)[None] + jitter, 0, P - 1).astype(np.int32)
    valid = rng.random((E, P)) > 0.1
    Q = rng.uniform(1.0, 4.5, (E, P)).astype(np.float32)
    mask = np.ones(E, np.float32)
    mask[5] = 0.0
    if degenerate:
        Xs[1, 5] = 0.0            # a point at the origin: 1 / d is inf
        Xs[2, 7, 2] = -1.0        # a point behind the camera
        valid[0, 5] = True        # edge 0 (ii=0, jj=1) measures pixel 5
        valid[3, 7] = True        # edge 3 (ii=2, jj=1): idx ~ 7 of kf 2
        idx[3, 7] = 7
        idx[2, 9] = 5             # edge 2 (ii=1): gathers the origin point
        valid[2, 9] = False       # ... as an invalid match
    return T, Xs, Cs, ii, jj, idx, valid, Q, mask


def _close(got, ref, rel):
    ref = np.asarray(ref)
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    scale = np.nanmax(np.abs(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("mode", ["rays", "calib", "points"])
def test_edge_terms_match_jax(mode, stride):
    T, Xs, Cs, ii, jj, idx, valid, Q, mask = _edge_fixture(0)
    kw = dict(point_stride=stride)
    cj, ct = jba.BAConfig(point_chunk=256, **kw), tba.BAConfig(**kw)
    if mode == "calib":
        Hj, gj = jba._edge_terms_calib(
            *_j(T, Xs, Cs, KMAT, ii, jj, idx, valid, Q, mask), (H, W), cj)
        Ht, gt = tba._edge_terms_calib(
            *_t(T, Xs, Cs, KMAT, ii, jj, idx, valid, Q, mask), (H, W), ct)
    else:
        fj = getattr(jba, f"_edge_terms_{mode}")
        ft = getattr(tba, f"_edge_terms_{mode}")
        Hj, gj = fj(*_j(T, Xs, Cs, ii, jj, idx, valid, Q, mask), cj)
        Ht, gt = ft(*_t(T, Xs, Cs, ii, jj, idx, valid, Q, mask), ct)
    assert Ht.shape == (8, 14, 14) and gt.shape == (8, 14)
    _close(Ht, Hj, 1e-5)
    _close(gt, gj, 1e-5)
    # the masked edge contributes nothing (or NaN where JAX has NaN)
    assert not np.any(np.nan_to_num(Ht[5].numpy()))


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("mode", ["rays", "calib", "points"])
def test_edge_system_plain_matches_jax(mode, stride):
    """``edge_system_plain`` (the plain version of the fused
    ``ba_edge_terms`` kernel: edge terms, conjugation and assembly) == JAX
    ``_edge_terms_*`` + ``_assemble``: edge blocks to 1e-5 of the largest
    entry (sums in another order), the assembled system to 1e-5, NaN where
    JAX has NaN; pinned pose 0 and the inactive slot stay zero."""
    T, Xs, Cs, ii, jj, idx, valid, Q, mask = _edge_fixture(0)
    n_kf = 3                           # keyframe 3 is an inactive slot
    K_cap, pin = T.shape[0], 1
    kw = dict(point_stride=stride)
    cj, ct = jba.BAConfig(point_chunk=256, **kw), tba.BAConfig(**kw)
    if mode == "calib":
        Hj, gj = jba._edge_terms_calib(
            *_j(T, Xs, Cs, KMAT, ii, jj, idx, valid, Q, mask), (H, W), cj)
        calib = tba._calib_args(torch.from_numpy(KMAT), (H, W))
    else:
        Hj, gj = getattr(jba, f"_edge_terms_{mode}")(
            *_j(T, Xs, Cs, ii, jj, idx, valid, Q, mask), cj)
        calib = None
    Hdj, gdj = jba._assemble(Hj, gj, *_j(ii, jj), jnp.asarray(n_kf), K_cap,
                             pin)
    Ht, gt, Hd, gd = tba.edge_system_plain(
        mode, *_t(T, Xs, Cs, ii, jj, idx, valid, Q, mask), n_kf, K_cap, pin,
        ct, calib=calib)
    _close(Ht, Hj, 1e-5)
    _close(gt, gj, 1e-5)
    _close(Hd, Hdj, 1e-5)
    _close(gd, gdj, 1e-5)
    assert not Hd[:7].any() and not Hd[21:].any() and not gd[21:].any()


def test_edge_terms_gates_bite():
    """The fixture's gates all fire: without the degenerate points nothing
    is NaN, a masked edge is zero, and confidences below the thresholds
    change the result."""
    T, Xs, Cs, ii, jj, idx, valid, Q, mask = _edge_fixture(1, False)
    cfg = tba.BAConfig()
    args = _t(T, Xs, Cs, ii, jj, idx, valid, Q, mask)
    Ht, gt = tba._edge_terms_rays(*args, cfg)
    assert torch.isfinite(Ht).all() and torch.isfinite(gt).all()
    assert float(Ht[5].abs().max()) == 0.0 and float(Ht[4].abs().max()) > 0
    loose = tba.BAConfig(Q_conf=0.0, C_conf=-1.0)
    H2, _ = tba._edge_terms_rays(*args, loose)
    assert float((H2 - Ht).abs().max()) > 1e-3 * float(Ht.abs().max())


def test_edge_prep_stride_keeps_full_map_indices():
    T, Xs, Cs, ii, jj, idx, valid, Q, mask = _edge_fixture(2, False)
    pj = jba._edge_prep(*_j(Xs, Cs, ii, jj, idx, valid), stride=4)
    pt = tba._edge_prep(*_t(Xs, Cs, ii, jj, idx, valid), stride=4)
    np.testing.assert_array_equal(pt.safe_idx.numpy(), np.asarray(pj[4]))
    np.testing.assert_array_equal(pt.XCi[..., :3].numpy(), np.asarray(pj[0]))
    np.testing.assert_array_equal(pt.XCi[..., 3].numpy(), np.asarray(pj[1]))
    np.testing.assert_array_equal(pt.XCj[..., :3].numpy(), np.asarray(pj[2]))
    np.testing.assert_array_equal(pt.XCj[..., 3].numpy(), np.asarray(pj[3]))
    assert pt.safe_idx.shape == (8, P // 4) and int(pt.safe_idx.max()) > P // 4


def test_adj_inv_matrix_matches_jax():
    rng = np.random.default_rng(3)
    T = np.asarray(jax.vmap(js.exp)(jnp.asarray(
        0.3 * rng.standard_normal((5, 7)).astype(np.float32))))
    np.testing.assert_allclose(tba._adj_inv_matrix(*_t(T)).numpy(),
                               np.asarray(jba._adj_inv_matrix(*_j(T))),
                               atol=1e-6)


def test_assemble_matches_jax():
    rng = np.random.default_rng(4)
    E, K_cap, n_kf = 10, 6, 5
    Hd = rng.standard_normal((E, 14, 14)).astype(np.float32)
    gd = rng.standard_normal((E, 14)).astype(np.float32)
    # endpoints include the pinned pose 0 and the inactive slot 5
    ii = np.array([0, 1, 1, 2, 3, 4, 4, 5, 2, 0], np.int32)
    jj = np.array([1, 0, 2, 1, 4, 3, 5, 4, 0, 2], np.int32)
    Hj, gj = jba._assemble(*_j(Hd, gd, ii, jj), jnp.asarray(n_kf), K_cap, 1)
    Ht, gt = tba._assemble(*_t(Hd, gd, ii, jj), n_kf, K_cap, 1)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)
    assert not Ht[:7].any() and not Ht[35:].any()    # pinned, inactive rows


def _spd_system(seed, K_cap=6):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((7 * K_cap, 7 * K_cap)).astype(np.float32)
    scales = np.tile(np.array([1e3, 1e3, 1e3, 1, 1, 1, 30], np.float32), K_cap)
    Hd = (A @ A.T + 7 * K_cap * np.eye(7 * K_cap, dtype=np.float32))
    Hd = Hd * scales[:, None] * scales[None, :]
    return Hd.astype(np.float32), rng.standard_normal(7 * K_cap).astype(
        np.float32)


@pytest.mark.parametrize("solver", ["fp32", "fp64_host"])
def test_solve_matches_jax(solver):
    K_cap, n_kf, pin = 6, 5, 1
    Hd, gd = _spd_system(5, K_cap)
    # as _assemble leaves them: zero rows and columns for the pinned pose 0
    # and the inactive slot 5
    for sl in (slice(0, 7), slice(35, 42)):
        Hd[sl, :] = 0.0
        Hd[:, sl] = 0.0
    dj, fj = jba._solve(*_j(Hd, gd), jnp.asarray(n_kf), K_cap, pin, solver)
    dt, ft = tba._solve(*_t(Hd, gd), n_kf, K_cap, pin, solver)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    dj = np.asarray(dj)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0,
                               atol=1e-4 * np.abs(dj).max())
    # identity diagonals there: a zero step, no failed factorization
    assert not dt[0].any() and not dt[5].any() and dt[1:5].abs().min() > 0


@pytest.mark.parametrize("solver", ["fp32", "fp64_host"])
def test_solve_singular_system_gives_zero_step(solver):
    K_cap = 3
    Hd, gd = _spd_system(6, K_cap)
    Hd[8, 8] = -abs(Hd[8, 8])           # indefinite: Cholesky fails
    dt, _ = tba._solve(*_t(Hd, gd), 3, K_cap, 1, solver)
    assert torch.equal(dt, torch.zeros(K_cap, 7))
    Hd, gd = _spd_system(7, K_cap)
    gd[9] = np.nan                      # non-finite solve
    dt, _ = tba._solve(*_t(Hd, gd), 3, K_cap, 1, solver)
    assert torch.equal(dt, torch.zeros(K_cap, 7))


# -- the solvers, on the fixtures of tests/test_ba.py -------------------------


def _make_world(key, n_kf=5, n_pts=512):
    kw, kp = jax.random.split(key)
    pts_w = jax.random.normal(kp, (n_pts, 3)) * jnp.array(
        [1.0, 1.0, 0.5]) + jnp.array([0.0, 0.0, 4.0])
    T_true = [js.identity()]
    for i in range(1, n_kf):
        xi = 0.12 * jax.random.normal(jax.random.fold_in(kw, i), (7,))
        T_true.append(js.mul(T_true[-1], js.exp(xi)))
    T_true = jnp.stack(T_true)
    Xs = jax.vmap(lambda T: js.act(js.inv(T), pts_w))(T_true)
    return T_true, Xs


def _edges(n_kf, n_pts, extra=()):
    pairs = [(i, i + 1) for i in range(n_kf - 1)] + list(extra)
    ii = np.array([a for p in pairs for a in p], np.int32)
    jj = np.array([a for p in pairs for a in p[::-1]], np.int32)
    E = ii.shape[0]
    idx = np.broadcast_to(np.arange(n_pts, dtype=np.int32), (E, n_pts))
    return (ii, jj, idx, np.ones((E, n_pts), bool),
            np.full((E, n_pts), 4.0, np.float32), np.ones(E, np.float32))


def _pose_err(T_true, T):
    err = jax.vmap(lambda a, b: js.log(js.mul(js.inv(a), b)))(
        jnp.asarray(T_true), jnp.asarray(T))
    return float(jnp.abs(err).max())


def _perturbed(key, T_true, n_kf, sigma, fold):
    noise = sigma * jax.random.normal(jax.random.fold_in(key, fold), (n_kf, 7))
    noise = noise.at[0].set(0.0)
    return jax.vmap(js.retr)(T_true, noise)


@pytest.mark.parametrize("mode,seed,n_kf,n_pts,loop", [
    ("rays", 0, 5, 512, True), ("points", 5, 4, 256, False)])
def test_gauss_newton_world_fixture_matches_jax(mode, seed, n_kf, n_pts, loop):
    """``test_gn_rays_recovers_poses`` (:47) and
    ``test_gn_points_recovers_poses`` (:204)."""
    key = jax.random.PRNGKey(seed)
    T_true, Xs = _make_world(key, n_kf, n_pts)
    Cs = np.full((n_kf, n_pts), 5.0, np.float32)
    edges = _edges(n_kf, n_pts, extra=[(0, n_kf - 1)] if loop else [])
    T_init = _perturbed(key, T_true, n_kf, 0.05, 7)
    fj = getattr(jba, f"gauss_newton_{mode}")
    ft = getattr(tba, f"gauss_newton_{mode}")
    Tj = fj(T_init, Xs, jnp.asarray(Cs), *_j(*edges), jnp.asarray(n_kf),
            jba.BAConfig(max_iters=20, point_chunk=256))
    res = ft(*_t(T_init, Xs, Cs, *edges), n_kf, tba.BAConfig(max_iters=20))
    np.testing.assert_allclose(res.T_WC.numpy(), np.asarray(Tj), atol=1e-4)
    assert _pose_err(T_true, res.T_WC.numpy()) < 1e-3
    assert 1 < res.iters <= 20


def test_gauss_newton_rays_padding_and_stride_match_jax():
    """Capacity padding (``test_ba.py:73``) and ``point_stride`` 4."""
    key = jax.random.PRNGKey(1)
    n_kf, n_pts = 4, 256
    T_true, Xs = _make_world(key, n_kf, n_pts)
    Cs = np.full((n_kf, n_pts), 5.0, np.float32)
    ii, jj, idx, valid, Q, mask = _edges(n_kf, n_pts)
    T_init = np.asarray(_perturbed(key, T_true, n_kf, 0.04, 3))
    K_cap, E_cap, E = 8, 12, ii.shape[0]
    padK = lambda x: np.concatenate(
        [x, np.zeros((K_cap - n_kf,) + x.shape[1:], x.dtype)])
    padE = lambda x: np.concatenate(
        [x, np.zeros((E_cap - E,) + x.shape[1:], x.dtype)])
    T_pad = np.concatenate([T_init, np.asarray(js.identity((K_cap - n_kf,)))])
    args = (T_pad, padK(np.asarray(Xs)), padK(Cs), padE(ii), padE(jj),
            padE(idx), padE(valid), padE(Q), padE(mask))
    for stride in (1, 4):
        Tj = jba.gauss_newton_rays(
            *_j(*args), jnp.asarray(n_kf),
            jba.BAConfig(max_iters=10, point_chunk=128, point_stride=stride))
        res = tba.gauss_newton_rays(
            *_t(*args), n_kf, tba.BAConfig(max_iters=10, point_stride=stride))
        np.testing.assert_allclose(res.T_WC.numpy(), np.asarray(Tj),
                                   atol=1e-4)
        np.testing.assert_array_equal(res.T_WC[n_kf:].numpy(), T_pad[n_kf:])


def test_gauss_newton_calib_matches_jax():
    """The sphere-raycast fixture of ``test_gn_calib_recovers_poses``
    (:106): canonical points on the pixel rays, correspondences the true
    reprojections."""
    key = jax.random.PRNGKey(2)
    n_kf, h, w = 4, 32, 48
    n_pts = h * w
    K_mat = jnp.array([[60.0, 0.0, 24.0], [0.0, 60.0, 16.0], [0.0, 0.0, 1.0]])
    uv = jgeometry.pixel_coords((h, w))
    dirs_cam = jgeometry.backproject(uv, jnp.ones((n_pts, 1)), K_mat)
    center_w, radius = jnp.array([0.0, 0.0, 5.0]), 3.0
    T_true = [js.identity()]
    for i in range(1, n_kf):
        xi = 0.03 * jax.random.normal(jax.random.fold_in(key, i), (7,))
        T_true.append(js.mul(T_true[-1], js.exp(xi)))
    T_true = jnp.stack(T_true)

    def raycast(T):
        t, q, s = js.parts(T)
        dir_w = s * js.quat_act(q, dirs_cam)
        oc = t - center_w
        a = jnp.sum(dir_w * dir_w, axis=-1)
        b = 2.0 * dir_w @ oc
        c = jnp.dot(oc, oc) - radius ** 2
        disc = jnp.maximum(b * b - 4 * a * c, 0.0)
        X_w = t + ((-b - jnp.sqrt(disc)) / (2 * a))[:, None] * dir_w
        return X_w, js.act(js.inv(T), X_w)

    Xw, Xc = zip(*[raycast(T_true[k]) for k in range(n_kf)])
    Xs = jnp.stack(Xc)
    Cs = np.full((n_kf, n_pts), 5.0, np.float32)
    ii_l, jj_l, idx_l, val_l = [], [], [], []
    for a, b in [(i, i + 1) for i in range(n_kf - 1)]:
        for (i, j) in [(a, b), (b, a)]:
            pz, vp = jgeometry.project_calib(
                js.act(js.inv(T_true[i]), Xw[j]), K_mat, (h, w))
            u = jnp.clip(jnp.round(pz[:, 0]), 0, w - 1).astype(jnp.int32)
            v = jnp.clip(jnp.round(pz[:, 1]), 0, h - 1).astype(jnp.int32)
            ii_l.append(i)
            jj_l.append(j)
            idx_l.append(np.asarray(v * w + u))
            val_l.append(np.asarray(vp[:, 0]))
    ii, jj = np.array(ii_l, np.int32), np.array(jj_l, np.int32)
    idx, valid = np.stack(idx_l).astype(np.int32), np.stack(val_l)
    E = ii.shape[0]
    Q, mask = np.full((E, n_pts), 4.0, np.float32), np.ones(E, np.float32)
    T_init = _perturbed(key, T_true, n_kf, 0.02, 9)

    Tj = jba.gauss_newton_calib(
        T_init, Xs, jnp.asarray(Cs), K_mat, *_j(ii, jj, idx, valid, Q, mask),
        jnp.asarray(n_kf), (h, w), jba.BAConfig(max_iters=20, point_chunk=128))
    res = tba.gauss_newton_calib(
        *_t(T_init, Xs, Cs, K_mat, ii, jj, idx, valid, Q, mask), n_kf, (h, w),
        tba.BAConfig(max_iters=20))
    np.testing.assert_allclose(res.T_WC.numpy(), np.asarray(Tj), atol=1e-4)
    assert _pose_err(T_true, res.T_WC.numpy()) < 0.15


# -- the solvers' one loop (``ba.gn_loop``) -------------------------------------


@functools.lru_cache(maxsize=None)
def _loop_world():
    """A perturbed 5-keyframe world with a loop edge, as numpy: T_WCs, Xs,
    Cs, ii, jj, idx, valid, Q, mask."""
    key = jax.random.PRNGKey(3)
    n_kf, n_pts = 5, 256
    T_true, Xs = _make_world(key, n_kf, n_pts)
    Cs = np.full((n_kf, n_pts), 5.0, np.float32)
    edges = _edges(n_kf, n_pts, extra=[(0, n_kf - 1)])
    T_init = _perturbed(key, T_true, n_kf, 0.05, 11)
    return tuple(np.asarray(a) for a in (T_init, Xs, Cs, *edges))


@functools.lru_cache(maxsize=None)
def _calib_world_np():
    """``test_torch_dist_ba._calib_world`` as numpy: (T_WCs, Xs, Cs, ii, jj,
    idx, valid, Q, mask), K_mat, img_size."""
    from test_torch_dist_ba import _calib_world

    args, K_mat, img_size = _calib_world()
    return tuple(np.asarray(a) for a in args), np.asarray(K_mat), img_size


def _solver(solver, residual):
    """(poses, n_kf, solve(T, cfg) -> BAResult): one solver on one world:
    the dense solve, edge-sharded over 2 CPU shards or Schur over 2, on
    ray + distance (``_loop_world``) or pixel + log-depth residuals
    (``_calib_world``)."""
    from mast3r_slam_tpu_torch.parallel import dist_ba, mesh, schur

    if residual == "rays":
        T, Xs, Cs, *edges = _t(*_loop_world())
        K_mat = img_size = None
    else:
        args, K_np, img_size = _calib_world_np()
        T, Xs, Cs, K_mat, *edges = _t(*args[:3], K_np, *args[3:])
    n_kf = T.shape[0]
    if solver == "dense":
        if residual == "rays":
            return T, n_kf, lambda T, cfg: tba.gauss_newton_rays(
                T, Xs, Cs, *edges, n_kf, cfg)
        return T, n_kf, lambda T, cfg: tba.gauss_newton_calib(
            T, Xs, Cs, K_mat, *edges, n_kf, img_size, cfg)
    m = mesh.make_mesh([torch.device("cpu")] * 2)
    if solver == "edge_sharded":
        edges = [mesh.pad_to_multiple(a, 2, 0, False if a.dtype == torch.bool
                                      else 0) for a in edges]
        return T, n_kf, lambda T, cfg: dist_ba.gauss_newton_dist(
            T, Xs, Cs, K_mat, *edges, n_kf, m, cfg, residual, img_size)
    part, order, keep = schur.schur_partition(
        edges[0].numpy(), edges[1].numpy(), edges[5].numpy(), K_cap=n_kf,
        n_shards=2)
    args = ((part.owner, part.int_slot, part.sep_slot)
            + tuple(schur.reorder_edges(order, keep, *edges)))
    return T, n_kf, lambda T, cfg: schur.gauss_newton_schur(
        T, Xs, Cs, K_mat, *args, n_kf, part.I_cap, part.S_cap, m, cfg,
        residual, img_size)


def _stop_rule(case, d):
    """The ``delta_norm`` that stops the loop where ``case`` says, from the
    step norms ``d`` of a loop that never stops."""
    if case == "first":
        return 2.0 * d[0]
    if case == "third":
        assert d[2] < min(d[0], d[1])
        return float(np.sqrt(d[2] * min(d[0], d[1])))
    if case == "never":
        return 0.0
    return 1e-8                  # all pinned: every step norm is 0


@pytest.mark.parametrize("case", ["first", "third", "never", "all_pinned"])
@pytest.mark.parametrize("residual", ["rays", "calib"])
@pytest.mark.parametrize("solver", ["dense", "edge_sharded", "schur"])
def test_gn_loop_stop_rule(solver, residual, case):
    """Each solver's wiring into the one Gauss-Newton loop, whose stop rule
    is a device flag read once at the end: with the rule set to fire at
    the first or third iteration, never, or on the zero steps of an
    all-pinned graph, the solve reports that many iterations, their step
    norms are the prefix of the same solver's never-stopping run, its
    poses are bit-equal to the same solver's run of that many iterations,
    and the caller's poses are untouched."""
    T, n_kf, solve = _solver(solver, residual)
    T0 = T.clone()
    pin = n_kf if case == "all_pinned" else 1
    cfg = tba.BAConfig(max_iters=6, pin=pin, delta_norm=0.0)
    free = solve(T, cfg)
    assert free.iters == cfg.max_iters == len(free.deltas)
    cfg = cfg._replace(delta_norm=_stop_rule(case, free.deltas))
    res = solve(T, cfg)
    expect = {"first": 1, "third": 3, "never": 6, "all_pinned": 1}[case]
    assert res.iters == expect and res.graph == "eager"
    assert list(res.deltas) == list(free.deltas[:expect])
    assert (list(res.deltas) == [0.0]) == (case == "all_pinned")
    short = solve(T, cfg._replace(max_iters=expect, delta_norm=0.0))
    assert short.iters == expect
    assert torch.equal(res.T_WC, short.T_WC)
    if case == "never":
        assert torch.equal(res.T_WC, free.T_WC)
    if case != "all_pinned":
        assert not torch.equal(res.T_WC, T0)
    assert torch.equal(T, T0)            # the caller's poses are kept
