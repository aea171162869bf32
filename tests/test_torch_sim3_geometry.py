"""Port Sim(3), geometry and robust helpers == the JAX package's
(fp32, atol 1e-5 plus rtol 1e-6: both evaluate the same closed forms; the
slack covers summation order and libm differences, and the relative part
the few-ulp rounding of values of order 10 at the largest test scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import geometry as jgeo
from mast3r_slam_tpu import robust as jrob
from mast3r_slam_tpu.lie import sim3 as js
from mast3r_slam_tpu_torch import geometry as tgeo
from mast3r_slam_tpu_torch import robust as trob
from mast3r_slam_tpu_torch.lie import sim3 as ts

# the suite runs several test processes side by side on a few cores;
# one intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

ATOL = 1e-5


def _xi(rng, n, scale):
    return (rng.standard_normal((n, 7)) * scale).astype(np.float32)


def _pair(fj, ft, *arrs, atol=ATOL):
    a = np.asarray(fj(*[jnp.asarray(x) for x in arrs]))
    b = ft(*[torch.from_numpy(np.array(x)) for x in arrs]).numpy()
    np.testing.assert_allclose(b, a, atol=atol, rtol=1e-6)
    return b


@pytest.mark.parametrize("scale", [1e-5, 1e-3, 0.3, 1.0])
def test_exp_log_act_inv_mul_retr(scale):
    rng = np.random.default_rng(int(scale * 1e5) + 1)
    xi = _xi(rng, 64, scale)
    T = _pair(js.exp, ts.exp, xi)
    _pair(js.log, ts.log, T)
    X = rng.standard_normal((64, 3)).astype(np.float32)
    _pair(js.act, ts.act, T, X)
    _pair(js.inv, ts.inv, T)
    T2 = np.asarray(js.exp(jnp.asarray(_xi(rng, 64, scale))))
    _pair(js.mul, ts.mul, T, T2)
    _pair(js.rel, ts.rel, T, T2)
    _pair(js.retr, ts.retr, T, xi)
    _pair(js.matrix, ts.matrix, T)
    v = rng.standard_normal((64, 7)).astype(np.float32)
    _pair(js.apply_adj_inv_T, ts.apply_adj_inv_T, T, v)


def test_mul_chain_keeps_unit_quaternion():
    """|q| stays 1 over many compositions (mul renormalizes, sim3.py:164)."""
    rng = np.random.default_rng(7)
    T = ts.identity()
    Tj = js.identity()
    for _ in range(400):
        xi = _xi(rng, 1, 0.05)[0]
        T = ts.mul(T, ts.exp(torch.from_numpy(xi)))
        Tj = js.mul(Tj, js.exp(jnp.asarray(xi)))
    assert abs(float(torch.linalg.norm(T[3:7])) - 1.0) < 1e-6
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-3)


def test_jacobians_and_projection():
    rng = np.random.default_rng(3)
    Y = (rng.standard_normal((50, 3)) + [0, 0, 3]).astype(np.float32)
    _pair(jgeo.ray_dist_pose_jacobian, tgeo.ray_dist_pose_jacobian, Y)
    K = np.array([[80.0, 0, 48], [0, 80, 32], [0, 0, 1]], np.float32)
    _pair(lambda P, K_: jgeo.calib_pose_jacobian(P, K_, 1e-6),
          lambda P, K_: tgeo.calib_pose_jacobian(P, K_, 1e-6), Y, K)
    a = jgeo.point_to_ray_dist(jnp.asarray(Y), jacobian=True)
    b = tgeo.point_to_ray_dist(torch.from_numpy(Y), jacobian=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=ATOL)
    T = np.array(js.exp(jnp.asarray(_xi(rng, 1, 0.2))))[0]
    a = jgeo.act_Sim3(jnp.asarray(T), jnp.asarray(Y), jacobian=True)
    b = tgeo.act_Sim3(torch.from_numpy(T), torch.from_numpy(Y), jacobian=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=ATOL)
    a = jgeo.project_calib(jnp.asarray(Y), jnp.asarray(K), (64, 96),
                           jacobian=True, border=-10, z_eps=1e-6)
    b = tgeo.project_calib(torch.from_numpy(Y), torch.from_numpy(K), (64, 96),
                           jacobian=True, border=-10, z_eps=1e-6)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-4)
    fx, fy, cx, cy = tgeo.decompose_K(torch.from_numpy(K))
    assert (float(fx), float(fy), float(cx), float(cy)) == (80, 80, 48, 32)


def test_constrain_points_to_ray_and_pixel_coords():
    rng = np.random.default_rng(5)
    h, w = 6, 8
    Xs = (rng.standard_normal((2, h * w, 3)) + [0, 0, 4]).astype(np.float32)
    K = np.array([[10.0, 0, 4], [0, 10, 3], [0, 0, 1]], np.float32)
    _pair(lambda X, K_: jgeo.constrain_points_to_ray((h, w), X, K_),
          lambda X, K_: tgeo.constrain_points_to_ray((h, w), X, K_), Xs, K)
    np.testing.assert_array_equal(tgeo.pixel_coords((h, w)).numpy(),
                                  np.asarray(jgeo.pixel_coords((h, w))))


def test_huber_and_converged():
    rng = np.random.default_rng(9)
    r = (rng.standard_normal(100) * 3).astype(np.float32)
    _pair(jrob.huber, trob.huber, r)
    _pair(jrob.tukey, trob.tukey, r)
    for old, new, d in [(np.inf, 1.0, 1.0), (1.0, 0.9999, 1.0),
                        (1.0, 0.5, 1e-5), (1.0, 0.5, 1.0), (0.0, 0.0, 1.0)]:
        delta = np.full(7, d / np.sqrt(7), np.float32)
        a = bool(jrob.converged(1e-3, 1e-3, jnp.float32(old), jnp.float32(new),
                                jnp.asarray(delta)))
        b = bool(trob.converged(1e-3, 1e-3, torch.tensor(old),
                                torch.tensor(new), torch.from_numpy(delta)))
        assert a == b, (old, new, d)


@pytest.mark.parametrize("weighted", [False, True])
def test_estimate_focal_on_an_oracle_pointmap(weighted):
    """The focal of the oracle's pinhole (0.8 w) from its mono pointmap,
    with 5% of the points moved off their rays, against JAX: 1e-5
    relative (both run the same 10 IRLS rounds in fp32 and sum in another
    order)."""
    from mast3r_slam_tpu.models import mast3r as jm
    from mast3r_slam_tpu.models import oracle as jo

    cfg = jm.MASt3RConfig(img_size=(64, 96), enc_embed_dim=64, desc_dim=8,
                          dtype="float32")
    h, w = cfg.img_size
    params = jo.make_params(js.identity()[None], desc_dim=8)
    feat, pos = jo.encode_fid(params, jnp.asarray([0]), cfg)
    X, C = jo.inference_mono(params, feat, pos, cfg)
    X, C = np.array(X[0]), np.array(C[0, :, 0])
    rng = np.random.default_rng(3)
    bad = rng.random(h * w) < 0.05
    X[bad, :2] += rng.standard_normal((int(bad.sum()), 2)).astype(np.float32)
    conf = C if weighted else None
    fj = float(jgeo.estimate_focal(jnp.asarray(X), (h, w), conf=None if conf
                                   is None else jnp.asarray(conf)))
    ft = tgeo.estimate_focal(torch.from_numpy(X), (h, w), conf=None if conf
                             is None else torch.from_numpy(conf))
    assert ft.dtype == torch.float32 and ft.shape == ()
    np.testing.assert_allclose(float(ft), fj, rtol=1e-5)
    assert abs(float(ft) / (0.8 * w) - 1.0) < 1e-2
