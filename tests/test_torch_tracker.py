"""Port Sim(3) Gauss-Newton trackers == the JAX trackers (pose atol 1e-4:
the same fp32 normal equations reduced in another order; ``iters`` and
``failed`` exactly equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.lie import sim3 as js
from mast3r_slam_tpu.slam import tracker as jt
from mast3r_slam_tpu_torch.slam import tracker as tt

# the suite runs several test processes side by side on a few cores;
# one intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

H, W = 24, 32
K = np.array([[30.0, 0, 16], [0, 30, 12], [0, 0, 1]], np.float32)


def _problem(seed, noise=0.002, outliers=0.05):
    """Keyframe points Xk, frame points Xf = T_true^-1 Xk (+ noise and a
    few gross outliers), confidences and validity."""
    rng = np.random.default_rng(seed)
    n = H * W
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    z = 3.0 + 0.5 * np.sin(u / 5.0) * np.cos(v / 4.0)
    Xk = np.stack([(u - 16) / 30.0 * z, (v - 12) / 30.0 * z, z],
                  -1).reshape(n, 3).astype(np.float32)
    xi = np.array([0.05, -0.03, 0.02, 0.01, -0.02, 0.015, 0.01], np.float32)
    T_true = js.exp(jnp.asarray(xi))
    Xf = np.asarray(js.act(js.inv(T_true), jnp.asarray(Xk)))
    Xf = Xf + rng.standard_normal(Xf.shape).astype(np.float32) * noise
    bad = rng.random(n) < outliers
    Xf[bad] += rng.standard_normal((bad.sum(), 3)).astype(np.float32)
    Qk = (1.5 + rng.random((n, 1)) * 3).astype(np.float32)
    valid = rng.random((n, 1)) > 0.1
    return Xf.astype(np.float32), Xk, Qk, valid


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _cmp(rj, rt):
    np.testing.assert_allclose(rt.T_CkCf.numpy(), np.asarray(rj.T_CkCf),
                               atol=1e-4)
    assert int(rj.iters) == rt.iters
    assert bool(rj.failed) == bool(rt.failed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ray_dist_gn_matches_jax(seed):
    Xf, Xk, Qk, valid = _problem(seed)
    T0 = np.asarray(js.identity())
    cfg_j, cfg_t = jt.TrackerConfig(), tt.TrackerConfig()
    rj = jt.opt_pose_ray_dist_sim3(*_j(Xf, Xk, T0, Qk, valid), cfg_j)
    rt = tt.opt_pose_ray_dist_sim3(*_t(Xf, Xk, T0, Qk, valid), cfg_t)
    _cmp(rj, rt)
    assert 1 < rt.iters < cfg_t.max_iters


@pytest.mark.parametrize("seed", [0, 3])
def test_calib_gn_matches_jax(seed):
    Xf, Xk, Qk, valid = _problem(seed)
    T0 = np.asarray(js.identity())
    cfg_j, cfg_t = jt.TrackerConfig(), tt.TrackerConfig()
    mj, vmj = jt.calib_measurements(jnp.asarray(Xk), jnp.asarray(K), (H, W),
                                    cfg_j.depth_eps)
    mt, vmt = tt.calib_measurements(torch.from_numpy(Xk), torch.from_numpy(K),
                                    (H, W), cfg_t.depth_eps)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_array_equal(vmt.numpy(), np.asarray(vmj))
    rj = jt.opt_pose_calib_sim3(*_j(Xf, Xk, T0, Qk, valid), mj, vmj,
                                jnp.asarray(K), (H, W), cfg_j)
    rt = tt.opt_pose_calib_sim3(*_t(Xf, Xk, T0, Qk, valid), mt, vmt,
                                torch.from_numpy(K), (H, W), cfg_t)
    _cmp(rj, rt)


def test_no_valid_matches_fails_like_jax():
    """All-zero H factorizes thanks to the 1e-8 ridge but must still raise
    ``failed`` (tracker.py:95-98) so the system relocalizes."""
    Xf, Xk, Qk, _ = _problem(4)
    valid = np.zeros((Xf.shape[0], 1), bool)
    T0 = np.asarray(js.identity())
    rj = jt.opt_pose_ray_dist_sim3(*_j(Xf, Xk, T0, Qk, valid),
                                   jt.TrackerConfig())
    rt = tt.opt_pose_ray_dist_sim3(*_t(Xf, Xk, T0, Qk, valid),
                                   tt.TrackerConfig())
    _cmp(rj, rt)
    assert bool(rt.failed) and rt.iters == 1
    np.testing.assert_array_equal(rt.T_CkCf.numpy(), T0)


def test_solve7_flags_singular_and_nonfinite():
    H7 = torch.eye(7)
    H7[3, 3] = -1.0                 # indefinite: Cholesky fails
    tau, ok = tt._solve7(H7, torch.ones(7))
    assert not bool(ok) and torch.equal(tau, torch.zeros(7))
    tau, ok = tt._solve7(torch.eye(7) * 2.0, torch.ones(7))
    assert bool(ok)
    np.testing.assert_allclose(tau.numpy(), np.full(7, 0.5), atol=1e-6)
