"""Port Sim(3) Gauss-Newton trackers == the JAX trackers (pose atol 1e-4:
the same fp32 normal equations reduced in another order; ``iters`` and
``failed`` exactly equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.lie import sim3 as js
from mast3r_slam_tpu.slam import tracker as jt
from mast3r_slam_tpu_torch import geometry
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
    assert int(rj.iters) == int(rt.iters)
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


@pytest.mark.parametrize("d", [4, 3])
def test_normal_equations_match_jax_gn_step(d):
    """``_normal_eqs_t`` + ``_solve7`` == JAX ``_gn_step_t`` (:60) on random
    component-major residuals and Jacobians: step and cost to 1e-5 relative
    (the same fp32 sums in another order)."""
    rng = np.random.default_rng(d)
    n = 700
    r_t = rng.standard_normal((d, n)).astype(np.float32)
    J_t = rng.standard_normal((d, 7, n)).astype(np.float32)
    si_t = (rng.uniform(0.0, 3.0, (d, n)) * (rng.random((1, n)) > 0.2)).astype(
        np.float32)
    tau_j, cost_j, ok_j = jt._gn_step_t(*_j(si_t, r_t, J_t), 1.345)
    H, g, cost = tt._normal_eqs_t(*_t(si_t, r_t, J_t), 1.345)
    tau, ok = tt._solve7(H, g)
    assert bool(ok) and bool(ok_j)
    tau_j = np.asarray(tau_j)
    np.testing.assert_allclose(tau.numpy(), tau_j, rtol=0,
                               atol=1e-5 * np.abs(tau_j).max())
    np.testing.assert_allclose(float(cost), float(cost_j), rtol=1e-5)
    np.testing.assert_allclose(H.numpy(), H.numpy().T, atol=0)


@pytest.mark.parametrize("calib", [False, True])
def test_gn_step_plain_is_the_pieces(calib):
    """``gn_step_plain`` (the plain version of the ``gn_step`` kernel) packs
    [H, g, cost] of the residual + Jacobian + ``_normal_eqs_t`` pipeline."""
    Xf, Xk, Qk, valid = _t(*_problem(5))
    cfg = tt.TrackerConfig()
    T = torch.tensor([0.02, -0.01, 0.03, 0.0, 0.01, 0.0, 1.0, 1.02])
    T[3:7] /= T[3:7].norm()
    sQ = (torch.sqrt(Qk) * valid)[:, 0]
    if calib:
        proj = tt.CalibProj(30.0, 30.0, 16.0, 12.0, W, H, cfg.pixel_border,
                            cfg.depth_eps)
        si = torch.stack([sQ / cfg.sigma_pixel] * 2 + [sQ / cfg.sigma_depth])
        meas, _ = tt.calib_measurements(Xk, torch.from_numpy(K), (H, W),
                                        cfg.depth_eps)
        tgt = meas.T.contiguous()
        Y = tt._act_t(T, Xf.T)
        pz, vp = geometry.project_calib(Y.T, torch.from_numpy(K), (H, W),
                                        border=cfg.pixel_border,
                                        z_eps=cfg.depth_eps)
        J = -tt._calib_pose_jacobian_t(Y, torch.from_numpy(K), cfg.depth_eps)
        ref = tt._normal_eqs_t(vp.T * si, tgt - pz.T, J, cfg.huber)
    else:
        proj = None
        si = torch.stack([sQ / cfg.sigma_ray] * 3 + [sQ / cfg.sigma_dist])
        tgt, _, _ = tt._ray_dist_t(Xk.T)
        rd, dd, rr = tt._ray_dist_t(tt._act_t(T, Xf.T))
        ref = tt._normal_eqs_t(si, tgt - rd,
                               -tt._ray_dist_pose_jacobian_t(dd, rr),
                               cfg.huber)
    out = tt.gn_step(T, Xf, tgt, si, cfg.huber, proj)
    assert out.shape == (57,)
    scale = float(ref[0].abs().max())
    np.testing.assert_allclose(out[:49].reshape(7, 7).numpy(), ref[0].numpy(),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(out[49:56].numpy(), ref[1].numpy(), rtol=0,
                               atol=1e-5 * float(ref[1].abs().max()))
    np.testing.assert_allclose(float(out[56]), float(ref[2]), rtol=1e-5)


@pytest.mark.parametrize("calib", [False, True])
@pytest.mark.parametrize("max_iters", [50, 2])
def test_gn_solve_plain_matches_jax(calib, max_iters):
    """``gn_solve_plain`` (the plain version of the fused ``gn_step``
    kernel's whole solve) == the JAX ``lax.while_loop`` of ``_run_gn`` on
    the same residuals: pose atol 1e-4, cost rtol 1e-4, ``iters`` and
    ``failed`` equal; with ``max_iters`` 2 and the thresholds at 0 both run
    to the cap."""
    Xf, Xk, Qk, valid = _problem(6)
    cfg_j = jt.TrackerConfig()
    if max_iters != 50:
        cfg_j = cfg_j._replace(max_iters=max_iters, rel_error=0.0,
                               delta_norm=0.0)
    cfg_t = tt.TrackerConfig(**cfg_j._asdict())
    T0 = np.asarray(js.identity())
    sQ = (np.sqrt(Qk) * valid)[:, 0]
    if calib:
        meas, vmeas = jt.calib_measurements(jnp.asarray(Xk), jnp.asarray(K),
                                            (H, W), cfg_j.depth_eps)
        rj = jt.opt_pose_calib_sim3(*_j(Xf, Xk, T0, Qk, valid), meas, vmeas,
                                    jnp.asarray(K), (H, W), cfg_j)
        si = np.stack([sQ / cfg_t.sigma_pixel] * 2
                      + [sQ / cfg_t.sigma_depth]) * np.asarray(vmeas)[:, 0]
        tgt = np.asarray(meas).T
        proj = tt.CalibProj(30.0, 30.0, 16.0, 12.0, W, H, cfg_t.pixel_border,
                            cfg_t.depth_eps)
    else:
        rj = jt.opt_pose_ray_dist_sim3(*_j(Xf, Xk, T0, Qk, valid), cfg_j)
        si = np.stack([sQ / cfg_t.sigma_ray] * 3 + [sQ / cfg_t.sigma_dist])
        tgt = np.asarray(jt._ray_dist_t(jnp.asarray(Xk).T)[0])
        proj = None
    rt = tt.gn_solve_plain(*_t(T0, Xf), *_t(tgt.astype(np.float32),
                                             si.astype(np.float32)),
                           cfg_t, proj)
    _cmp(rj, rt)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-4)
    assert rt.iters.dtype == torch.int32 and rt.failed.dtype == torch.bool
    if max_iters == 2:
        assert int(rt.iters) == 2 and not bool(rt.failed)
