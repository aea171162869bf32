"""The device arithmetic of the fused tracker and BA kernels
(``mast3r_slam_tpu_torch/csrc/gn_math.cuh``), built as host C++ and
driven through ``tests/gn_math_harness.cpp``, against the JAX package and
the port's plain PyTorch versions on the same seeded numpy inputs.

Tolerances: ``solve7`` factors in another order than LAPACK and XLA: the
step within 1e-4 of its largest entry on well-conditioned systems, the ok
flag equal. The retraction uses glibc's sinf/cosf/expm1f, not the
vectorized ones of torch or XLA: 2e-6 absolute on unit-scale poses. The
convergence test and the failed flags are booleans: equal. The
conjugation and the assembly add the same products in the plain version's
order: 1e-6 of the largest entry. A host solve of the tracker sums the
points in order, not in a tree: iterations and failed equal to JAX's, the
pose within 1e-4 (the port's plain trackers are held to the same). A host
edge sum in point order against JAX's chunked einsums: 1e-5 of the
largest entry."""

import ctypes
import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import robust as jrobust
from mast3r_slam_tpu.lie import sim3 as js
from mast3r_slam_tpu.slam import ba as jba
from mast3r_slam_tpu.slam import tracker as jt
from mast3r_slam_tpu_torch import robust as trobust
from mast3r_slam_tpu_torch.lie import sim3 as ts
from mast3r_slam_tpu_torch.slam import ba as tba
from mast3r_slam_tpu_torch.slam import tracker as tt

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "mast3r_slam_tpu_torch" / "csrc"
F = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
I = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_c, _f = ctypes.c_int, ctypes.c_float


@pytest.fixture(scope="module")
def gnm(tmp_path_factory):
    out = tmp_path_factory.mktemp("gnm") / "libgnm.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), "-o", str(out),
         str(pathlib.Path(__file__).parent / "gn_math_harness.cpp")],
        check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    sigs = {
        "h_solve7": ([F, F, F], _c),
        "h_retr": ([F, F, F], None),
        "h_rel": ([F, F, F], None),
        "h_converged": ([_f, _f, _f, _f, F], _c),
        "h_edge_conj": ([F, F, F, F, F], None),
        "h_assemble": ([F, F, I, I, I, I, _c, _c, _c, F, F], None),
        "h_edge_sums": ([_c, F, F, F, I, F, _f, _c, F, _f, _c, F, F, F],
                        None),
        "h_track": ([_c, F, F, F, F, _c, _f, F, _c, _f, _f, F, F,
                     np.ctypeslib.ndpointer(np.int32)], _c),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def f32(a):
    return np.array(a, dtype=np.float32, order="C")


# -- solve7 --------------------------------------------------------------------


def _spd(rng, scales=(1e3, 1e3, 1e3, 1.0, 1.0, 1.0, 30.0)):
    A = rng.standard_normal((7, 7))
    s = np.asarray(scales)
    return f32((A @ A.T + 7 * np.eye(7)) * s[:, None] * s[None, :])


def _solve_cases():
    rng = np.random.default_rng(0)
    cases = [("spd", _spd(rng), f32(rng.standard_normal(7)))]
    cases.append(("spd_unit", _spd(rng, (1.0,) * 7),
                  f32(rng.standard_normal(7))))
    H = _spd(rng)
    H[3, 3] = -abs(H[3, 3])
    cases.append(("indefinite", H, f32(rng.standard_normal(7))))
    r = f32(rng.standard_normal((1, 7)))
    cases.append(("rank_one", f32(r.T @ r), f32(rng.standard_normal(7))))
    cases.append(("zero", np.zeros((7, 7), np.float32),
                  np.zeros(7, np.float32)))
    H = _spd(rng)
    H[2, 5] = H[5, 2] = np.nan
    cases.append(("nan", H, f32(rng.standard_normal(7))))
    H = _spd(rng)
    H[1, 1] = np.inf
    cases.append(("inf_diag", H, f32(rng.standard_normal(7))))
    g = f32(rng.standard_normal(7))
    g[4] = np.nan
    cases.append(("nan_gradient", _spd(rng), g))
    return cases


@pytest.mark.parametrize("case", range(len(_solve_cases())),
                         ids=[c[0] for c in _solve_cases()])
def test_solve7_matches_port_and_jax(gnm, case):
    _, H, g = _solve_cases()[case]
    tau = np.zeros(7, np.float32)
    ok = bool(gnm.h_solve7(f32(H.reshape(-1)), g, tau))
    tau_t, ok_t = tt._solve7(torch.from_numpy(H), torch.from_numpy(g))
    tau_j, ok_j = jt._solve7(jnp.asarray(H), jnp.asarray(g))
    assert ok == bool(ok_t) == bool(ok_j)
    if not ok:
        assert not tau.any()
        return
    ref = np.asarray(tau_j)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(tau, ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(tau, tau_t.numpy(), rtol=0, atol=1e-4 * scale)


# -- Sim(3) --------------------------------------------------------------------


def _xi_cases():
    rng = np.random.default_rng(1)
    return [
        ("generic", f32(0.3 * rng.standard_normal(7))),
        ("large_rotation", f32([0.1, -0.2, 0.3, 1.2, -0.7, 0.9, 0.4])),
        ("theta_sq_below_1e-6", f32([0.01, 0.02, -0.03, 2e-4, -3e-4, 1e-4,
                                     0.2])),
        ("theta_below_1e-2", f32([0.01, 0.02, -0.03, 4e-3, 5e-3, -2e-3,
                                  0.3])),
        ("zero_rotation", f32([0.5, -0.1, 0.2, 0.0, 0.0, 0.0, -0.4])),
        ("small_sigma", f32([0.2, 0.1, -0.3, 0.2, -0.1, 0.3, 0.05])),
        ("tiny_sigma", f32([0.2, 0.1, -0.3, 0.2, -0.1, 0.3, 1e-22])),
        ("zero_sigma_small_theta", f32([0.02, 0.01, 0.0, 1e-3, 0.0, 2e-3,
                                        0.0])),
        ("identity", np.zeros(7, np.float32)),
    ]


@pytest.mark.parametrize("case", range(len(_xi_cases())),
                         ids=[c[0] for c in _xi_cases()])
def test_retr_matches_port_and_jax(gnm, case):
    _, xi = _xi_cases()[case]
    rng = np.random.default_rng(case)
    T = np.asarray(js.exp(jnp.asarray(f32(0.4 * rng.standard_normal(7)))))
    T = f32(T)
    out = np.zeros(8, np.float32)
    gnm.h_retr(T, xi, out)
    ref_j = np.asarray(js.retr(jnp.asarray(T), jnp.asarray(xi)))
    ref_t = ts.retr(torch.from_numpy(T), torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(out, ref_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(out, ref_t, rtol=0, atol=2e-6)
    assert abs(np.linalg.norm(out[3:7]) - 1.0) < 1e-6


def test_rel_matches_port_and_jax(gnm):
    rng = np.random.default_rng(2)
    for _ in range(5):
        Ti, Tj = (f32(np.asarray(js.exp(jnp.asarray(
            f32(0.5 * rng.standard_normal(7)))))) for _ in range(2))
        out = np.zeros(8, np.float32)
        gnm.h_rel(Ti, Tj, out)
        np.testing.assert_allclose(
            out, np.asarray(js.mul(js.inv(jnp.asarray(Ti)), jnp.asarray(Tj))),
            rtol=0, atol=2e-6)
        np.testing.assert_allclose(
            out, ts.rel(torch.from_numpy(Ti), torch.from_numpy(Tj)).numpy(),
            rtol=0, atol=2e-6)


@pytest.mark.parametrize("old,new,tau_scale", [
    (np.inf, 5.0, 1.0), (np.inf, 5.0, 1e-5), (0.0, 0.0, 1.0),
    (10.0, 9.9999, 1.0), (10.0, 9.0, 1.0), (10.0, 9.0, 1e-4),
    (10.0, np.nan, 1.0), (np.nan, 3.0, 1.0), (2.0, 3.0, 1e-2)])
def test_converged_matches_port_and_jax(gnm, old, new, tau_scale):
    tau = f32(np.linspace(-1, 1, 7) * tau_scale)
    got = bool(gnm.h_converged(1e-3, 1e-3, old, new, tau))
    ref_j = bool(jrobust.converged(1e-3, 1e-3, jnp.float32(old),
                                   jnp.float32(new), jnp.asarray(tau)))
    ref_t = bool(trobust.converged(1e-3, 1e-3, torch.tensor(old),
                                   torch.tensor(new), torch.from_numpy(tau)))
    assert got == ref_j == ref_t


# -- BA: conjugation, layout, assembly ------------------------------------------


def test_edge_conjugation_matches_jax_tail(gnm):
    """The tail of JAX ``_edge_terms`` (ba.py:287-297): S = M S0 M^T,
    gj = M g0, [[S, -S], [-S, S]] and [-gj, gj]."""
    rng = np.random.default_rng(3)
    for k in range(6):
        Ti = f32(np.asarray(js.exp(jnp.asarray(
            f32(0.4 * rng.standard_normal(7))))))
        A = rng.standard_normal((7, 9))
        S0 = f32(A @ A.T * 10.0 ** k)
        g0 = f32(rng.standard_normal(7))
        H14 = np.zeros(196, np.float32)
        g14 = np.zeros(14, np.float32)
        gnm.h_edge_conj(Ti, f32(S0.reshape(-1)), g0, H14, g14)
        M = jba._adj_inv_matrix(jnp.asarray(Ti)[None])[0]
        S = M @ jnp.asarray(S0) @ M.T
        gj = M @ jnp.asarray(g0)
        Hj = np.asarray(jnp.block([[S, -S], [-S, S]]))
        gjj = np.asarray(jnp.concatenate([-gj, gj]))
        np.testing.assert_allclose(H14.reshape(14, 14), Hj, rtol=0,
                                   atol=1e-6 * np.abs(Hj).max())
        np.testing.assert_allclose(g14, gjj, rtol=0,
                                   atol=1e-6 * np.abs(gjj).max())


def _assemble_host(gnm, H, g, ii, jj, n_kf, K_cap, pin):
    """The kernel's assembly on the host: the plan of
    ``ba._assembly_plan``, then every run summed by ``gn_math.cuh``. The
    plan's block map must name each run's block and no other."""
    plan = tba._assembly_plan(torch.from_numpy(np.asarray(ii, np.int32)),
                              torch.from_numpy(np.asarray(jj, np.int32)),
                              n_kf, K_cap, pin)
    a = {k: np.ascontiguousarray(v.numpy()) for k, v in plan._asdict().items()}
    n_runs = int((a["run_len"] > 0).sum())
    assert (a["run_len"][n_runs:] == 0).all() and not a["run_count"].any()
    blocks = np.flatnonzero(a["block_run"] >= 0)
    assert sorted(blocks) == sorted(a["run_key"][:n_runs])
    assert (a["block_run"][a["run_key"][:n_runs]] == np.arange(n_runs)).all()
    Hd = np.zeros((7 * K_cap) ** 2, np.float32)
    gd = np.zeros(7 * K_cap, np.float32)
    gnm.h_assemble(np.ascontiguousarray(H, np.float32),
                   np.ascontiguousarray(g, np.float32), a["order"],
                   a["run_start"], a["run_len"], a["run_key"], n_runs,
                   len(ii), K_cap, Hd, gd)
    return Hd, gd


@pytest.mark.parametrize("seed,E,K_cap,n_kf,pin", [
    (4, 10, 6, 5, 1), (5, 3, 4, 4, 1), (6, 24, 9, 7, 2), (7, 1, 2, 2, 1),
    (8, 1300, 280, 270, 1), (9, 1100, 4, 3, 1)])
def test_assembly_matches_jax(gnm, seed, E, K_cap, n_kf, pin):
    """Edge-order assembly with pinned (< pin) and inactive (>= n_kf)
    endpoints; a NaN in a block that lands on the sentinel does not leak.
    With 1,300 edges over 280 keyframes and 1,100 over 4 (runs hundreds
    long), as long sequences give them."""
    rng = np.random.default_rng(seed)
    H = f32(rng.standard_normal((E, 14, 14)))
    g = f32(rng.standard_normal((E, 14)))
    ii = rng.integers(0, K_cap, E).astype(np.int32)
    jj = ((ii + rng.integers(1, K_cap, E)) % K_cap).astype(np.int32)
    ii[0] = 0                         # a pinned endpoint
    H[0, 0:7, 0:7] = np.nan           # its (i, i) block goes to the sentinel
    Hd, gd = _assemble_host(gnm, H, g, ii, jj, n_kf, K_cap, pin)
    Hj, gj = jba._assemble(jnp.asarray(H), jnp.asarray(g), jnp.asarray(ii),
                           jnp.asarray(jj), jnp.asarray(n_kf), K_cap, pin)
    Ht, gt = tba._assemble(*(torch.from_numpy(a) for a in (H, g, ii, jj)),
                           n_kf, K_cap, pin)
    Hd = Hd.reshape(7 * K_cap, 7 * K_cap)
    for ref_H, ref_g in ((np.asarray(Hj), np.asarray(gj)),
                         (Ht.numpy(), gt.numpy())):
        assert np.isfinite(ref_H).all()
        np.testing.assert_allclose(Hd, ref_H, rtol=0,
                                   atol=1e-6 * np.abs(ref_H).max())
        np.testing.assert_allclose(gd, ref_g, rtol=0,
                                   atol=1e-6 * np.abs(ref_g).max())
    assert not Hd[:7 * pin].any() and not Hd[7 * n_kf:].any()
    assert not gd[:7 * pin].any() and not gd[7 * n_kf:].any()


def _ba_fixture(seed, h=12, w=16, n_kf=3):
    rng = np.random.default_rng(seed)
    P = h * w
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    T = [np.asarray(js.identity())]
    for _ in range(1, n_kf):
        T.append(np.asarray(js.mul(jnp.asarray(T[-1]), js.exp(jnp.asarray(
            f32(0.05 * rng.standard_normal(7)))))))
    Xs = []
    for k in range(n_kf):
        z = 3.0 + 0.4 * np.sin(u / 4.0 + k) * np.cos(v / 3.0)
        Xs.append(np.stack([(u - w / 2) / 20.0 * z, (v - h / 2) / 20.0 * z,
                            z], -1).reshape(P, 3))
    Xs = f32(np.stack(Xs))
    Xs[1, 3, 2] = -1.0                 # a point behind the camera
    Cs = f32(rng.uniform(-0.3, 5.0, (n_kf, P)))
    pairs = [(0, 1), (1, 2), (0, 2)]
    ii = np.array([a for p in pairs for a in p], np.int32)
    jj = np.array([a for p in pairs for a in p[::-1]], np.int32)
    E = ii.shape[0]
    idx = np.clip(np.arange(P)[None] + rng.integers(-2, 3, (E, P)), 0,
                  P - 1).astype(np.int32)
    valid = rng.random((E, P)) > 0.1
    Q = f32(rng.uniform(1.0, 4.5, (E, P)))
    mask = np.ones(E, np.float32)
    mask[4] = 0.0
    return np.stack(T).astype(np.float32), Xs, Cs, ii, jj, idx, valid, Q, mask


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("mode", ["rays", "calib", "points"])
def test_edge_system_host_matches_jax(gnm, mode, stride):
    """The whole BA kernel run as host loops (Tij, the per-point sums on the
    pose-independent weights wq, the conjugation, the assembly) against
    JAX ``_edge_terms_*`` + ``_assemble``."""
    h, w = 12, 16
    T, Xs, Cs, ii, jj, idx, valid, Q, mask = _ba_fixture(8 + stride, h, w)
    K_cap, n_kf, pin = T.shape[0], T.shape[0], 1
    cj = jba.BAConfig(point_chunk=64, point_stride=stride)
    ct = tba.BAConfig(point_stride=stride)
    Kmat = f32([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]])
    if mode == "calib":
        Hj, gj = jba._edge_terms_calib(
            *(jnp.asarray(a) for a in (T, Xs, Cs, Kmat, ii, jj, idx, valid,
                                       Q, mask)), (h, w), cj)
        calib = tba.CalibArgs(20.0, 20.0, w / 2, h / 2, w, h)
    else:
        Hj, gj = getattr(jba, f"_edge_terms_{mode}")(
            *(jnp.asarray(a) for a in (T, Xs, Cs, ii, jj, idx, valid, Q,
                                       mask)), cj)
        calib = tba.CalibArgs(1.0, 1.0, 0.0, 0.0, 1, 1)
    Hdj, gdj = jba._assemble(Hj, gj, jnp.asarray(ii), jnp.asarray(jj),
                             jnp.asarray(n_kf), K_cap, pin)

    tensors = [torch.from_numpy(a) for a in (Xs, Cs, ii, jj, idx, valid, Q)]
    pre = tba._edge_prep(*tensors[:6], stride=stride)
    wq = tba._edge_weights(pre, tensors[5], tensors[6], ct, stride).numpy()
    E, Pp = wq.shape
    sig = f32(tba._sigmas(mode, ct) + [0.0])
    border = ct.pixel_border
    intr = f32([calib.fx, calib.fy, calib.cx, calib.cy, border,
                calib.w - 1 - border, calib.h - 1 - border, ct.depth_eps])
    H14 = np.zeros((E, 196), np.float32)
    g14 = np.zeros((E, 14), np.float32)
    for e in range(E):
        Tij = np.zeros(8, np.float32)
        gnm.h_rel(T[ii[e]], T[jj[e]], Tij)
        S0 = np.zeros(49, np.float32)
        g0 = np.zeros(7, np.float32)
        gnm.h_edge_sums(tba.MODES.index(mode), Tij, f32(pre.XCi[e]),
                        f32(pre.XCj[e]), np.ascontiguousarray(
                            pre.safe_idx[e].numpy()), f32(wq[e]),
                        float(mask[e]), Pp, sig, tba._HUBER_K, calib.w, intr,
                        S0, g0)
        gnm.h_edge_conj(T[ii[e]], S0, g0, H14[e], g14[e])
    Hd, gd = _assemble_host(gnm, H14, g14, ii, jj, n_kf, K_cap, pin)
    for got, ref in ((H14.reshape(E, 14, 14), Hj), (g14, gj),
                     (Hd.reshape(7 * K_cap, -1), Hdj), (gd, gdj)):
        ref = np.asarray(ref)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.nanmax(np.abs(ref)))
    assert not np.nan_to_num(H14[4]).any()          # the masked edge


def test_edge_weights_keep_the_bits():
    """sigma * wq == where(valid, sigma * sqrt(Q), 0) bit for bit, as the
    kernel's sqrt-weight must equal the plain version's."""
    T, Xs, Cs, ii, jj, idx, valid, Q, mask = _ba_fixture(11)
    Q[0, :5] = [np.nan, np.inf, 0.0, 1.5, 1.5000001]
    ct = tba.BAConfig()
    tensors = [torch.from_numpy(a) for a in (Xs, Cs, ii, jj, idx, valid, Q)]
    pre = tba._edge_prep(*tensors[:6])
    wq = tba._edge_weights(pre, tensors[5], tensors[6], ct)
    Qt, vm = tensors[6], tensors[5]
    gate = (vm & (Qt > ct.Q_conf) & (pre.XCi[..., 3] > ct.C_conf)
            & (pre.XCj[..., 3] > ct.C_conf))
    for s in tba._sigmas("rays", ct):
        plain = torch.where(gate, s * torch.sqrt(Qt), torch.zeros(()))
        assert torch.equal((s * wq).view(torch.int32),
                           plain.view(torch.int32))
    assert 0 < int(gate.sum()) < gate.numel()


# -- the tracker's loop ----------------------------------------------------------


def _track_problem(seed, n=24 * 32, valid_frac=0.9):
    rng = np.random.default_rng(seed)
    v, u = np.meshgrid(np.arange(24), np.arange(32), indexing="ij")
    z = 3.0 + 0.5 * np.sin(u / 5.0) * np.cos(v / 4.0)
    Xk = f32(np.stack([(u - 16) / 30.0 * z, (v - 12) / 30.0 * z, z],
                      -1).reshape(n, 3))
    T_true = js.exp(jnp.asarray(f32([0.05, -0.03, 0.02, 0.01, -0.02, 0.015,
                                     0.01])))
    Xf = np.asarray(js.act(js.inv(T_true), jnp.asarray(Xk)))
    Xf = Xf + 0.002 * rng.standard_normal(Xf.shape)
    bad = rng.random(n) < 0.05
    Xf[bad] += rng.standard_normal((bad.sum(), 3))
    Qk = f32(1.5 + rng.random((n, 1)) * 3)
    valid = rng.random((n, 1)) < valid_frac
    return f32(Xf), Xk, Qk, valid


@pytest.mark.parametrize("calib", [False, True])
@pytest.mark.parametrize("case", ["converges", "no_valid_match",
                                  "max_iters"])
def test_tracker_loop_matches_jax(gnm, calib, case):
    """gn_point over every point, then gn_finish, iteration by iteration,
    against JAX ``opt_pose_ray_dist_sim3`` / ``opt_pose_calib_sim3``."""
    Xf, Xk, Qk, valid = _track_problem(3, valid_frac=0.0 if case ==
                                       "no_valid_match" else 0.9)
    cfg = jt.TrackerConfig()
    if case == "max_iters":
        cfg = cfg._replace(max_iters=3, rel_error=0.0, delta_norm=0.0)
    T0 = f32(np.asarray(js.identity()))
    K = f32([[30.0, 0, 16], [0, 30, 12], [0, 0, 1]])
    sQ = (np.sqrt(Qk) * valid)[:, 0]
    if calib:
        meas, vmeas = jt.calib_measurements(jnp.asarray(Xk), jnp.asarray(K),
                                            (24, 32), cfg.depth_eps)
        ref = jt.opt_pose_calib_sim3(
            *(jnp.asarray(a) for a in (Xf, Xk, T0, Qk, valid)), meas, vmeas,
            jnp.asarray(K), (24, 32), cfg)
        si = f32(np.stack([sQ / cfg.sigma_pixel] * 2 + [sQ / cfg.sigma_depth])
                 * np.asarray(vmeas)[:, 0][None])
        tgt = f32(np.asarray(meas).T)
        intr = f32([30.0, 30.0, 16.0, 12.0, cfg.pixel_border,
                    31 - cfg.pixel_border, 23 - cfg.pixel_border,
                    cfg.depth_eps])
    else:
        ref = jt.opt_pose_ray_dist_sim3(
            *(jnp.asarray(a) for a in (Xf, Xk, T0, Qk, valid)), cfg)
        si = f32(np.stack([sQ / cfg.sigma_ray] * 3 + [sQ / cfg.sigma_dist]))
        rd, _, _ = jt._ray_dist_t(jnp.asarray(Xk).T)
        tgt = f32(np.asarray(rd))
        intr = f32([1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    T = np.zeros(8, np.float32)
    cost = np.zeros(1, np.float32)
    failed = np.zeros(1, np.int32)
    iters = gnm.h_track(int(calib), T0, Xf, tgt, si, Xf.shape[0], cfg.huber,
                        intr, cfg.max_iters, cfg.rel_error, cfg.delta_norm,
                        T, cost, failed)
    assert iters == int(ref.iters)
    assert bool(failed[0]) == bool(ref.failed)
    np.testing.assert_allclose(T, np.asarray(ref.T_CkCf), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cost[0], float(ref.cost), rtol=1e-4)
    if case == "no_valid_match":
        assert failed[0] and iters == 1
        np.testing.assert_array_equal(T, T0)
    elif case == "max_iters":
        assert iters == 3 and not failed[0]
    else:
        assert 1 < iters < cfg.max_iters


def test_plain_solve_returns_device_counts():
    """``gn_solve_plain`` keeps the kernel's result types: a 0-d int32
    iteration count and a 0-d bool."""
    Xf, Xk, Qk, valid = (torch.from_numpy(np.array(a))
                         for a in _track_problem(4))
    res = tt.opt_pose_ray_dist_sim3(Xf, Xk, ts.identity(), Qk, valid,
                                    tt.TrackerConfig())
    assert res.iters.dtype == torch.int32 and res.iters.dim() == 0
    assert res.failed.dtype == torch.bool and res.failed.dim() == 0
    assert res.cost.dim() == 0 and res.T_CkCf.shape == (8,)

