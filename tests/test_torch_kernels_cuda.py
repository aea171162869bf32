"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the GPU. Without a CUDA device every test here skips (the CPU
tests compare the plain versions with the JAX package instead); on the GPU
run ``python -m pytest tests/test_torch_kernels_cuda.py``.

Tolerances: the kernels are built with -fmad=false and keep the plain
versions' operation order, so floats agree to 1e-6 (observed: exactly) and
integer outputs and converged flags are equal. The gathers copy and are
exact. The two reductions (``gn_step``, ``ba_edge_terms``) sum fp32 terms
in another order than the plain matmuls: 1e-5 of the largest entry, and
two calls on the same inputs give the same bits. The fused tracker solve
(``gn_solve``) runs as many iterations as the plain loop and fails where it
fails, its pose within 1e-5 and its cost within 1e-5 relative (the device
retraction uses CUDA's sinf/expm1f); the fused BA system (``edge_system``)
is held to 1e-5 of the largest entry of each output. ``rope_qk`` rounds every
product and sum as the plain version does: bit-equal; so does its backward
``rope_qk_bwd``, against autograd through the plain version. ``refine_matches``
adds exact products in the plain version's order (bf16) or exact integers
(int8): equal at every point, on both of its paths, and so must the
separable search (``refine_separable``). ``coarse_correlate``
runs on the tensor cores, which add in an order of their own: it is held to
``dense_matcher.check_coarse_correlate``'s tie rule (the chosen cell's plain
score within one bf16 step of the row's plain maximum, the plain index where
the maximum is unique by more than a step, the first NaN cell on NaN rows),
and to exact indices on rows whose answer is known."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from mast3r_slam_tpu_torch.ops import _kernels

    _kernels.build_all()
    return torch.device("cuda")


def _rays(dev, b=1, h=48, w=64, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    X = torch.randn(b, h, w, 3, generator=g) + torch.tensor([0, 0, 3.0])
    return X.to(dev)


def test_scharr_rays_matches_plain(cuda):
    from mast3r_slam_tpu_torch.ops import _kernels, gradient

    X = _rays(cuda, b=2)
    n0 = _kernels.LAUNCHES["scharr_rays"]
    got = gradient.prep_rays_grad(X)
    assert _kernels.LAUNCHES["scharr_rays"] == n0 + 1
    ref = gradient.prep_rays_grad_plain(X)
    assert float((got - ref).abs().max()) <= 1e-6
    img = torch.randn(3, 17, 33, 5, device=cuda)
    for a, b in zip(gradient.img_gradient(img),
                    gradient.img_gradient_plain(img)):
        assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.parametrize("iters", [0, 3, 10])
def test_iter_proj_matches_plain(cuda, iters):
    from mast3r_slam_tpu_torch.ops import gradient, matching

    X = _rays(cuda)
    rays = gradient.prep_rays_grad(X)
    n = 500
    pts = gradient.l2_normalize(_rays(cuda, seed=1)[0].reshape(-1, 3)[:n])[None]
    p0 = torch.rand(1, n, 2, device=cuda) * torch.tensor([63.0, 47.0],
                                                         device=cuda)
    a, ca = matching.iter_proj(rays, pts.contiguous(), p0, iters)
    b, cb = matching.iter_proj_plain(rays, pts, p0, iters)
    assert float((a - b).abs().max()) <= 1e-6
    assert torch.equal(ca, cb)


def _exact(a, b):
    """Bit-equal up to NaN payloads: NaN where the other is NaN, every other
    value exactly equal."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("b,h,w", [(1, 37, 53), (2, 2, 2), (2, 9, 70),
                                   (1, 48, 64), (3, 13, 4)])
def test_scharr_tiled_equals_plain_at_ragged_sizes(cuda, b, h, w):
    """The tiled stencil and the per-pixel one at sizes that are no multiple
    of a tile, down to 2 x 2, in both records: channels 0-8 bit-equal to the
    plain version, the pad exactly zero."""
    from mast3r_slam_tpu_torch.ops import gradient

    X = _rays(cuda, b=b, h=h, w=w, seed=h * w)
    ref = gradient.prep_rays_grad_plain(X)
    _exact(gradient._scharr_cuda(X, True, 9), ref)
    pad = gradient._scharr_cuda(X, True, 12)
    _exact(pad[..., :9], ref)
    assert torch.count_nonzero(pad[..., 9:]) == 0
    _exact(gradient._scharr_cuda(X, True, 9, tiled=False), ref)
    _exact(gradient.prep_rays_grad_padded(X),
           gradient.prep_rays_grad_padded_plain(X))


def test_scharr_tiled_unaligned_input_with_nan(cuda):
    """An input that starts 4 bytes past a 16-byte boundary (the scalar-load
    path) with a NaN and a zero ray planted: NaN spreads to the same pixels
    as in the plain version, the zero ray divides by the clamped norm."""
    from mast3r_slam_tpu_torch.ops import gradient

    X = _rays(cuda, b=2, h=24, w=64, seed=3)
    flat = torch.empty(X.numel() + 1, device=cuda)
    Xm = flat[1:].view(X.shape)
    Xm.copy_(X)
    Xm[0, 5, 9, 1] = float("nan")
    Xm[1, 0, 63] = 0.0
    for out_c in (9, 12):
        got = gradient._scharr_cuda(Xm, True, out_c)
        _exact(got[..., :9], gradient.prep_rays_grad_plain(Xm))
    # the NaN ray, and the stencils that read it: gy above it, gx beside it
    assert bool(torch.isnan(got[0, 5, 9, 0:3]).all())
    assert bool(torch.isnan(got[0, 4, 9, 6:9]).all())
    assert bool(torch.isnan(got[0, 5, 8, 3:6]).all())


def test_scharr_refuses_unbuilt_records(cuda):
    """Records that no kernel writes raise on a CUDA tensor: normalization
    of c != 3, a 12-float record from the per-pixel kernel, a 10-float
    record."""
    from mast3r_slam_tpu_torch.ops import gradient

    X = _rays(cuda, b=1, h=8, w=8, seed=1)
    with pytest.raises(ValueError, match="c == 3"):
        gradient._scharr_cuda(X[..., :2].contiguous(), normalize=True)
    with pytest.raises(ValueError, match="per-pixel"):
        gradient._scharr_cuda(X, True, 12, tiled=False)
    with pytest.raises(ValueError, match="10-float"):
        gradient._scharr_cuda(X, True, 10)


def test_scharr_plain_stencil_mode_c5(cuda):
    from mast3r_slam_tpu_torch.ops import gradient

    img = torch.randn(2, 17, 33, 5, device=cuda)
    for a, b in zip(gradient.img_gradient(img),
                    gradient.img_gradient_plain(img)):
        _exact(a, b)


@pytest.mark.parametrize("c,first", [(9, False), (12, False), (9, True)])
@pytest.mark.parametrize("iters", [0, 10])
def test_iter_proj_layouts_equal_plain(cuda, c, first, iters):
    """Both records and the first design, b = 2 with 1,001 points (no
    multiple of a block's points), NaN starts and starts on and past the
    clamp edges (u = w - 2, v = h - 2): positions bit-equal to the plain
    version (NaN where it is NaN), flags equal."""
    from mast3r_slam_tpu_torch.ops import gradient, matching

    h, w, n = 40, 56, 1001
    X = _rays(cuda, b=2, h=h, w=w, seed=7)
    img = (gradient.prep_rays_grad_padded(X) if c == 12
           else gradient.prep_rays_grad(X))
    pts = gradient.l2_normalize(
        _rays(cuda, b=2, h=h, w=w, seed=8).reshape(2, -1, 3)[:, :n])
    g = torch.Generator(device="cpu").manual_seed(iters)
    p0 = torch.rand(2, n, 2, generator=g) * torch.tensor([w + 4.0, h + 4.0])
    p0 -= 2.0
    p0[0, :4] = torch.tensor([[w - 2.0, h - 2.0], [w - 2.0, 1.0],
                              [w + 5.0, h - 2.0], [1.0, h - 2.0]])
    p0[0, 4, 0] = float("nan")
    p0[1, 1000] = float("nan")
    p0 = p0.to(cuda)
    a, ca = matching._iter_proj_cuda(img, pts.contiguous(), p0, iters, 1e-8,
                                     1e-6, first)
    b, cb = matching.iter_proj_plain(img, pts, p0, iters)
    _exact(a, b)
    assert torch.equal(ca, cb)
    assert bool(torch.isnan(a[0, 4, 0])) and not bool(ca[0, 4])
    assert bool(torch.isnan(a[1, 1000]).all()) and not bool(ca[1, 1000])
    assert float(a[0, 0, 0]) <= w - 2.0 and float(a[0, 2, 0]) <= w - 2.0


def test_iter_proj_refuses_misaligned_or_strided_padded_image(cuda):
    from mast3r_slam_tpu_torch.ops import matching

    pts = torch.zeros(1, 4, 3, device=cuda)
    p0 = torch.ones(1, 4, 2, device=cuda)
    flat = torch.zeros(8 * 8 * 12 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        matching.iter_proj(flat[1:].view(1, 8, 8, 12), pts, p0)
    wide = torch.zeros(1, 8, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        matching.iter_proj(wide[..., :12], pts, p0)
    with pytest.raises(ValueError):
        matching.iter_proj(torch.zeros(1, 8, 8, 10, device=cuda), pts, p0)
    with pytest.raises(ValueError):                   # the first design: c=9
        matching._iter_proj_cuda(torch.zeros(1, 8, 8, 12, device=cuda), pts,
                                 p0, 3, 1e-8, 1e-6, True)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("radius,dil", [(1, 1), (3, 5)])
def test_refine_matches_matches_plain(cuda, dtype, radius, dil):
    from mast3r_slam_tpu_torch.ops import matching

    rng = np.random.default_rng(radius + dil)
    h, w, f, n = 40, 56, 24, 2000
    D = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((1, h, w, f)).astype(np.float32)),
        dim=-1).to(cuda)
    Q = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((1, n, f)).astype(np.float32)),
        dim=-1).to(cuda)
    cast = (matching._quantize_int8 if dtype == "int8"
            else (lambda x: x.to(torch.bfloat16)))
    p1 = torch.from_numpy(np.stack([rng.integers(0, w, (1, n)),
                                    rng.integers(0, h, (1, n))], -1)
                          .astype(np.int32)).to(cuda)
    a = matching.refine_matches(cast(D), cast(Q), p1, radius, dil)
    b = matching.refine_matches_plain(cast(D), cast(Q), p1, radius, dil)
    assert torch.equal(a, b)


@pytest.mark.parametrize("b", [2, 4])
def test_matcher_kernels_at_edge_batch(cuda, b):
    """The backend matches both directions of its candidate edges as one
    batch of 2b: every batch row must read its own rays, descriptors and
    queries."""
    from mast3r_slam_tpu_torch.ops import gradient, matching

    h, w, f = 48, 64, 24
    n = h * w
    X = torch.cat([_rays(cuda, seed=s) for s in range(b)])
    rays = gradient.prep_rays_grad(X)
    assert float((rays - gradient.prep_rays_grad_plain(X)).abs().max()) <= 1e-6
    pts = gradient.l2_normalize(
        torch.cat([_rays(cuda, seed=10 + s) for s in range(b)])
        .reshape(b, n, 3)).contiguous()
    g = torch.Generator(device="cpu").manual_seed(b)
    p0 = (torch.rand(b, n, 2, generator=g)
          * torch.tensor([w - 1.0, h - 1.0])).to(cuda)
    a, ca = matching.iter_proj(rays, pts, p0, 10)
    ref, cref = matching.iter_proj_plain(rays, pts, p0, 10)
    assert float((a - ref).abs().max()) <= 1e-6
    assert torch.equal(ca, cref)
    assert float((a[0] - a[1]).abs().max()) > 1.0    # rows really differ

    D = torch.nn.functional.normalize(
        torch.randn(b, h, w, f, generator=g), dim=-1).to(cuda)
    Qd = torch.nn.functional.normalize(
        torch.randn(b, n, f, generator=g), dim=-1).to(cuda)
    p1 = torch.stack([a[..., 0].clamp(0, w - 1), a[..., 1].clamp(0, h - 1)],
                     -1).to(torch.int32).contiguous()
    for cast in (lambda x: x.to(torch.bfloat16), matching._quantize_int8):
        got = matching.refine_matches(cast(D), cast(Qd), p1, 3, 5)
        assert torch.equal(
            got, matching.refine_matches_plain(cast(D), cast(Qd), p1, 3, 5))


@pytest.mark.parametrize("R,C,N", [(4096, 256, 1024), (8 * 768, 4, 5000),
                                   (100, 7, 333)])
def test_gather_rows_matches_plain(cuda, R, C, N):
    from mast3r_slam_tpu_torch.ops import _kernels, gather

    rng = np.random.default_rng(R)
    table = torch.from_numpy(rng.standard_normal((R, C)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, R, N).astype(np.int32)).to(cuda)
    n0 = _kernels.LAUNCHES["gather_rows"]
    got = gather.gather_rows(table, idx)
    assert _kernels.LAUNCHES["gather_rows"] == n0 + 1
    assert torch.equal(got, gather.gather_rows_plain(table, idx))


@pytest.mark.parametrize("axis,tshape,ishape", [
    (0, (1024, 128), (1024, 128)), (0, (40, 9), (17, 9)),
    (1, (2, 6144), (2, 6144)), (1, (3, 50), (3, 21))])
def test_take_along_matches_plain(cuda, axis, tshape, ishape):
    from mast3r_slam_tpu_torch.ops import gather

    rng = np.random.default_rng(axis + tshape[1])
    t = torch.from_numpy(rng.standard_normal(tshape).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, tshape[axis], ishape).astype(
        np.int32)).to(cuda)
    assert torch.equal(gather.take_along(t, idx, axis),
                       gather.take_along_plain(t, idx, axis))
    with pytest.raises(ValueError):
        gather.take_along(t, idx[:, :-1].contiguous(), 0 if axis == 0 else 2)


@pytest.mark.parametrize("axis,tshape,ishape", [
    (1, (2, 196608), (2, 196608)),    # the edge gate's shape
    (1, (3, 1003), (3, 1001)),        # columns no multiple of 4: scalar tail
    (0, (40, 9), (17, 9)), (0, (1024, 128), (1024, 128))])
def test_take_along_pair_matches_plain(cuda, axis, tshape, ishape):
    """Both problems in one launch, bit-equal to two plain calls; also with
    indices that are not 16-byte aligned (a row moved one at a time)."""
    from mast3r_slam_tpu_torch.ops import _kernels, gather

    rng = np.random.default_rng(tshape[1])
    f = lambda a, dt: torch.from_numpy(a.astype(dt)).to(cuda)
    ts = [f(rng.standard_normal(tshape), np.float32) for _ in range(2)]
    idx = [f(rng.integers(0, tshape[axis], ishape), np.int32)
           for _ in range(2)]
    n0 = _kernels.LAUNCHES["take_along"]
    got = gather.take_along_pair(ts[0], idx[0], ts[1], idx[1], axis)
    assert _kernels.LAUNCHES["take_along"] == n0 + 1
    ref = gather.take_along_pair_plain(ts[0], idx[0], ts[1], idx[1], axis)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    flat = f(rng.integers(0, tshape[axis], ishape[0] * ishape[1] + 1),
             np.int32)
    odd = flat[1:].view(ishape)                      # 4 bytes off alignment
    got = gather.take_along_pair(ts[0], odd, ts[1], idx[1], axis)
    ref = gather.take_along_pair_plain(ts[0], odd, ts[1], idx[1], axis)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError):
        gather.take_along_pair(ts[0], idx[0], ts[1][:1].contiguous(),
                               idx[1][:1].contiguous(), axis)


def _tracker_problem(dev, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    Xk = rng.standard_normal((n, 3)).astype(np.float32) + [0, 0, 4.0]
    Xf = Xk + 0.01 * rng.standard_normal((n, 3))
    Xf[::97] += 1.0                               # outliers: Huber's branch
    si = rng.uniform(0.0, 30.0, (4, n)) * (rng.random((1, n)) > 0.1)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    T = torch.tensor([0.02, -0.01, 0.03, 0.0, 0.0099995, 0.0, 0.99995, 1.02],
                     device=dev)
    return T, f(Xf), f(Xk.astype(np.float32)), f(si)


@pytest.mark.parametrize("calib", [False, True])
def test_gn_step_matches_plain(cuda, calib):
    from mast3r_slam_tpu_torch.slam import tracker

    T, Xf, Xk, si = _tracker_problem(cuda)
    if calib:
        proj = tracker.CalibProj(300.0, 300.0, 256.0, 192.0, 512, 384, -10,
                                 1e-6)
        z = Xk[:, 2]
        tgt = torch.stack([300.0 * Xk[:, 0] / z + 256.0,
                           300.0 * Xk[:, 1] / z + 192.0, torch.log(z)])
        si = si[:3].contiguous()
    else:
        proj = None
        tgt, _, _ = tracker._ray_dist_t(Xk.T)
    tgt = tgt.contiguous()
    a = tracker.gn_step(T, Xf, tgt, si, 1.345, proj)
    b = tracker.gn_step(T, Xf, tgt, si, 1.345, proj)
    ref = tracker.gn_step_plain(T, Xf, tgt, si, 1.345, proj)
    assert torch.equal(a, b)
    for sl in (slice(0, 49), slice(49, 56), slice(56, 57)):
        scale = float(ref[sl].abs().max())
        assert float((a[sl] - ref[sl]).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("calib", [False, True])
@pytest.mark.parametrize("case", ["converges", "no_valid_match",
                                  "max_iters"])
def test_gn_solve_matches_plain(cuda, calib, case):
    from mast3r_slam_tpu_torch.slam import tracker

    T, Xf, Xk, si = _tracker_problem(cuda, n=20000)
    cfg = tracker.TrackerConfig()
    if case == "no_valid_match":
        si = torch.zeros_like(si)
    if case == "max_iters":
        cfg = cfg._replace(max_iters=4, rel_error=0.0, delta_norm=0.0)
    if calib:
        proj = tracker.CalibProj(300.0, 300.0, 256.0, 192.0, 512, 384, -10,
                                 1e-6)
        z = Xk[:, 2]
        tgt = torch.stack([300.0 * Xk[:, 0] / z + 256.0,
                           300.0 * Xk[:, 1] / z + 192.0, torch.log(z)])
        si = si[:3].contiguous()
    else:
        proj = None
        tgt, _, _ = tracker._ray_dist_t(Xk.T)
    tgt = tgt.contiguous()
    a = tracker.gn_solve(T, Xf, tgt, si, cfg, proj)
    b = tracker.gn_solve(T, Xf, tgt, si, cfg, proj)
    ref = tracker.gn_solve_plain(T, Xf, tgt, si, cfg, proj)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.iters) == int(ref.iters)
    assert bool(a.failed) == bool(ref.failed)
    assert float((a.T_CkCf - ref.T_CkCf).abs().max()) <= 1e-5
    assert abs(float(a.cost) - float(ref.cost)) <= 1e-5 * abs(float(ref.cost))
    if case == "no_valid_match":
        assert bool(a.failed) and int(a.iters) == 1
        assert torch.equal(a.T_CkCf, T)
    elif case == "max_iters":
        assert int(a.iters) == 4 and not bool(a.failed)
    else:
        assert 1 < int(a.iters) < cfg.max_iters


def _ba_problem(dev, stride, E=8):
    """4 keyframes, E two-way edges (the 8 of a square with a diagonal,
    repeated), one masked edge, a point behind the camera."""
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam import ba

    rng = np.random.default_rng(stride)
    h, w, n_kf = 48, 64, 4
    P = h * w
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    Xs = []
    for k in range(n_kf):
        z = 3.0 + 0.5 * np.sin(u / 9.0 + k) + 0.01 * rng.standard_normal(
            u.shape)
        Xs.append(np.stack([(u - 32) / 60.0 * z, (v - 24) / 60.0 * z, z],
                           -1).reshape(P, 3))
    Xs = f(np.stack(Xs))
    Xs[2, 7, 2] = -1.0
    Cs = f(rng.uniform(-0.3, 5.0, (n_kf, P)))
    T = sim3.exp(f(0.05 * rng.standard_normal((n_kf, 7))))
    base_i, base_j = [0, 1, 1, 2, 2, 3, 0, 3], [1, 0, 2, 1, 3, 2, 3, 0]
    ii = torch.tensor((base_i * E)[:E], dtype=torch.int32, device=dev)
    jj = torch.tensor((base_j * E)[:E], dtype=torch.int32, device=dev)
    idx = torch.from_numpy(np.clip(
        np.arange(P)[None] + rng.integers(-2, 3, (E, P)), 0, P - 1).astype(
            np.int32)).to(dev)
    valid = torch.from_numpy(rng.random((E, P)) > 0.1).to(dev)
    Q = f(rng.uniform(1.0, 4.5, (E, P)))
    mask = torch.ones(E, device=dev)
    mask[min(5, E - 1)] = 0.0
    cfg = ba.BAConfig(point_stride=stride)
    return T, Xs, Cs, ii, jj, idx, valid, Q, mask, cfg, (h, w)


@pytest.mark.parametrize("mode,stride,E", [
    (m, s, 8) for m in ("rays", "calib", "points") for s in (1, 4)]
    + [("rays", 4, 2), ("calib", 1, 2), ("rays", 4, 42), ("rays", 4, 1100)])
def test_edge_system_matches_plain(cuda, mode, stride, E):
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.slam import ba

    T, Xs, Cs, ii, jj, idx, valid, Q, mask, cfg, (h, w) = _ba_problem(
        cuda, stride, E)
    calib = (ba.CalibArgs(60.0, 60.0, 32.0, 24.0, w, h) if mode == "calib"
             else None)
    n_kf, K_cap, pin = 3, 4, 1             # keyframe 3: an inactive slot
    pre = ba._edge_prep(Xs, Cs, ii, jj, idx, valid, stride)
    wq = ba._edge_weights(pre, valid, Q, cfg, stride)
    args = (mode, T, pre, wq, ii, jj, mask, n_kf, K_cap, pin, cfg, calib)
    n0 = _kernels.LAUNCHES["ba_edge_terms"]
    got = ba.edge_system(*args)
    assert _kernels.LAUNCHES["ba_edge_terms"] == n0 + 1
    again = ba.edge_system(*args)
    ref = ba.edge_system_plain(mode, T, Xs, Cs, ii, jj, idx, valid, Q, mask,
                               n_kf, K_cap, pin, cfg, pre, calib)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert torch.equal(torch.isnan(a), torch.isnan(r))
        scale = float(r.nan_to_num().abs().max())
        assert float((a - r).nan_to_num().abs().max()) <= 1e-5 * scale
    Hd, gd = got[2], got[3]
    assert not Hd[:7].any() and not Hd[21:].any() and not gd[21:].any()
    assert float(got[0][min(5, E - 1)].nan_to_num().abs().max()) == 0.0


@pytest.mark.parametrize("K_cap,E", [(64, 300), (256, 1204)])
def test_edge_system_many_keyframes(cuda, K_cap, E):
    """A long sequence: K_cap keyframes (the last two inactive, the first
    pinned), consecutive and random two-way edges: hundreds of destination
    blocks, each summed by the block that completes it."""
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam import ba

    rng = np.random.default_rng(E)
    P = 24 * 32
    pairs = [(k, k + 1) for k in range(K_cap - 1)][:E // 2]
    while len(pairs) < E // 2:
        a, b = (int(v) for v in rng.integers(0, K_cap, 2))
        if abs(a - b) >= 2:
            pairs.append((a, b))
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    ii = i32([a for p in pairs for a in p])
    jj = i32([a for p in pairs for a in p[::-1]])
    T = sim3.exp(f(0.02 * rng.standard_normal((K_cap, 7))))
    Xs = f(rng.standard_normal((K_cap, P, 3)) * 0.5 + [0.0, 0.0, 3.0])
    Cs = f(rng.uniform(-0.3, 5.0, (K_cap, P)))
    idx = i32(rng.integers(0, P, (E, P)))
    valid = torch.from_numpy(rng.random((E, P)) > 0.1).to(cuda)
    Q = f(rng.uniform(1.0, 4.5, (E, P)))
    mask = torch.ones(E, device=cuda)
    cfg = ba.BAConfig(point_stride=4)
    n_kf, pin = K_cap - 2, 1
    pre = ba._edge_prep(Xs, Cs, ii, jj, idx, valid, 4)
    wq = ba._edge_weights(pre, valid, Q, cfg, 4)
    args = ("rays", T, pre, wq, ii, jj, mask, n_kf, K_cap, pin, cfg)
    got = ba.edge_system(*args)
    again = ba.edge_system(*args)
    ref = ba.edge_system_plain("rays", T, Xs, Cs, ii, jj, idx, valid, Q,
                               mask, n_kf, K_cap, pin, cfg, pre)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())
    Hd, gd = got[2], got[3]
    assert not Hd[:7].any() and not Hd[7 * n_kf:].any()
    assert not gd[:7].any() and not gd[7 * n_kf:].any()


@pytest.mark.parametrize("residual", ["rays", "calib"])
def test_dist_ba_two_shards_matches_dense_kernel_path(cuda, residual):
    """``parallel/dist_ba.gauss_newton_dist`` over two shards of cuda:0
    (each shard's system from its own ``ba_edge_terms`` launch, summed in
    shard order) against the dense solve on the kernel path: poses within
    1e-4, as many iterations, one launch a shard an iteration."""
    from mast3r_slam_tpu_torch import geometry
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import dist_ba, mesh
    from mast3r_slam_tpu_torch.slam import ba

    g = torch.Generator(device="cpu").manual_seed(7)
    h, w, n_kf = 24, 32, 6
    P = h * w
    pts = torch.randn(P, 3, generator=g) * torch.tensor([1.0, 1.0, 0.5])
    pts = pts + torch.tensor([0.0, 0.0, 4.0])
    T_true = [sim3.identity()]
    for _ in range(1, n_kf):
        xi = 0.05 * torch.randn(7, generator=g)
        T_true.append(sim3.mul(T_true[-1], sim3.exp(xi)))
    T_true = torch.stack(T_true)
    Xs = sim3.act(sim3.inv(T_true)[:, None], pts[None])
    noise = 0.03 * torch.randn(n_kf, 7, generator=g)
    noise[0] = 0.0
    T = sim3.retr(T_true, noise)
    pairs = [(k, k + 1) for k in range(n_kf - 1)] + [(0, n_kf - 1)]
    ii = torch.tensor([a for p in pairs for a in p], dtype=torch.int32)
    jj = torch.tensor([a for p in pairs for a in p[::-1]], dtype=torch.int32)
    E = ii.shape[0]
    edges = [ii, jj, torch.arange(P, dtype=torch.int32).repeat(E, 1),
             torch.ones((E, P), dtype=torch.bool), torch.full((E, P), 4.0),
             torch.ones(E)]
    K = torch.tensor([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1.0]])
    if residual == "calib":
        Xs = geometry.constrain_points_to_ray((h, w), Xs, K)
    T, Xs, K, *edges = (a.to(cuda) for a in (T, Xs, K, *edges))
    Cs = torch.full((n_kf, P), 5.0, device=cuda)
    cfg = ba.BAConfig(point_stride=4, max_iters=6)
    size = (h, w) if residual == "calib" else None
    dense = (ba.gauss_newton_calib(T, Xs, Cs, K, *edges, n_kf, size, cfg)
             if residual == "calib"
             else ba.gauss_newton_rays(T, Xs, Cs, *edges, n_kf, cfg))
    n0 = _kernels.LAUNCHES["ba_edge_terms"]
    res = dist_ba.gauss_newton_dist(
        T, Xs, Cs, K, *edges, n_kf, mesh.make_mesh([cuda, cuda]), cfg,
        residual=residual, img_size=size)
    assert _kernels.LAUNCHES["ba_edge_terms"] == n0 + 2 * res.iters
    assert res.iters == dense.iters
    assert float((res.T_WC - dense.T_WC).abs().max()) <= 1e-4
    assert float((res.T_WC - T).abs().max()) > 1e-3


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("mode", ["rays", "calib", "points"])
def test_ba_edge_terms_matches_plain(cuda, mode, stride):
    """The per-edge sums alone, for given Tij (the kernel without its
    conjugation and assembly)."""
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam import ba

    T, Xs, Cs, ii, jj, idx, valid, Q, mask, cfg, (h, w) = _ba_problem(
        cuda, stride)
    calib = (ba.CalibArgs(60.0, 60.0, 32.0, 24.0, w, h) if mode == "calib"
             else None)
    pre = ba._edge_prep(Xs, Cs, ii, jj, idx, valid, stride)
    Tij = sim3.rel(T[ii.long()], T[jj.long()]).contiguous()
    args = (mode, Tij, pre, valid, Q, mask, stride, cfg, calib)
    S, g = ba.ba_edge_terms(*args)
    S2, g2 = ba.ba_edge_terms(*args)
    Sp, gp = ba.ba_edge_terms_plain(*args)
    assert torch.equal(S, S2) and torch.equal(g, g2)
    assert float((S - Sp).abs().max()) <= 1e-5 * float(Sp.abs().max())
    assert float((g - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
    assert float(S[5].abs().max()) == 0.0
    assert torch.equal(S, S.transpose(1, 2))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,nq,nk,d", [
    (1, 16, 768, 768, 64), (4, 12, 768, 768, 64), (2, 3, 24, 40, 16),
    (2, 2, 9, 5, 8)])
def test_rope_qk_matches_plain(cuda, out_dtype, b, heads, nq, nk, d):
    """Self-attention layout (strided views of a fused qkv projection) when
    nq == nk, split-heads views with distinct tables otherwise; d = 8 takes
    the scalar path."""
    from mast3r_slam_tpu_torch.models import rope
    from mast3r_slam_tpu_torch.ops import _kernels

    g = torch.Generator(device="cpu").manual_seed(nq + d)
    if nq == nk:
        qkv = torch.randn(b, nq, 3, heads, d, generator=g).to(cuda)
        q, k = (qkv[:, :, i].transpose(1, 2) for i in (0, 1))
    else:
        q = torch.randn(b, nq, heads * d, generator=g).to(cuda).reshape(
            b, nq, heads, d).transpose(1, 2)
        k = torch.randn(b, nk, heads * d, generator=g).to(cuda).reshape(
            b, nk, heads, d).transpose(1, 2)

    def tables(n, seed):
        pos = torch.stack([torch.arange(n) // 7, (torch.arange(n) + seed) % 7],
                          -1)[None].expand(b, n, 2).to(cuda)
        return rope.rope_tables(pos, d, 100.0, torch.float32)

    tq, tk = tables(nq, 0), tables(nk, 3)
    n0 = _kernels.LAUNCHES["rope_qk"]
    qo, ko = rope.rope_qk(q, k, tq, tk, out_dtype)
    assert _kernels.LAUNCHES["rope_qk"] == n0 + 1
    qp, kp = rope.rope_qk_plain(q, k, tq, tk, out_dtype)
    assert qo.dtype == out_dtype and qo.is_contiguous()
    assert torch.equal(qo, qp) and torch.equal(ko, kp)
    with pytest.raises(ValueError):
        rope.rope_qk(q.to(torch.bfloat16), k, tq, tk)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,nq,nk,d,shared", [
    (4, 16, 768, 768, 64, False), (4, 12, 768, 768, 64, False),
    (2, 12, 768, 768, 64, True), (2, 3, 24, 40, 16, False),
    (3, 2, 9, 5, 8, True)])
def test_rope_qk_bwd_matches_autograd(cuda, out_dtype, b, heads, nq, nk, d,
                                      shared):
    """``rope_qk``'s backward kernel (``rope_qk_bwd``, through the autograd
    Function) against autograd through ``rope_qk_plain``: the full-width
    trainer's encoder and decoder shapes, q and k strided views of a qkv
    projection when nq == nk (the gradient scattered back into qkv),
    split-heads views with distinct tables otherwise; ``shared``: one table
    (batch 1) for the whole batch; d = 8 takes the scalar path. Bit-equal,
    one launch a backward, none under ``torch.no_grad``."""
    from mast3r_slam_tpu_torch.models import rope
    from mast3r_slam_tpu_torch.ops import _kernels

    g = torch.Generator(device="cpu").manual_seed(nq + d + heads)
    base = ([torch.randn(b, nq, 3, heads, d, generator=g)] if nq == nk else
            [torch.randn(b, n, heads * d, generator=g) for n in (nq, nk)])
    base = [t.to(cuda) for t in base]

    def inputs():
        leaves = [t.clone().requires_grad_() for t in base]
        if nq == nk:
            q, k = (leaves[0][:, :, i].transpose(1, 2) for i in (0, 1))
        else:
            q, k = (x.reshape(b, n, heads, d).transpose(1, 2)
                    for x, n in zip(leaves, (nq, nk)))
        return leaves, q, k

    def tables(n, seed):
        bt = 1 if shared else b
        pos = torch.stack([torch.arange(n) // 7, (torch.arange(n) + seed) % 7],
                          -1)[None].expand(bt, n, 2).to(cuda)
        return rope.rope_tables(pos, d, 100.0, torch.float32)

    tq, tk = tables(nq, 0), tables(nk, 3)
    leaves, q, k = inputs()
    out = rope.rope_qk(q, k, tq, tk, out_dtype)
    gq, gk = (torch.randn(o.shape, generator=g).to(cuda, out_dtype)
              for o in out)
    n0 = _kernels.LAUNCHES["rope_qk_bwd"]
    got = torch.autograd.grad(out, leaves, (gq, gk))
    assert _kernels.LAUNCHES["rope_qk_bwd"] == n0 + 1
    leaves_p, qp, kp = inputs()
    want = torch.autograd.grad(rope.rope_qk_plain(qp, kp, tq, tk, out_dtype),
                               leaves_p, (gq, gk))
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    dq, dk = rope.rope_qk_bwd(gq, gk, tq, tk)
    pq, pk = rope.rope_qk_bwd_plain(gq, gk, tq, tk)
    assert dq.dtype == torch.float32 and dq.is_contiguous()
    assert torch.equal(dq, pq) and torch.equal(dk, pk)
    n1 = _kernels.LAUNCHES["rope_qk_bwd"]
    with torch.no_grad():
        rope.rope_qk(q, k, tq, tk, out_dtype)
    assert _kernels.LAUNCHES["rope_qk_bwd"] == n1
    with pytest.raises(ValueError):
        rope.rope_qk_bwd(gq.half(), gk.half(), tq, tk)


@pytest.mark.parametrize("kind,dtype", [
    (k, t) for k in ("smooth", "random", "border", "nan")
    for t in ("bf16", "int8") if (k, t) != ("nan", "int8")])   # no int8 NaN
def test_refine_matches_adversarial_starts(cuda, kind, dtype):
    """The generators of the CPU tests (``tests/test_torch_matching.py``):
    b = 2, a query grid that is no multiple of the block's patch, both window
    sizes, with and without the grid width."""
    from mast3r_slam_tpu_torch.ops import _kernels, matching
    from mast3r_slam_tpu_torch.utils import kernel_cases

    gh, gw, h, w, f = 37, 53, 96, 128, 24
    A, Q, p1 = (torch.from_numpy(a).to(cuda) for a in
                kernel_cases.refine_case(kind, 2, gh, gw, h, w, f, seed=5))
    cast = (matching._quantize_int8 if dtype == "int8"
            else (lambda x: x.to(torch.bfloat16)))
    A, Q = cast(A).contiguous(), cast(Q).contiguous()
    for r, d in ((1, 1), (3, 5)):
        ref = matching.refine_matches_plain(A, Q, p1, r, d)
        for grid_width in (gw, None):
            n0 = _kernels.LAUNCHES["refine_matches"]
            got = matching.refine_matches(A, Q, p1, r, d,
                                          grid_width=grid_width)
            assert _kernels.LAUNCHES["refine_matches"] == n0 + 1
            assert torch.equal(got, ref)


def _kinds_and_types():
    from mast3r_slam_tpu_torch.utils import kernel_cases

    return [(k, t) for k in kernel_cases.REFINE_KINDS for t in ("bf16", "int8")
            if not (t == "int8" and k in kernel_cases.BF16_ONLY_KINDS)]


def _refine_inputs(cuda, kind, dtype):
    """(f, grid width, D11, D21, p1) at every built descriptor width: b = 2,
    query grids that are no multiple of any block's patch (ragged patches),
    the base width at a larger image."""
    from mast3r_slam_tpu_torch.ops import matching
    from mast3r_slam_tpu_torch.utils import kernel_cases

    cast = (matching._quantize_int8 if dtype == "int8"
            else (lambda x: x.to(torch.bfloat16)))
    for gh, gw, h, w, f in ((9, 17, 20, 36, 8), (9, 17, 20, 36, 16),
                            (37, 53, 96, 128, 24), (11, 13, 20, 36, 32)):
        A, Q, p1 = (torch.from_numpy(a).to(cuda) for a in
                    kernel_cases.refine_case(kind, 2, gh, gw, h, w, f,
                                             seed=5))
        yield f, gw, cast(A).contiguous(), cast(Q).contiguous(), p1


@pytest.mark.parametrize("kind,dtype", _kinds_and_types())
def test_refine_separable_matches_plain(cuda, kind, dtype):
    """The separable search on ``kernel_cases``' inputs (smooth, random and
    border starts, NaNs, exact ties, +-inf, values whose products overflow
    and underflow fp32), at every built width, r = 0-5 with every dilation
    up to 5, with and without the grid width: equal at every point to
    ``refine_matches_separable_plain``."""
    from mast3r_slam_tpu_torch.ops import _kernels, matching

    for f, gw, A, Q, p1 in _refine_inputs(cuda, kind, dtype):
        for r in range(6):
            for d in range(1, 6):
                ref = matching.refine_matches_separable_plain(A, Q, p1, r, d)
                for grid_width in (gw, None):
                    n0 = _kernels.LAUNCHES["refine_separable"]
                    got = matching.refine_matches_separable(
                        A, Q, p1, r, d, grid_width=grid_width)
                    assert _kernels.LAUNCHES["refine_separable"] == n0 + 1
                    assert torch.equal(got, ref), (f, r, d, grid_width)
    with pytest.raises(ValueError, match="refine_separable"):
        matching.refine_matches_separable(A.float(), Q, p1)


@pytest.mark.parametrize("kind,dtype", _kinds_and_types())
def test_refine_matches_matches_plain_on_separable_inputs(cuda, kind, dtype):
    """``refine_matches`` on the separable search's inputs: still equal at
    every point to its own plain version (separate roundings)."""
    from mast3r_slam_tpu_torch.ops import matching

    for f, gw, A, Q, p1 in _refine_inputs(cuda, kind, dtype):
        for r in range(6):
            for d in (1, 3, 5):
                ref = matching.refine_matches_plain(A, Q, p1, r, d)
                for grid_width in (gw, None):
                    got = matching.refine_matches(A, Q, p1, r, d,
                                                  grid_width=grid_width)
                    assert torch.equal(got, ref), (f, r, d, grid_width)


@pytest.mark.parametrize("b,h,w,f,n,stride", [
    (2, 384, 512, 24, 12288, 4), (1, 32, 48, 16, 384, 4),
    (3, 30, 50, 8, 101, 4), (2, 16, 24, 32, 96, 2)])
def test_coarse_correlate_meets_tie_rule(cuda, b, h, w, f, n, stride):
    from mast3r_slam_tpu_torch.ops import _kernels, dense_matcher
    from mast3r_slam_tpu_torch.utils import kernel_cases

    D11, D21, expect = kernel_cases.coarse_edge_case(b, h, w, f, n, stride,
                                                     seed=h + n)
    D11, D21 = (torch.from_numpy(a).to(cuda).to(torch.bfloat16)
                for a in (D11, D21))
    n0 = _kernels.LAUNCHES["coarse_correlate"]
    got = dense_matcher.coarse_correlate(D21, D11, stride)
    assert _kernels.LAUNCHES["coarse_correlate"] == n0 + 1
    assert got.dtype == torch.int32 and got.shape == (b, n)
    chk = dense_matcher.check_coarse_correlate(got, D21, D11, stride)
    assert (chk["score_off"], chk["unique_moved"], chk["nan_wrong"]) == (
        0, 0, 0), chk
    assert chk["identical_share"] >= 0.99
    got = got.cpu()
    for i, r, cell in expect:
        assert int(got[i, r]) == kernel_cases.cell_center(cell, h, w, stride)
    with pytest.raises(ValueError):
        dense_matcher.coarse_correlate(D21.float(), D11, stride)


def test_wrappers_refuse_bad_inputs(cuda):
    from mast3r_slam_tpu_torch.ops import matching

    D = torch.zeros(1, 8, 8, 24, device=cuda)          # fp32: not bf16/int8
    with pytest.raises(ValueError):
        matching.refine_matches(D, D.reshape(1, 64, 24), torch.zeros(
            1, 64, 2, dtype=torch.int32, device=cuda))
    # contiguous, but the rows do not start on a 16-byte boundary
    flat = torch.zeros(8 * 8 * 24 + 1, dtype=torch.bfloat16, device=cuda)
    Dm = flat[1:].reshape(1, 8, 8, 24)
    Db = torch.zeros(1, 8, 8, 24, dtype=torch.bfloat16, device=cuda)
    p0 = torch.zeros(1, 64, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        matching.refine_matches(Dm, Db.reshape(1, 64, 24), p0)
    with pytest.raises(ValueError, match="grid_width"):
        matching.refine_matches(Db, Db.reshape(1, 64, 24), p0, grid_width=7)
    img = torch.zeros(1, 8, 8, 9, device=cuda)
    with pytest.raises(ValueError):                     # not contiguous
        matching.iter_proj(img, torch.zeros(1, 4, 6, device=cuda)[..., :3],
                           torch.zeros(1, 4, 2, device=cuda))
    from mast3r_slam_tpu_torch.ops import gather

    with pytest.raises(ValueError):                     # int64 indices
        gather.gather_rows(torch.zeros(8, 4, device=cuda),
                           torch.zeros(3, dtype=torch.int64, device=cuda))
