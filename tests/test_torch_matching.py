"""Port matcher (the plain versions behind the ``iter_proj`` and
``refine_matches`` CUDA kernels, and ``match``) == the JAX matcher."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import matching as jm
from mast3r_slam_tpu.ops import window_gather
from mast3r_slam_tpu_torch.ops import matching as tm

# the suite runs several test processes side by side on a few cores;
# one intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

PRESETS = {
    "base": dict(max_iter=10, radius=3, dilation_max=5),
    "tpu_fast": dict(max_iter=0, coarse_iter=3, radius=1, dilation_max=1),
}


def _pair_maps(h=24, w=32, shift=(1.6, 2.3), f=8, seed=0):
    """View 1 pointmap/descriptors and view 2's points: a smooth surface
    seen again after a sub-pixel image shift."""
    rng = np.random.default_rng(seed)
    v, u = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")

    def surf(u, v):
        z = 2.0 + 0.3 * np.sin(u / 7.0) + 0.2 * np.cos(v / 5.0)
        return np.stack([(u - w / 2) / 20.0 * z, (v - h / 2) / 20.0 * z, z],
                        -1).astype(np.float32)

    proj = rng.standard_normal((3, f)).astype(np.float32) * 2.0

    def desc(X):
        d = np.sin(X @ proj)
        return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32)

    X11 = surf(u, v)
    X21 = surf(u + shift[0], v + shift[1])
    return X11[None], X21[None], desc(X11)[None], desc(X21)[None]


@pytest.mark.parametrize("max_iter", [0, 3, 10])
def test_iter_proj_matches_jax(max_iter):
    X11, X21, _, _ = _pair_maps()
    b, h, w, _ = X11.shape
    n = h * w
    rays = np.asarray(jm.prep_rays_grad(jnp.asarray(X11)))
    pts = X21.reshape(1, n, 3)
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    rng = np.random.default_rng(max_iter)
    p0 = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
          .reshape(1, n, 2).astype(np.float32)
          + rng.uniform(-1.0, 1.0, (1, n, 2)).astype(np.float32))
    pj, cj = jm.iter_proj(jnp.asarray(rays), jnp.asarray(pts),
                          jnp.asarray(p0), max_iter, 1e-8, 1e-6)
    pt, ct = tm.iter_proj(torch.from_numpy(np.array(rays)), torch.from_numpy(pts),
                          torch.from_numpy(p0), max_iter, 1e-8, 1e-6)
    # positions atol 1e-4 px (fp32 LM steps summed in another order)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("max_iter", [0, 3, 10])
def test_iter_proj_padded_record_matches_jax(max_iter):
    """The padded 12-float record (``prep_rays_grad_padded``, the layout the
    GPU kernel reads with vector loads): the plain version gives the same
    bits as on the 9-float image, and matches JAX's ``iter_proj`` on the
    9-channel image (positions 1e-4 px, flags equal). b = 2, starts off the
    grid, a few beyond the border (clamped) and one NaN start."""
    from mast3r_slam_tpu_torch.ops import gradient as tg

    X11, X21, _, _ = _pair_maps(seed=max_iter)
    X11b = np.concatenate([X11, X11[:, ::-1]])
    X21b = np.concatenate([X21, X21[:, ::-1]])
    b, h, w, _ = X11b.shape
    n = h * w
    pts = X21b.reshape(b, n, 3)
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    rng = np.random.default_rng(100 + max_iter)
    p0 = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
          .reshape(1, n, 2).astype(np.float32)
          + rng.uniform(-1.0, 1.0, (b, n, 2)).astype(np.float32))
    p0[:, :5] = [[w + 3.0, h + 2.0], [w - 2.0, h - 2.0], [-4.0, 0.5],
                 [1.0, 1.0], [0.3, h - 1.5]]
    p0[1, 7] = np.nan
    X_t = torch.from_numpy(np.ascontiguousarray(X11b))
    pad = tg.prep_rays_grad_padded(X_t)
    args = (torch.from_numpy(pts), torch.from_numpy(p0), max_iter, 1e-8,
            1e-6)
    p12, c12 = tm.iter_proj(pad, *args)
    p9, c9 = tm.iter_proj(tg.prep_rays_grad(X_t), *args)
    assert torch.equal(torch.nan_to_num(p12, nan=-1.0),
                       torch.nan_to_num(p9, nan=-1.0))
    assert torch.equal(c12, c9)
    assert bool(torch.isnan(p12[1, 7]).all()) and not bool(c12[1, 7])
    rays = jm.prep_rays_grad(jnp.asarray(X11b))
    pj, cj = jm.iter_proj(rays, jnp.asarray(pts), jnp.asarray(p0), max_iter,
                          1e-8, 1e-6)
    pj, cj = np.asarray(pj), np.asarray(cj)
    np.testing.assert_array_equal(c12.numpy(), cj)
    # converged points 1e-4 px (fp32 LM steps, XLA contracts multiply-adds);
    # a point whose target lies past the clamp box walks along the border
    # without converging, and one rounding can flip one of its accept/reject
    # decisions there: 1e-2 px
    np.testing.assert_allclose(p12.numpy()[cj], pj[cj], atol=1e-4)
    np.testing.assert_allclose(p12.numpy(), pj, atol=1e-2)


def test_iter_proj_launcher_refuses_cpu_tensors():
    """The kernel launcher has no fallback: a CPU tensor raises."""
    img = torch.zeros(1, 4, 4, 12)
    with pytest.raises(ValueError):
        tm._iter_proj_cuda(img, torch.zeros(1, 3, 3), torch.zeros(1, 3, 2),
                           3, 1e-8, 1e-6)


@pytest.mark.parametrize("refine_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("radius,dil", [(1, 1), (2, 2), (3, 5)])
def test_refine_matches_equals_full_unfold(refine_dtype, radius, dil):
    """Exactly equal: bf16/int8 products are exact in fp32, and random
    descriptors leave no score tie within rounding."""
    rng = np.random.default_rng(radius * 10 + dil)
    b, h, w, f = 2, 20, 28, 8
    D11 = rng.standard_normal((b, h, w, f)).astype(np.float32)
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    n = 300
    D21 = rng.standard_normal((b, n, f)).astype(np.float32)
    D21 /= np.linalg.norm(D21, axis=-1, keepdims=True)
    p1 = np.stack([rng.integers(0, w, (b, n)), rng.integers(0, h, (b, n))],
                  -1).astype(np.int32)
    if refine_dtype == "int8":
        q = lambda x: np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
        Dj, Qj = jnp.asarray(q(D11)), jnp.asarray(q(D21))
        Dt, Qt = torch.from_numpy(q(D11)), torch.from_numpy(q(D21))
    else:
        Dj = jnp.asarray(D11).astype(jnp.bfloat16)
        Qj = jnp.asarray(D21).astype(jnp.bfloat16)
        Dt = torch.from_numpy(D11).to(torch.bfloat16)
        Qt = torch.from_numpy(D21).to(torch.bfloat16)
    ref = window_gather.refine_matches_full_unfold(Dj, Qj, jnp.asarray(p1),
                                                   radius, dil)
    out = tm.refine_matches(Dt, Qt, torch.from_numpy(p1), radius, dil)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind,refine_dtype", [
    (k, t) for k in ("smooth", "random", "border", "nan")
    for t in ("bfloat16", "int8") if (k, t) != ("nan", "int8")])  # no int8 NaN
def test_refine_matches_adversarial_starts_equal_jax(kind, refine_dtype):
    """The inputs the GPU kernel is checked on (``utils/kernel_cases``), small:
    b = 2, 37 x 53 = 1,961 queries (no multiple of 128), scattered starts,
    starts on the border and the corners, NaNs planted in image and
    queries. Equal integers: int8 sums are exact; the bf16 fields leave no
    two taps within fp32 rounding of each other at these seeds."""
    from mast3r_slam_tpu_torch.utils import kernel_cases

    D11, D21, p1 = kernel_cases.refine_case(kind, 2, 37, 53, 48, 64, 24,
                                            seed=5)
    if refine_dtype == "int8":
        q = lambda x: np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
        Dj, Qj = jnp.asarray(q(D11)), jnp.asarray(q(D21))
        Dt, Qt = torch.from_numpy(q(D11)), torch.from_numpy(q(D21))
    else:
        Dj = jnp.asarray(D11).astype(jnp.bfloat16)
        Qj = jnp.asarray(D21).astype(jnp.bfloat16)
        Dt = torch.from_numpy(D11).to(torch.bfloat16)
        Qt = torch.from_numpy(D21).to(torch.bfloat16)
    for radius, dil in ((1, 1), (3, 5)):
        ref = jm.refine_matches(Dj, Qj, jnp.asarray(p1), radius, dil)
        out = tm.refine_matches(Dt, Qt, torch.from_numpy(p1), radius, dil,
                                grid_width=53)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        moved = np.abs(out.numpy() - p1).max()
        assert moved > 0                    # the search really ran


@pytest.mark.parametrize("preset", ["base", "tpu_fast"])
@pytest.mark.parametrize("refine_dtype", ["bfloat16", "int8"])
def test_match_matches_jax(preset, refine_dtype):
    X11, X21, D11, D21 = _pair_maps(h=32, w=48)
    kw = dict(PRESETS[preset], refine_dtype=refine_dtype)
    ij, vj = jm.match(*(jnp.asarray(a) for a in (X11, X21, D11, D21)), **kw)
    it, vt = tm.match(*(torch.from_numpy(a) for a in (X11, X21, D11, D21)),
                      **kw)
    ij, vj = np.asarray(ij), np.asarray(vj)
    it, vt = it.numpy(), vt.numpy()
    # a query whose LM fixpoint lands within fp32 rounding of a pixel
    # boundary may truncate to the neighbouring pixel in one package; at
    # most 0.1% of queries may flip that way (none do on this fixture)
    assert np.mean(ij != it) <= 1e-3
    assert np.mean(vj != vt) <= 1e-3
    assert it.shape == ij.shape and vt.shape == vj.shape


@pytest.mark.parametrize("preset", ["base", "tpu_fast"])
def test_match_edge_batch_matches_jax(preset):
    """``match`` at the edge builder's batch (both directions of an edge,
    b = 2) on the padded record, against JAX, for both presets."""
    maps = [_pair_maps(h=32, w=48, shift=s, seed=i)
            for i, s in enumerate(((1.6, 2.3), (-2.2, 0.7)))]
    X11, X21, D11, D21 = (np.concatenate(a) for a in zip(*maps))
    kw = PRESETS[preset]
    ij, vj = jm.match(*(jnp.asarray(a) for a in (X11, X21, D11, D21)), **kw)
    it, vt = tm.match(*(torch.from_numpy(a) for a in (X11, X21, D11, D21)),
                      **kw)
    assert it.shape == (2, 32 * 48) and vt.shape == (2, 32 * 48, 1)
    assert np.mean(np.asarray(ij) != it.numpy()) <= 1e-3
    assert np.mean(np.asarray(vj) != vt.numpy()) <= 1e-3
    assert not np.array_equal(it.numpy()[0], it.numpy()[1])


def test_match_subpixel_and_subgrid_queries():
    X11, X21, D11, D21 = _pair_maps(h=24, w=32)
    args_j = [jnp.asarray(a) for a in (X11, X21, D11, D21)]
    args_t = [torch.from_numpy(a) for a in (X11, X21, D11, D21)]
    ij, vj, pj = jm.match(*args_j, subpixel=True)
    it, vt, pt = tm.match(*args_t, subpixel=True)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)

    # every 2nd query column against the full-resolution target
    Xq, Dq = X21[:, :, ::2], D21[:, :, ::2]
    h, w = X11.shape[1:3]
    init = (np.arange(h)[:, None] * w + np.arange(0, w, 2)[None]).reshape(
        1, -1).astype(np.int32)
    ij, vj = jm.match(args_j[0], jnp.asarray(Xq), args_j[2], jnp.asarray(Dq),
                      idx_1_to_2_init=jnp.asarray(init), radius=2,
                      dilation_max=2)
    it, vt = tm.match(args_t[0], torch.from_numpy(np.ascontiguousarray(Xq)),
                      args_t[2], torch.from_numpy(np.ascontiguousarray(Dq)),
                      idx_1_to_2_init=torch.from_numpy(init), radius=2,
                      dilation_max=2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_match_raises_like_jax():
    X11, X21, D11, D21 = (torch.from_numpy(a) for a in _pair_maps(h=24, w=32))
    odd = [a[:, :23] for a in (X11, X21, D11, D21)]
    with pytest.raises(ValueError, match="even working resolution"):
        tm.match(*odd, coarse_iter=3)
    with pytest.raises(ValueError, match="refine_dtype"):
        tm.match(X11, X21, D11, D21, refine_dtype="fp8")
    with pytest.raises(ValueError, match="sub-grid"):
        tm.match(X11, X21[:, :, ::2], D11, D21[:, :, ::2])
    with pytest.raises(NotImplementedError):
        tm.match(X11, X21, D11, D21, separable_refine=True)
    with pytest.raises(NotImplementedError):
        tm.match(X11, X21, D11, D21, payload=X11)
