"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the GPU. Without a CUDA device every test here skips (the CPU
tests compare the plain versions with the JAX package instead); on the GPU
run ``python -m pytest tests/test_torch_kernels_cuda.py``.

Tolerances: the kernels are built with -fmad=false and keep the plain
versions' operation order, so floats agree to 1e-6 (observed: exactly) and
integer outputs and converged flags are equal."""

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


def test_wrappers_refuse_bad_inputs(cuda):
    from mast3r_slam_tpu_torch.ops import matching

    D = torch.zeros(1, 8, 8, 24, device=cuda)          # fp32: not bf16/int8
    with pytest.raises(ValueError):
        matching.refine_matches(D, D.reshape(1, 64, 24), torch.zeros(
            1, 64, 2, dtype=torch.int32, device=cuda))
    img = torch.zeros(1, 8, 8, 9, device=cuda)
    with pytest.raises(ValueError):                     # not contiguous
        matching.iter_proj(img, torch.zeros(1, 4, 6, device=cuda)[..., :3],
                           torch.zeros(1, 4, 2, device=cuda))
