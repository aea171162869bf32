"""Port Scharr stencil (the plain version behind the ``scharr_rays`` CUDA
kernel) == the JAX XLA stencil and the Pallas kernel in interpret mode
(atol 1e-6: the same nine-tap sums in fp32, in possibly another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import gradient as jgrad
from mast3r_slam_tpu.ops import matching as jmatch
from mast3r_slam_tpu.ops import pallas_gradient
from mast3r_slam_tpu_torch.ops import gradient as tgrad

# the suite runs several test processes side by side on a few cores;
# one intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

ATOL = 1e-6


@pytest.mark.parametrize("shape", [(17, 33, 3), (2, 8, 16, 3), (1, 12, 20, 9),
                                   (3, 2, 5, 7, 4)])
def test_img_gradient_matches_xla_and_pallas(shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    img = rng.standard_normal(shape).astype(np.float32)
    gx_t, gy_t = tgrad.img_gradient(torch.from_numpy(img))
    gx_j, gy_j = jgrad.img_gradient(jnp.asarray(img))
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=ATOL)
    np.testing.assert_allclose(gy_t.numpy(), np.asarray(gy_j), atol=ATOL)
    if len(shape) <= 4:
        gx_p, gy_p = pallas_gradient.img_gradient_pallas(jnp.asarray(img),
                                                         interpret=True)
        np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_p), atol=ATOL)
        np.testing.assert_allclose(gy_t.numpy(), np.asarray(gy_p), atol=ATOL)


@pytest.mark.parametrize("b", [1, 2])
def test_prep_rays_grad_matches_jax(b):
    rng = np.random.default_rng(b)
    X = (rng.standard_normal((b, 12, 20, 3)) + [0, 0, 3]).astype(np.float32)
    out = tgrad.prep_rays_grad(torch.from_numpy(X))
    ref = jmatch.prep_rays_grad(jnp.asarray(X))
    assert out.shape == (b, 12, 20, 9)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # the fused kernel's semantics: Pallas stencil of the normalized rays
    rays = X / np.linalg.norm(X, axis=-1, keepdims=True)
    gx_p, gy_p = pallas_gradient.img_gradient_pallas(jnp.asarray(rays),
                                                     interpret=True)
    np.testing.assert_allclose(out[..., 3:6].numpy(), np.asarray(gx_p),
                               atol=ATOL)
    np.testing.assert_allclose(out[..., 6:9].numpy(), np.asarray(gy_p),
                               atol=ATOL)


def test_cuda_only_path_refuses_cpu_fallback_arguments():
    """The kernel wrapper's checks raise instead of running something else."""
    X = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError):
        tgrad._scharr_cuda(X, normalize=True)   # a CPU tensor is refused


@pytest.mark.parametrize("b", [1, 2])
def test_prep_rays_grad_padded_matches_jax(b):
    """The padded 12-float record that ``match`` hands ``iter_proj``:
    channels 0-8 are JAX's image (within ATOL) and the port's 9-channel
    image (bit-equal); channels 9-11 are exactly zero."""
    rng = np.random.default_rng(10 + b)
    X = (rng.standard_normal((b, 13, 18, 3)) + [0, 0, 3]).astype(np.float32)
    out = tgrad.prep_rays_grad_padded(torch.from_numpy(X))
    ref = jmatch.prep_rays_grad(jnp.asarray(X))
    assert out.shape == (b, 13, 18, 12) and out.is_contiguous()
    np.testing.assert_allclose(out[..., :9].numpy(), np.asarray(ref),
                               atol=ATOL)
    assert torch.equal(out[..., :9],
                       tgrad.prep_rays_grad(torch.from_numpy(X)))
    assert torch.count_nonzero(out[..., 9:]) == 0


def test_padded_wrapper_refuses_cpu_tensors():
    X = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError):
        tgrad._scharr_cuda(X, normalize=True, out_c=12)  # a CPU tensor
