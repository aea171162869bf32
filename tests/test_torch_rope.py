"""Port 2-D RoPE == the JAX package's ``models/rope.py::rope_2d``.

The same seeded numpy tokens and integer positions go through both. The
port's plain version (``apply_rope`` with ``rope_tables``, then the cast)
is the one the CPU runs and the one the CUDA kernel ``rope_qk`` is held
against on the GPU (``tests/test_torch_kernels_cuda.py``). Tolerance 1e-6
absolute on O(1) tokens: both compute ``x*cos + rot*sin`` in fp32 and differ
only in how ``cos``/``sin``/``pow`` round (observed 2.4e-7). With a bf16
output the two may round a value at a bf16 tie differently: one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import rope as jrope
from mast3r_slam_tpu_torch.models import rope as trope

torch.set_num_threads(1)


def _inputs(b, heads, nh, nw, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, heads, nh * nw, d)).astype(np.float32)
    pos = np.stack(np.meshgrid(np.arange(nh), np.arange(nw), indexing="ij"),
                   -1).reshape(1, nh * nw, 2).repeat(b, 0)
    return x, pos


@pytest.mark.parametrize("b,heads,nh,nw,d", [(1, 4, 4, 6, 16),
                                             (2, 3, 24, 32, 64),
                                             (3, 2, 5, 3, 8)])
def test_rope_2d_and_apply_rope_match_jax(b, heads, nh, nw, d):
    x, pos = _inputs(b, heads, nh, nw, d, seed=d)
    ref = np.asarray(jrope.rope_2d(jnp.asarray(x), jnp.asarray(pos), 100.0))
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos)
    got = trope.rope_2d(xt, pt, 100.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    tabs = trope.rope_tables(pt, d, 100.0, torch.float32)
    assert tabs[0].shape == (b, 1, nh * nw, d)
    assert torch.equal(trope.apply_rope(xt, tabs), got)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_rope_qk_strided_inputs_match_jax(out_dtype):
    """q and k as the attention code hands them over: strided views of one
    fused qkv projection output; the result is dense and in ``out_dtype``."""
    b, heads, nh, nw, d = 2, 4, 4, 6, 16
    n = nh * nw
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((b, n, 3, heads, d)).astype(np.float32)
    _, pos = _inputs(b, heads, nh, nw, d, seed=0)
    t = torch.from_numpy(qkv)
    q, k = (t[:, :, i].transpose(1, 2) for i in (0, 1))
    assert not q.is_contiguous()
    tabs = trope.rope_tables(torch.from_numpy(pos), d, 100.0, torch.float32)
    qo, ko = trope.rope_qk(q, k, tabs, tabs, out_dtype)
    assert qo.dtype == ko.dtype == out_dtype
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    tol = 1e-6 if out_dtype == torch.float32 else 2.0 ** -7   # one bf16 ulp
    for got, i in ((qo, 0), (ko, 1)):
        ref = jrope.rope_2d(jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3)),
                            jnp.asarray(pos), 100.0).astype(jdt)
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(got.float().numpy() - ref) / np.maximum(np.abs(ref), 1.0)
        assert err.max() <= tol
        if out_dtype == torch.bfloat16:
            assert (got.float().numpy() == ref).mean() > 0.99


def test_rope_qk_distinct_q_and_k_tables_match_jax():
    """Cross attention: q and k have their own token counts, positions and
    tables; split-heads views."""
    b, heads, d = 2, 3, 16
    rng = np.random.default_rng(5)
    nq, nk = 24, 15
    xq = rng.standard_normal((b, nq, heads * d)).astype(np.float32)
    xk = rng.standard_normal((b, nk, heads * d)).astype(np.float32)
    pq = rng.integers(0, 9, (b, nq, 2))
    pk = rng.integers(0, 9, (b, nk, 2))
    split = lambda a: torch.from_numpy(a).reshape(
        b, a.shape[1], heads, d).transpose(1, 2)
    tq = trope.rope_tables(torch.from_numpy(pq), d, 100.0, torch.float32)
    tk = trope.rope_tables(torch.from_numpy(pk), d, 100.0, torch.float32)
    qo, ko = trope.rope_qk(split(xq), split(xk), tq, tk)
    jsplit = lambda a: jnp.asarray(a).reshape(
        b, a.shape[1], heads, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(
        qo.numpy(), np.asarray(jrope.rope_2d(jsplit(xq), jnp.asarray(pq))),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        ko.numpy(), np.asarray(jrope.rope_2d(jsplit(xk), jnp.asarray(pk))),
        atol=1e-6, rtol=0)
    # the tables really differ: k rotated by q's would be wrong
    assert float((trope.apply_rope(split(xk), (tq[0][:, :, :nk],
                                               tq[1][:, :, :nk]))
                  - ko).abs().max()) > 1e-2
