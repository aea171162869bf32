"""Port MASt3R network == the JAX network with the same weights carried
across by ``from_jax_params`` (fp32, rtol/atol 1e-4: the same layers in
fp32, summed in another order by another BLAS)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import convert as jconvert
from mast3r_slam_tpu.models import mast3r as jm
from mast3r_slam_tpu_torch.models import convert as tconvert
from mast3r_slam_tpu_torch.models import mast3r as tm

# the suite runs several test processes side by side on a few cores;
# one intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)

SMALL = dict(img_size=(32, 48), enc_depth=2, enc_embed_dim=64,
             enc_num_heads=4, dec_depth=2, dec_embed_dim=32, dec_num_heads=2,
             desc_dim=16, feature_dim=16, last_dim=8, layer_dims=(8, 8, 16, 32),
             dtype="float32")
CONFIGS = {"tiny": {k: getattr(jm.TINY, k) for k in jm.TINY._fields},
           "small": SMALL}


def _models(name, seed=0):
    jcfg = jm.MASt3RConfig(**CONFIGS[name])
    tcfg = tm.MASt3RConfig(**CONFIGS[name])
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(seed), jcfg))
    model = tm.build(tcfg, device="cpu")
    model.load_state_dict(tconvert.from_jax_params(params))
    return jcfg, tcfg, params, model


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return _models(request.param)


def _frames(cfg, b, seed):
    rng = np.random.default_rng(seed)
    h, w = cfg.img_size
    return rng.integers(0, 255, (b, h, w, 3), np.uint8)


def test_encode_matches_jax(models):
    jcfg, tcfg, params, model = models
    img = _frames(jcfg, 2, 1)
    fj, pj = jm.encode(params, jnp.asarray(img), jcfg)
    ft, pt = tm.encode(model, torch.from_numpy(img), tcfg)
    _close(ft, fj)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_inference_mono_and_asymmetric_match_jax(models):
    jcfg, tcfg, params, model = models
    img = _frames(jcfg, 2, 2)
    fj, pj = jm.encode(params, jnp.asarray(img), jcfg)
    # both sides decode the same encoder features
    f_np, p_np = np.array(fj), np.array(pj)
    ft, pt = torch.from_numpy(f_np), torch.from_numpy(p_np).long()
    Xj, Cj = jm.inference_mono(params, fj[:1], pj[:1], jcfg)
    Xt, Ct = tm.inference_mono(model, ft[:1], pt[:1], tcfg)
    _close(Xt, Xj)
    _close(Ct, Cj)
    outj = jm.inference_asymmetric(params, fj[:1], pj[:1], fj[1:], pj[1:],
                                   jcfg)
    outt = tm.inference_asymmetric(model, ft[:1], pt[:1], ft[1:], pt[1:],
                                   tcfg)
    for t, j in zip(outt, outj):
        assert t.shape == j.shape
        _close(t, j)


def test_inference_symmetric_matches_jax(models):
    """Both decode directions as one decoder batch of 2b, b = 2 edges."""
    jcfg, tcfg, params, model = models
    img = _frames(jcfg, 3, 6)
    fj, pj = jm.encode(params, jnp.asarray(img), jcfg)
    ft = torch.from_numpy(np.array(fj))
    pt = torch.from_numpy(np.array(pj)).long()
    outj = jm.inference_symmetric(params, fj[:2], pj[:2], fj[1:], pj[1:], jcfg)
    outt = tm.inference_symmetric(model, ft[:2], pt[:2], ft[1:], pt[1:], tcfg)
    assert sorted(outt) == sorted(outj) and len(outt) == 16
    for k in outj:
        assert outt[k].shape == outj[k].shape, k
        _close(outt[k], outj[k])


def test_downsample_and_mono_ds():
    jcfg, tcfg, params, model = _models("tiny", seed=3)
    img = _frames(jcfg, 1, 4)
    fj, pj = jm.encode(params, jnp.asarray(img), jcfg)
    ft, pt = torch.from_numpy(np.array(fj)), torch.from_numpy(
        np.array(pj)).long()
    Xj, Cj = jm.inference_mono(params, fj, pj, jcfg, ds=2)
    Xt, Ct = tm.inference_mono(model, ft, pt, tcfg, ds=2)
    _close(Xt, Xj)
    _close(Ct, Cj)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_from_jax_params_equals_export_state_dict(name):
    jcfg = jm.MASt3RConfig(**CONFIGS[name])
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(5), jcfg))
    ref = jconvert.export_state_dict(params, jcfg)
    got = tconvert.from_jax_params(params)
    assert list(got) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # and the port's module has exactly these parameters
    model = tm.build(tm.MASt3RConfig(**CONFIGS[name]), device="cpu")
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k


def test_init_params_with_generator_is_seeded():
    cfg = tm.MASt3RConfig(**CONFIGS["tiny"])
    a = tm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    c = tm.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["enc_blocks.0.attn.qkv.weight"],
                           sc["enc_blocks.0.attn.qkv.weight"])
    img = torch.from_numpy(_frames(cfg, 1, 0))
    feat, pos = tm.encode(a, img, cfg)
    assert torch.isfinite(feat).all()
    out = tm.inference_symmetric(a, feat, pos, feat, pos, cfg)
    assert len(out) == 16
    assert all(torch.isfinite(v).all() for v in out.values())
