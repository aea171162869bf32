"""Port retrieval == the JAX package's ``slam/retrieval.py``.

Seeded numpy parameters and frames go through both packages
(``convert.retrieval_params_from_jax`` carries the head and codebook):

* ``prep_features``: 1e-5 absolute on O(1) features (both fp32; the matrix
  products sum in another order);
* ``quantize``: word ids equal (checked on inputs whose nearest centroids
  are well apart; a near-tie could order two words differently);
* ``aggregate_residuals``: 1e-5 (the same numpy code on the same inputs);
* the two inverted files, numpy and native, of both packages on identical
  packed inputs: scores exactly equal between the packages, and numpy
  against native to 1e-6 (the native engine sums in float64);
* ``flat_state`` round trip, kind mismatch, ``prefetch`` == inline, and the
  one deliberate difference: the port's ``use_native=True`` raises when the
  library cannot be built, where the JAX package falls back to numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import native as jnative
from mast3r_slam_tpu.slam import retrieval as jret
from mast3r_slam_tpu_torch import native as tnative
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.slam import retrieval as tret

torch.set_num_threads(1)

DIM, N_WORDS, N_TOK = 64, 128, 64


def _rparams(seed=0, dim=DIM, n_words=N_WORDS, postwhiten=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {
        "prewhiten": {"m": 0.1 * f(dim), "p": np.eye(dim, dtype=np.float32)
                      + 0.05 * f(dim, dim)},
        "projector": {"w": f(dim, dim) / np.sqrt(dim), "b": 0.1 * f(dim)},
        "postwhiten": ({"m": 0.1 * f(dim), "p": np.eye(dim, dtype=np.float32)
                        + 0.05 * f(dim, dim)} if postwhiten else None),
        "centroids": f(n_words, dim),
    }
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    if not postwhiten:
        jtree["postwhiten"] = None
    return tree, jtree, convert.retrieval_params_from_jax(tree, device="cpu")


def _frames(n, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, N_TOK, DIM)).astype(np.float32)


def _dbs(use_native, seed=0, nfeat=32):
    _, jtree, ttree = _rparams(seed)
    dj = jret.RetrievalDatabase(jtree, jret.RetrievalConfig(nfeat=nfeat),
                                use_native=use_native)
    dt = tret.RetrievalDatabase(ttree, tret.RetrievalConfig(nfeat=nfeat),
                                use_native=use_native)
    if use_native:
        assert dj.native is not None, "the JAX package's native lib is missing"
    return dj, dt


@pytest.mark.parametrize("postwhiten", [True, False])
@pytest.mark.parametrize("nfeat", [32, 300])
def test_prep_features_matches_jax(postwhiten, nfeat):
    _, jtree, ttree = _rparams(2, postwhiten=postwhiten)
    x = _frames(1, seed=4)[0]
    ref = np.asarray(jret.prep_features(jtree, jnp.asarray(x), nfeat))
    got = tret.prep_features(ttree, torch.from_numpy(x), nfeat)
    assert got.shape == ref.shape == (min(nfeat, N_TOK), DIM)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    # bf16 tokens, as the keyframe store keeps them, promote to fp32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    refb = np.asarray(jret.prep_features(
        jtree, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), nfeat))
    gotb = tret.prep_features(ttree, xb, nfeat)
    assert gotb.dtype == torch.float32
    np.testing.assert_allclose(gotb.numpy(), refb, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 5])
def test_quantize_word_ids_equal_jax(k):
    rng = np.random.default_rng(7)
    cent = rng.standard_normal((N_WORDS, DIM)).astype(np.float32)
    # features near known centroids: the nearest words are well apart
    feats = cent[rng.integers(0, N_WORDS, 40)] + 0.05 * rng.standard_normal(
        (40, DIM)).astype(np.float32)
    ref = np.asarray(jret.quantize(jnp.asarray(feats), jnp.asarray(cent), k))
    got = tret.quantize(torch.from_numpy(feats), torch.from_numpy(cent), k)
    assert got.shape == (40, k)
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the fused call returns the same two results
    _, jtree, ttree = _rparams(3)
    x = _frames(1, seed=8)[0]
    fj, wj = jret.prep_and_quantize(jtree, jnp.asarray(x), 32, k)
    ft, wt = tret.prep_and_quantize(ttree, torch.from_numpy(x), 32, k)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_aggregate_residuals_matches_jax_and_reference_loop():
    rng = np.random.default_rng(3)
    n, dim, ma, n_words = 50, 16, 5, 24
    des = rng.standard_normal((n, dim)).astype(np.float32)
    centroids = rng.standard_normal((n_words, dim)).astype(np.float32)
    words = rng.integers(0, n_words, size=(n, ma))
    words[:10, 1] = words[:10, 0]           # duplicate columns in some rows
    words[5:15, 4] = words[5:15, 2]
    aj, ij = jret.aggregate_residuals(des, words, centroids)
    at, it = tret.aggregate_residuals(des, words, centroids)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(at, aj, atol=1e-5, rtol=0)
    ref = np.stack([(des[(words == w).any(axis=1)] - centroids[w]).sum(0)
                    for w in np.unique(words)])
    np.testing.assert_allclose(at, ref, atol=1e-4)
    pj, _ = jret.aggregate_image(des, words, centroids)
    pt, _ = tret.aggregate_image(des, words, centroids)
    np.testing.assert_array_equal(pt, pj)


def test_binarize_and_hamming_match_jax_and_native():
    rng = np.random.default_rng(0)
    des = rng.standard_normal((16, 96)).astype(np.float32)
    np.testing.assert_array_equal(tret.binarize_pack(des),
                                  jret.binarize_pack(des))
    p8 = tret.binarize_pack(des)
    np.testing.assert_array_equal(tret.hamming_cdist_packed(p8, p8, 96),
                                  jret.hamming_cdist_packed(p8, p8, 96))
    p64 = tnative.binarize_pack64(des)
    np.testing.assert_array_equal(p64, jnative.binarize_pack64(des))
    import ctypes

    out = np.zeros((16, 16), dtype=np.float32)
    cp = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    tnative.load().asmk_hamming_cdist(cp(p64), 16, cp(p64), 16, 96, cp(out))
    np.testing.assert_allclose(out, tret.hamming_cdist_packed(p8, p8, 96),
                               atol=1e-6)


def test_ivf_scores_equal_on_identical_packed_inputs():
    """The same aggregated residuals into all four inverted files."""
    rng = np.random.default_rng(5)
    dim, n_words = 64, 40
    ivfs = {"jn": jret.IVF(n_words, dim), "tn": tret.IVF(n_words, dim),
            "jc": jnative.NativeIVF(n_words, dim),
            "tc": tnative.NativeIVF(n_words, dim)}
    for imid in range(5):
        words = np.unique(rng.integers(0, n_words, 12))
        ades = rng.standard_normal((len(words), dim)).astype(np.float32)
        for k in ("jn", "tn"):
            ivfs[k].add(tret.binarize_pack(ades), words,
                        np.full(len(words), imid, dtype=np.int64))
        for k in ("jc", "tc"):
            ivfs[k].add_packed(tnative.binarize_pack64(ades), words, imid)
    qw = np.unique(rng.integers(0, n_words, 20))
    qd = rng.standard_normal((len(qw), dim)).astype(np.float32)
    s = {k: ivfs[k].search(tret.binarize_pack(qd), qw, 3.0, 0.0)
         for k in ("jn", "tn")}
    s.update({k: ivfs[k].search_packed(tnative.binarize_pack64(qd), qw, 3.0,
                                       0.0) for k in ("jc", "tc")})
    assert s["tn"].shape == (5,) and float(s["tn"].max()) > 0
    np.testing.assert_array_equal(s["tn"], s["jn"])
    np.testing.assert_array_equal(s["tc"], s["jc"])
    np.testing.assert_allclose(s["tc"], s["tn"], atol=1e-6, rtol=0)
    for a, b in ((ivfs["tn"], ivfs["jn"]), (ivfs["tc"], ivfs["jc"])):
        fa, fb = a.flat_state(), b.flat_state()
        assert sorted(fa) == sorted(fb)
        for key in fa:
            np.testing.assert_array_equal(np.asarray(fa[key]),
                                          np.asarray(fb[key]))
    st = tret.IVF.from_state(ivfs["tn"].state_dict())
    np.testing.assert_array_equal(
        st.search(tret.binarize_pack(qd), qw, 3.0, 0.0), s["tn"])


@pytest.mark.parametrize("use_native", [False, True])
def test_database_updates_equal_jax(use_native):
    dj, dt = _dbs(use_native)
    frames = _frames(6)
    for i in range(6):
        a = dj.update(jnp.asarray(frames[i]), add_after_query=True, k=3,
                      min_thresh=0.0)
        b = dt.update(torch.from_numpy(frames[i]), add_after_query=True, k=3,
                      min_thresh=0.0)
        assert a == b, (i, a, b)
    noisy = frames[2] + 0.01 * np.random.default_rng(9).standard_normal(
        frames[2].shape).astype(np.float32)
    a = dj.update(jnp.asarray(noisy), add_after_query=False, k=3,
                  min_thresh=0.0)
    b = dt.update(torch.from_numpy(noisy), add_after_query=False, k=3,
                  min_thresh=0.0)
    assert a == b and b[0] == 2
    assert dt.kf_counter == dj.kf_counter == 6
    # a threshold above every score returns nothing
    assert dt.update(torch.from_numpy(noisy), add_after_query=False, k=3,
                     min_thresh=10.0) == []


def test_prefetch_matches_inline():
    _, dt_a = _dbs(False, seed=5)
    _, dt_b = _dbs(False, seed=5)
    frames = torch.from_numpy(_frames(6, seed=7))
    for i in range(6):
        a = dt_a.update(frames[i], add_after_query=True, k=3, min_thresh=0.0)
        pref = dt_b.prefetch(frames[i])
        assert pref[2] is None          # no event on the CPU
        b = dt_b.update(None, add_after_query=True, k=3, min_thresh=0.0,
                        prefetched=pref)
        assert a == b, (i, a, b)
    q = frames[3] + 0.01
    a = dt_a.update(q, add_after_query=False, k=3, min_thresh=0.0)
    b = dt_b.update(None, add_after_query=False, k=3, min_thresh=0.0,
                    prefetched=dt_b.prefetch(q))
    assert a == b


@pytest.mark.parametrize("use_native", [False, True])
def test_ivf_flat_state_roundtrip(use_native):
    _, db = _dbs(use_native)
    frames = torch.from_numpy(_frames(6))
    for i in range(6):
        db.update(frames[i], add_after_query=True, k=3)
    st_np = {k: np.asarray(v) for k, v in db.state_dict().items()}
    assert str(st_np["kind"]) == ("native" if use_native else "numpy")
    for v in st_np.values():
        assert v.dtype != object
    _, db2 = _dbs(use_native)
    assert db2.load_state_dict(st_np)
    assert db2.kf_counter == db.kf_counter
    for i in range(6):
        assert (db.update(frames[i], add_after_query=False, k=3)
                == db2.update(frames[i], add_after_query=False, k=3))
    extra = torch.from_numpy(_frames(2, seed=9))
    a = db.update(extra[0], add_after_query=True, k=3)
    b = db2.update(extra[0], add_after_query=True, k=3)
    assert a == b and db.kf_counter == db2.kf_counter


def test_ivf_kind_mismatch_is_refused():
    _, db_np = _dbs(False)
    _, db_nat = _dbs(True)
    frames = torch.from_numpy(_frames(3))
    for i in range(3):
        db_np.update(frames[i], add_after_query=True, k=2)
        db_nat.update(frames[i], add_after_query=True, k=2)
    st = {k: np.asarray(v) for k, v in db_np.state_dict().items()}
    assert not _dbs(True)[1].load_state_dict(st)
    st_nat = {k: np.asarray(v) for k, v in db_nat.state_dict().items()}
    assert not _dbs(False)[1].load_state_dict(st_nat)
    assert not _dbs(False)[1].load_state_dict(
        dict(st, kind=np.asarray("unknown")))


def test_use_native_raises_when_the_build_fails(monkeypatch, tmp_path):
    """No quiet switch to the numpy IVF: a compiler that is not there, or a
    source that does not compile, raises; ``use_native=False`` still
    works."""
    _, _, ttree = _rparams(0)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="native ASMK"):
        tret.RetrievalDatabase(ttree)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "CXX", "g++")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed"):
        tret.RetrievalDatabase(ttree, use_native=True)
    assert not list(tmp_path.glob("*.so"))
    db = tret.RetrievalDatabase(ttree, use_native=False)
    assert db.native is None and isinstance(db.ivf, tret.IVF)


def test_library_is_built_from_the_ports_source():
    so = tnative.lib_path()
    tnative.load()
    assert so.exists() and "torch_kernels" in str(so)
    assert tnative.SOURCE.parent.name == "native"
    assert "mast3r_slam_tpu_torch" in str(tnative.SOURCE)


def test_init_retrieval_params_shapes_and_seed():
    g = torch.Generator().manual_seed(3)
    p = tret.init_retrieval_params(g, backbone_dim=32, proj_dim=16,
                                   codebook_size=40, device="cpu")
    assert p["projector"]["w"].shape == (32, 16)
    assert p["centroids"].shape == (40, 16)
    assert torch.equal(p["prewhiten"]["p"], torch.eye(32))
    assert torch.equal(p["postwhiten"]["p"], torch.eye(16))
    q = tret.init_retrieval_params(torch.Generator().manual_seed(3),
                                   backbone_dim=32, proj_dim=16,
                                   codebook_size=40, device="cpu")
    assert torch.equal(p["centroids"], q["centroids"])
    assert abs(float(p["projector"]["w"].std()) - 32 ** -0.5) < 0.02


@pytest.mark.parametrize("postwhiten,wrapped", [(True, True), (False, False)])
def test_convert_retrieval_checkpoint_equals_jax(tmp_path, postwhiten,
                                                 wrapped):
    """A seeded retrieval ``.pth`` in the released layout and a codebook
    pickle (the released nesting, or the bare array) give equal arrays
    through both converters."""
    import pickle

    tree, _, _ = _rparams(seed=4, postwhiten=postwhiten)
    t = lambda a: torch.from_numpy(np.asarray(a))
    sd = {"prewhiten.m": t(tree["prewhiten"]["m"])[None],
          "prewhiten.p": t(tree["prewhiten"]["p"]),
          "projector.weight": t(tree["projector"]["w"].T),
          "projector.bias": t(tree["projector"]["b"])}
    if postwhiten:
        sd.update({"postwhiten.m": t(tree["postwhiten"]["m"])[None],
                   "postwhiten.p": t(tree["postwhiten"]["p"])})
    torch.save({"model": sd}, tmp_path / "r.pth")
    cb = tree["centroids"]
    with open(tmp_path / "c.pkl", "wb") as f:
        pickle.dump({"train_codebook": {"codebook": {"centroids": cb}}}
                    if wrapped else cb, f)
    pj = jret.convert_retrieval_checkpoint(tmp_path / "r.pth",
                                           tmp_path / "c.pkl")
    pt = tret.convert_retrieval_checkpoint(tmp_path / "r.pth",
                                           tmp_path / "c.pkl", device="cpu")
    assert sorted(pt) == sorted(pj)
    assert (pt["postwhiten"] is None) == (not postwhiten)
    leaves = [(k, n) for k in ("prewhiten", "projector", "postwhiten")
              if pj[k] is not None for n in pj[k]]
    for k, n in leaves:
        assert pt[k][n].dtype == torch.float32
        np.testing.assert_array_equal(pt[k][n].numpy(), pj[k][n],
                                      err_msg=f"{k}.{n}")
    np.testing.assert_array_equal(pt["centroids"].numpy(), pj["centroids"])
    np.testing.assert_array_equal(pt["projector"]["w"].numpy(),
                                  tree["projector"]["w"])
    # the converted head runs the port's feature prep
    feats = tret.prep_features(pt, torch.from_numpy(_frames(1)[0]), 16)
    assert feats.shape == (16, DIM) and torch.isfinite(feats).all()
