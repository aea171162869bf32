"""The port's data-parallel tracking and sharded edge decode
(``parallel/dp_tracking.py``) against the JAX package's, and the one-process
behaviour of the multi-host helpers of ``parallel/mesh.py``.

* ``track_window_dp`` over ``[cpu, cpu]`` equals two lone
  ``_track_window_body`` runs bit for bit (the port of
  ``tests/test_dp_tracking.py:63``), and is held to JAX's
  ``track_window_dp`` on two of the 8 virtual CPU devices on the JAX
  oracle's replayed outputs: the integer stats (skip, failed, new
  keyframe, active) equal, the keyframe ids and counts equal, poses and the
  fractions within 5e-4, maps within 1e-4 (the tolerances of
  ``tests/test_torch_window.py::test_window_matches_jax_on_replayed_oracle``).
* ``inference_symmetric_dp`` (the edge batch split over a device list) is
  held to the unsharded decode and to JAX's sharded decode of
  ``tests/test_parallel.py:38`` at atol 2e-3 (its tolerance). Observed on
  the CPU: 0.0 against the unsharded port decode, 2.2e-6 against JAX.
* ``init_distributed`` with one process, ``make_mesh_2d`` on one host
  (``tests/test_parallel.py:69``) and the backend rule.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec

from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.models import TINY
from mast3r_slam_tpu.models import init_params as jinit_params
from mast3r_slam_tpu.models import mast3r as jmast3r
from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu.parallel import mesh as jmesh
from mast3r_slam_tpu.parallel.dp_tracking import track_window_dp as j_dp
from mast3r_slam_tpu.slam import tracker as jtracker
from mast3r_slam_tpu.slam.factor_graph import MatchingConfig as JMatching
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.lie import sim3 as tsim3
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.parallel import dp_tracking, mesh
from mast3r_slam_tpu_torch.slam.frame import KeyframeStore
from mast3r_slam_tpu_torch.slam.system import _track_window_body

torch.set_num_threads(1)

CPU = torch.device("cpu")
# tests/test_dp_tracking.py's sizes
CFG_KW = dict(img_size=(32, 48), enc_embed_dim=32, desc_dim=8,
              dtype="float32")
JCFG = jmast3r.MASt3RConfig(**CFG_KW)
TCFG = tmast3r.MASt3RConfig(**CFG_KW)
H, W = CFG_KW["img_size"]
N = H * W
WIN, S, CAP = 3, 2, 8
FIRST = (0, 5)
STATIC = dict(ds=1, fuse_mode="weighted_pointmap", score_fn="median",
              use_calib=False)
POSE_TOL, MAP_TOL = 5e-4, 1e-4


def _traj(n):
    """``tests/test_dp_tracking.py::_traj``."""
    Ts = [jsim3.identity()]
    for i in range(1, n):
        xi = jnp.array([0.15, 0.03 * np.sin(i / 2), 0.03,
                        0.0, 0.05, 0.01, 0.0])
        Ts.append(jsim3.mul(Ts[-1], jsim3.exp(xi)))
    return jnp.stack(Ts)


def _configs():
    mcfg = tconfig.MatchingConfig(dilation_max=1, max_iter=4, radius=2)
    tcfg = tconfig.TrackerConfig(match_frac_thresh=0.95)
    return mcfg, tcfg


def _replay(jp):
    """A port model module returning the JAX oracle's outputs."""
    j = lambda x: jnp.asarray(x.numpy())
    t = lambda outs: tuple(torch.from_numpy(np.array(a)) for a in outs)
    return types.SimpleNamespace(
        encode=lambda p, img, cfg: t(joracle.encode(jp, j(img), JCFG)),
        inference_mono=lambda p, f, pos, cfg, ds=1: t(
            joracle.inference_mono(jp, j(f), j(pos), JCFG, ds)),
        inference_asymmetric=lambda p, ff, pf, fk, pk, cfg: t(
            joracle.inference_asymmetric(jp, j(ff), j(pf), j(fk), j(pk),
                                         JCFG)))


def _seq(mod, params, first, device=CPU):
    """A keyframe store seeded at frame ``first`` and the window of the
    next ``WIN`` frames (``tests/test_dp_tracking.py::_seq_inputs``)."""
    img_k = torch.from_numpy(toracle.make_frame_image(first, H, W))[None]
    feat, pos = mod.encode(params, img_k, TCFG)
    Xk, Ck = mod.inference_mono(params, feat, pos, TCFG)
    kfs = KeyframeStore(CAP, N, TCFG.num_patches, TCFG.enc_embed_dim, (H, W),
                        feat_dtype=torch.float32, device=device)
    kfs.X[0], kfs.C[0] = Xk[0], Ck[0, :, 0]
    kfs.N[0] = kfs.N_updates[0] = 1
    kfs.feat[0], kfs.pos[0] = feat[0], pos[0]
    kfs.dataset_idx[0] = first
    kfs.n_size = 1
    imgs = torch.stack([torch.from_numpy(toracle.make_frame_image(
        first + 1 + t, H, W)) for t in range(WIN)]).to(device)
    return dp_tracking.SeqInputs(
        imgs, list(range(first + 1, first + 1 + WIN)),
        torch.arange(N, device=device), tsim3.identity(device=device),
        torch.eye(3, device=device), 0, kfs)


def _lone(mod, params, seq):
    mcfg, tcfg = _configs()
    return _track_window_body(
        mod, params, TCFG, mcfg, tcfg, seq.imgs, seq.frame_ids,
        seq.idx_init, seq.prev_T_WC, seq.K, seq.last_idx, seq.kfs,
        STATIC["ds"], STATIC["fuse_mode"], STATIC["score_fn"],
        STATIC["use_calib"], (H, W))


def _dp(mod, params, seqs, devices=(CPU, CPU)):
    mcfg, tcfg = _configs()
    m = mesh.make_mesh(list(devices))
    return dp_tracking.track_window_dp(
        dp_tracking.replicate_params(params, m), TCFG, mcfg, tcfg, seqs, m,
        model_mod=mod, **STATIC)


def _store(kfs):
    return [kfs.X, kfs.C, kfs.N, kfs.N_updates, kfs.score, kfs.T_WC,
            kfs.feat, kfs.pos, kfs.dataset_idx]


def test_dp_equals_independent_runs():
    """Every output and every store row of each sequence equals its lone
    window bit for bit; at least one keyframe is promoted."""
    params = toracle.make_params(torch.from_numpy(np.array(_traj(12))),
                                 desc_dim=CFG_KW["desc_dim"], device="cpu")
    singles = []
    for first in FIRST:
        seq = _seq(toracle, params, first)
        singles.append((_lone(toracle, params, seq), seq.kfs))
    seqs = [_seq(toracle, params, first) for first in FIRST]
    outs = _dp(toracle, params, seqs)
    assert len(outs) == S
    promoted = 0
    for (single, kfs1), out, seq in zip(singles, outs, seqs):
        for name, a, b in zip(out._fields, out, single):
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg=f"WindowOut.{name}")
        for a, b in zip(_store(seq.kfs), _store(kfs1)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        promoted += int(out.hoststats[:, 5].sum())
        assert bool((out.hoststats[:, 7] == 1).all())
    assert promoted >= 1


def _jax_dp(jp):
    """JAX's ``track_window_dp`` of the two sequences on two of the 8
    virtual CPU devices (``tests/test_dp_tracking.py:85``)."""
    seqs = []
    for first in FIRST:
        img_k = joracle.make_frame_image(first, H, W)[None]
        feat, pos = joracle.encode(jp, img_k, JCFG)
        Xk, Ck = joracle.inference_mono(jp, feat, pos, JCFG)
        bufs = dict(
            kX=jnp.zeros((CAP, N, 3)).at[0].set(Xk[0]),
            kC=jnp.zeros((CAP, N)).at[0].set(Ck[0, :, 0]),
            kN=jnp.zeros((CAP,), jnp.int32).at[0].set(1),
            kNU=jnp.zeros((CAP,), jnp.int32).at[0].set(1),
            kscore=jnp.zeros((CAP,)),
            kT=jnp.zeros((CAP, 8)).at[0].set(jsim3.identity()),
            kfeat=jnp.zeros((CAP,) + feat.shape[1:]).at[0].set(feat[0]),
            kpos=jnp.zeros((CAP,) + pos.shape[1:],
                           pos.dtype).at[0].set(pos[0]),
            kdix=jnp.zeros((CAP,), jnp.int32).at[0].set(first))
        imgs = jnp.stack([joracle.make_frame_image(first + 1 + t, H, W)
                          for t in range(WIN)])
        ids = jnp.arange(first + 1, first + 1 + WIN, dtype=jnp.int32)
        seqs.append((imgs, ids, bufs))
    stack = lambda xs: jnp.stack(list(xs))
    jm = JMesh(np.asarray(jax.devices()[:S]), ("seq",))
    return j_dp(
        jp, JCFG, JMatching(dilation_max=1, max_iter=4, radius=2),
        jtracker.TrackerConfig(match_frac_thresh=0.95),
        stack(s[0] for s in seqs), stack(s[1] for s in seqs),
        jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (S, N)),
        jnp.broadcast_to(jsim3.identity(), (S, 8)),
        jnp.broadcast_to(jnp.eye(3), (S, 3, 3)),
        jnp.zeros((S,), jnp.int32),
        *[stack(s[2][k] for s in seqs) for k in seqs[0][2]],
        1, "weighted_pointmap", "median", False, (H, W), WIN, joracle, jm)


def test_dp_matches_jax_on_replayed_oracle():
    jp = joracle.make_params(_traj(12), desc_dim=CFG_KW["desc_dim"])
    j_out = jax.device_get(_jax_dp(jp))
    mod = _replay(jp)
    seqs = [_seq(mod, None, first) for first in FIRST]
    outs = _dp(mod, None, seqs)
    for s, (out, seq) in enumerate(zip(outs, seqs)):
        hs, jhs = out.hoststats.numpy(), np.asarray(j_out.hoststats[s])
        ints = [3, 4, 5, 7]                # skip, failed, new_kf, active
        np.testing.assert_array_equal(hs[:, ints], jhs[:, ints])
        np.testing.assert_allclose(hs[:, :3], jhs[:, :3], atol=POSE_TOL)
        np.testing.assert_allclose(out.T_WCf.numpy(),
                                   np.asarray(j_out.T_WCf[s]), atol=POSE_TOL)
        np.testing.assert_allclose(out.prev_T_WC.numpy(),
                                   np.asarray(j_out.prev_T_WC[s]),
                                   atol=POSE_TOL)
        k = 1 + int(hs[:, 5].sum())
        kfs = seq.kfs
        np.testing.assert_array_equal(kfs.dataset_idx[:k].numpy(),
                                      np.asarray(j_out.kdix[s][:k]))
        np.testing.assert_array_equal(kfs.N[:k].numpy(),
                                      np.asarray(j_out.kN[s][:k]))
        np.testing.assert_allclose(kfs.T_WC[:k].numpy(),
                                   np.asarray(j_out.kT[s][:k]),
                                   atol=POSE_TOL)
        np.testing.assert_allclose(kfs.X[:k].numpy(),
                                   np.asarray(j_out.kX[s][:k]), atol=MAP_TOL)
        np.testing.assert_allclose(kfs.C[:k].numpy(),
                                   np.asarray(j_out.kC[s][:k]), atol=MAP_TOL)
    assert sum(int(o.hoststats[:, 5].sum()) for o in outs) >= 1


def test_dp_refuses_wrong_sequence_counts_and_devices():
    """S must equal the mesh size (``dp_tracking.py:57-62``), and on a
    mesh across processes the number of local devices; a sequence whose
    tensors lie elsewhere than its mesh device is refused, naming its
    global index; all before any work."""
    params = toracle.make_params(torch.from_numpy(np.array(_traj(12))),
                                 desc_dim=CFG_KW["desc_dim"], device="cpu")
    seq = _seq(toracle, params, 0)
    with pytest.raises(ValueError, match="one sequence per device"):
        _dp(toracle, params, [seq])
    with pytest.raises(ValueError, match="one sequence per device"):
        _dp(toracle, params, [seq] * 3)
    stray = seq._replace(imgs=seq.imgs.to("meta"))
    with pytest.raises(ValueError, match="not on its mesh device"):
        _dp(toracle, params, [seq, stray])
    mcfg, tcfg = _configs()
    # rank 1 of two processes with one device each: one sequence, the
    # global sequence 1
    two = mesh.Mesh((CPU,), "edge", 1, 2, None)
    with pytest.raises(ValueError, match="one sequence per device: got S = "
                       "2 sequences for the 1 local devices of a 2-device"):
        dp_tracking.track_window_dp([params], TCFG, mcfg, tcfg, [seq, seq],
                                    two, model_mod=toracle)
    with pytest.raises(ValueError, match="sequence 1's tensors"):
        dp_tracking.track_window_dp([params], TCFG, mcfg, tcfg, [stray],
                                    two, model_mod=toracle)


def test_replicate_params_shares_a_repeated_device():
    net = tmast3r.build(tmast3r.MASt3RConfig(**{
        k: getattr(TINY, k) for k in TINY._fields}), device="cpu")
    got = dp_tracking.replicate_params({"net": net, "t": torch.ones(2)},
                                       mesh.make_mesh([CPU] * 3))
    assert len(got) == 3 and got[0]["net"] is net
    assert all(g["net"] is net for g in got)


@pytest.fixture(scope="module")
def decode_inputs():
    """``tests/test_parallel.py:38``: the TINY network, 8 images encoded,
    4 edges duplicated to a batch of 8, and JAX's 8-way sharded and local
    decodes of it."""
    cfg = TINY
    params = jinit_params(jax.random.PRNGKey(0), cfg)
    h, w = cfg.img_size
    imgs = jax.random.normal(jax.random.PRNGKey(1), (8, h, w, 3))
    feat, pos = jmast3r.encode(params, imgs, cfg)
    fi, fj, pi, pj = feat[0::2], feat[1::2], pos[0::2], pos[1::2]
    batch = [jnp.concatenate([a, a]) for a in (fi, pi, fj, pj)]
    m = jmesh.make_mesh(8)
    shard = NamedSharding(m, PartitionSpec("edge"))
    j_sharded = jmast3r.inference_symmetric(
        params, *(jax.device_put(a, shard) for a in batch), cfg)
    net = tmast3r.build(tmast3r.MASt3RConfig(**{k: getattr(cfg, k) for k in
                                                cfg._fields}), device="cpu")
    net.load_state_dict(convert.from_jax_params(jax.device_get(params)))
    net = net.eval().requires_grad_(False).store_compute_dtypes()
    t = [torch.from_numpy(np.array(a)) for a in batch]
    return net, t, {k: np.asarray(v) for k, v in j_sharded.items()}


@pytest.mark.parametrize("n_dev,b", [(8, 8), (3, 4)])
def test_sharded_decode_matches_unsharded_and_jax(decode_inputs, n_dev, b):
    """The edge batch over ``n_dev`` copies of the CPU (batch 4 over 3 pads
    to 6 and cuts back): every output equals the unsharded port decode and
    JAX's sharded decode within 2e-3."""
    net, batch, j_sharded = decode_inputs
    cfg = tmast3r.MASt3RConfig(**{k: getattr(TINY, k) for k in
                                  TINY._fields})
    batch = [a[:b] for a in batch]
    m = mesh.make_mesh([CPU] * n_dev)
    got = dp_tracking.inference_symmetric_dp(
        dp_tracking.replicate_params(net, m), m, *batch, cfg)
    local = tmast3r.inference_symmetric(net, *batch, cfg)
    assert set(got) == set(local) == set(j_sharded)
    worst = 0.0
    for k in got:
        assert got[k].shape == local[k].shape and got[k].shape[0] == b
        np.testing.assert_allclose(got[k].numpy(), local[k].numpy(),
                                   atol=2e-3, rtol=0)
        np.testing.assert_allclose(got[k].numpy(), j_sharded[k][:b],
                                   atol=2e-3, rtol=0)
        worst = max(worst, float(np.abs(got[k].numpy()
                                        - j_sharded[k][:b]).max()))
    assert worst < 2e-3


def test_init_distributed_noop_and_2d_mesh(monkeypatch):
    """``tests/test_parallel.py:69``: one process joins no process group;
    the 2-D mesh of one host is (1, local devices) with the axis names of
    JAX's; the backend is ``SLAM_DIST_BACKEND`` when set, else NCCL on CUDA
    and gloo on the CPU."""
    import torch.distributed as dist

    monkeypatch.delenv("SLAM_NUM_PROCESSES", raising=False)
    assert mesh.init_distributed(num_processes=1) is False
    assert mesh.init_distributed() is False
    assert not dist.is_initialized()
    m = mesh.make_mesh_2d(devices=[CPU, CPU])
    assert m.shape == (1, 2) and m.size == 2 and m.first_shard == 0
    assert m.axis == ("host", "edge") and m.world_size == 1
    assert m.group is None
    monkeypatch.delenv("SLAM_DIST_BACKEND", raising=False)
    assert mesh.dist_backend("cpu") == "gloo"
    assert mesh.dist_backend("cuda") == "nccl"
    monkeypatch.setenv("SLAM_DIST_BACKEND", "gloo")
    assert mesh.dist_backend("cuda") == "gloo"


def test_shards_and_reductions_of_a_mesh_across_processes():
    """Rank 1 of a 2 x 2 mesh holds global shards 2 and 3 (``shard_edges``
    gives it those chunks); ``reduce_partials`` in one process sums (or
    min-reduces) the local partials in shard order on the first device."""
    m = mesh.Mesh((CPU, CPU), ("host", "edge"), 1, 2, None)
    assert m.size == 4 and m.first_shard == 2 and m.shape == (2, 2)
    (chunks,) = mesh.shard_edges(m, torch.arange(8))
    assert [c.tolist() for c in chunks] == [[4, 5], [6, 7]]
    one = mesh.make_mesh([CPU] * 3)
    parts = [(torch.tensor([1.0, 2.0]), torch.tensor(True)),
             (torch.tensor([3.0, 4.0]), torch.tensor(False)),
             (torch.tensor([5.0, 6.0]), torch.tensor(True))]
    total, _ = mesh.reduce_partials(one, parts)
    assert total.tolist() == [9.0, 12.0]
    low, ok = mesh.reduce_partials(one, parts, op="min")
    assert low.tolist() == [1.0, 2.0] and ok.item() is False
    with pytest.raises(ValueError, match="unknown op"):
        mesh.reduce_partials(one, parts, op="max")
