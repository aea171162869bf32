"""The port's shards across processes: the keyframe-sharded bundle
adjustment, data-parallel tracking and the sharded decode over a mesh that
spans two processes (``parallel/dist_ba.py``, ``parallel/dp_tracking.py``),
and the two collectives that move their bits (``mesh.exchange``,
``mesh.all_gather_shards``).

Two child processes meet over gloo on 127.0.0.1, each with two ``cpu``
shards (``make_mesh_2d(devices=["cpu", "cpu"])``, four shards in all), and
run every case once under a timeout; the tests read what they saved.

* The collectives move bits: -0.0, NaN payloads, bool and int32 tensors and
  empty splits arrive unchanged.
* The keyframe-sharded prep and solve on the revisit graph of
  ``tests/test_schur.py`` (24 keyframes in four blocks, 58 edges padded to
  60): every rank's ``EdgePre`` is bit-equal to the one-process prep's shard
  of the same global index (point strides 1 and 2), the ranks' poses are
  bit-identical and within 1e-4 of JAX's ``prep_edges_kf_sharded`` +
  ``gauss_newton_rays_dist_pre`` on the 8-device CPU mesh (the tolerance of
  ``tests/test_torch_dist_ba.py``).
* ``track_window_dp`` with one oracle sequence a rank (a mesh of one
  ``cpu`` a process): bit-equal to that sequence's lone window.
* ``inference_symmetric_dp`` of a batch of 3 padded to 4: on every rank
  bit-equal to the one-process call over four ``cpu`` shards.
* The ``ValueError``s: S != the local device count, K or E that do not
  split over the mesh.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.parallel import dist_ba as jdist
from mast3r_slam_tpu.parallel import mesh as jmesh
from mast3r_slam_tpu.slam import ba as jba
from mast3r_slam_tpu_torch.config import BAConfig
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.parallel import dist_ba, dp_tracking, mesh
from mast3r_slam_tpu_torch.slam import ba as tba

from test_torch_multiprocess import _free_port, _ranks
from test_torch_schur import _revisit

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = 1e-4
TIMEOUT = 240
ITERS = 8

# One child process: joins the process group from SLAM_* and runs every
# case on the inputs of argv[1], saving what it got to argv[2].
_WORKER = r"""
import sys
import torch

torch.set_num_threads(1)
from mast3r_slam_tpu_torch.config import BAConfig, MatchingConfig, TrackerConfig
from mast3r_slam_tpu_torch.lie import sim3
from mast3r_slam_tpu_torch.models import mast3r, oracle
from mast3r_slam_tpu_torch.parallel import dist_ba, dp_tracking
from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod
from mast3r_slam_tpu_torch.slam.frame import KeyframeStore
from mast3r_slam_tpu_torch.slam.system import _track_window_body

CPU = torch.device("cpu")
inp = torch.load(sys.argv[1])
assert mesh_mod.init_distributed() is True
import torch.distributed as dist

rank = dist.get_rank()
m2 = mesh_mod.make_mesh_2d(devices=[CPU, CPU])
assert m2.size == 4 and m2.first_shard == 2 * rank
out = {"rank": rank}


def moves(r, q):
    # what rank r sends to rank q: sizes known to both from (r, q)
    g = torch.Generator().manual_seed(10 * r + q)
    f = torch.randn(3 + r + 2 * q, 2, generator=g)
    f[0, 0] = -0.0
    f[1, 1] = torch.tensor(0x7FC01234, dtype=torch.int32).view(torch.float32)
    i = torch.randint(-2**31, 2**31 - 1, (r * q,), generator=g,
                      dtype=torch.int32)
    b = torch.rand(q + 1, generator=g) < 0.5
    return [f, i, b, torch.empty(0, 3)]


out["exchange"] = mesh_mod.exchange(
    m2, [moves(rank, q) for q in range(2)],
    [[(t.shape, t.dtype) for t in moves(q, rank)] for q in range(2)],
    (torch.float32, torch.int32, torch.bool))
out["exchange_want"] = [moves(q, rank) for q in range(2)]
out["gathered"] = mesh_mod.all_gather_shards(
    m2, [inp["shards"][2 * rank + l] for l in range(2)])

# the keyframe-sharded prep and solve
g = inp["kf"]
e = g["edges"]
Xs_b, Cs_b = dist_ba.shard_keyframe_store(m2, g["Xs"], g["Cs"])
out["kf_pre"] = {}
for stride in (1, 2):
    pres = dist_ba.prep_edges_kf_sharded(m2, Xs_b, Cs_b, *e[:4],
                                         stride=stride)
    out["kf_pre"][stride] = [tuple(p) for p in pres]
res = dist_ba.gauss_newton_rays_dist_pre(
    g["T"], dist_ba.prep_edges_kf_sharded(m2, Xs_b, Cs_b, *e[:4]), e[0],
    e[1], e[3], e[4], e[5], g["n_kf"], m2, BAConfig(max_iters=g["iters"]))
out["kf_T"], out["kf_iters"] = res.T_WC, res.iters

# one oracle sequence a rank: the dp window and the same window alone
t = inp["track"]
cfg = mast3r.MASt3RConfig(**t["cfg"])
h, w = cfg.img_size
params = oracle.make_params(t["traj"], desc_dim=cfg.desc_dim, device="cpu")
mcfg = MatchingConfig(dilation_max=1, max_iter=4, radius=2)
tcfg = TrackerConfig(match_frac_thresh=0.95)
static = dict(ds=1, fuse_mode="weighted_pointmap", score_fn="median",
              use_calib=False)


def seq(first):
    img_k = torch.from_numpy(oracle.make_frame_image(first, h, w))[None]
    feat, pos = oracle.encode(params, img_k, cfg)
    Xk, Ck = oracle.inference_mono(params, feat, pos, cfg)
    kfs = KeyframeStore(8, h * w, cfg.num_patches, cfg.enc_embed_dim, (h, w),
                        feat_dtype=torch.float32, device="cpu")
    kfs.X[0], kfs.C[0] = Xk[0], Ck[0, :, 0]
    kfs.N[0] = kfs.N_updates[0] = 1
    kfs.feat[0], kfs.pos[0] = feat[0], pos[0]
    kfs.dataset_idx[0] = first
    kfs.n_size = 1
    ids = list(range(first + 1, first + 1 + t["window"]))
    imgs = torch.stack([torch.from_numpy(oracle.make_frame_image(i, h, w))
                        for i in ids])
    return dp_tracking.SeqInputs(imgs, ids, torch.arange(h * w),
                                 sim3.identity(device="cpu"), torch.eye(3),
                                 0, kfs)


def store(kfs):
    return [kfs.X, kfs.C, kfs.N, kfs.N_updates, kfs.score, kfs.T_WC,
            kfs.feat, kfs.pos, kfs.dataset_idx]


first = t["first"][rank]
s1 = seq(first)
lone = _track_window_body(oracle, params, cfg, mcfg, tcfg, s1.imgs,
                          s1.frame_ids, s1.idx_init, s1.prev_T_WC, s1.K, 0,
                          s1.kfs, 1, static["fuse_mode"], static["score_fn"],
                          False, (h, w))
m1 = mesh_mod.make_mesh([CPU])
assert m1.size == 2 and m1.first_shard == rank
s2 = seq(first)
(dp,) = dp_tracking.track_window_dp(dp_tracking.replicate_params(params, m1),
                                    cfg, mcfg, tcfg, [s2], m1,
                                    model_mod=oracle, **static)
out["track"] = (tuple(dp), store(s2.kfs), tuple(lone), store(s1.kfs))

# the sharded decode: every rank passes the whole batch
d = inp["decode"]
dcfg = mast3r.MASt3RConfig(**d["cfg"])
net = mast3r.init_params(dcfg, torch.Generator().manual_seed(0), device="cpu")
out["decode"] = dp_tracking.inference_symmetric_dp(
    dp_tracking.replicate_params(net, m2), m2, *d["batch"], dcfg)

# the refusals, before any collective
errors = {}
for name, fn in (
        ("S", lambda: dp_tracking.track_window_dp(
            [params], cfg, mcfg, tcfg, [seq(first), seq(first)], m1,
            model_mod=oracle, **static)),
        ("K", lambda: dist_ba.shard_keyframe_store(m2, g["Xs"][:22],
                                                   g["Cs"][:22])),
        ("E", lambda: dist_ba.prep_edges_kf_sharded(
            m2, Xs_b, Cs_b, *(a[:58] for a in e[:4])))):
    try:
        fn()
        errors[name] = None
    except ValueError as err:
        errors[name] = str(err)
out["errors"] = errors
torch.save(out, sys.argv[2])
dist.destroy_process_group()
print("OK")
"""


def _children(tmp_path, src):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = []
    for r, env in enumerate(_ranks(_free_port())):
        env = dict(os.environ, PYTHONPATH=f"{REPO}:"
                   f"{os.environ.get('PYTHONPATH', '')}", **env)
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(src),
             str(tmp_path / f"rank{r}.pt")], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [i for i, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0 or "OK" not in out]
    assert not failed, "\n".join(f"child {i} (rc {procs[i].returncode}):\n"
                                  f"{outs[i][-3000:]}" for i in failed)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]


def _graph():
    """The revisit graph in the port's tensors, K = 24 (four blocks of 6),
    58 edges padded to 60 with masked edges."""
    _, T, Xs, Cs, *edges = _revisit()
    t = [torch.from_numpy(np.array(a)) for a in (T, Xs, Cs, *edges)]
    fills = (0, 0, 0, False, 0, 0)
    padded = [mesh.pad_to_multiple(a, 4, 0, f) for a, f in zip(t[3:], fills)]
    return t[0], t[1], t[2], padded, 24


def _shards():
    """all_gather_shards' input: four global shards of (float (2, 3) with
    -0.0 and a NaN payload, int32 (2,), bool (2, 1), empty float (0, 3),
    int64 (0, 2): a dtype empty on every shard)."""
    out = []
    for s in range(4):
        g = torch.Generator().manual_seed(s)
        f = torch.randn(2, 3, generator=g)
        f[0, 0] = -0.0
        f[1, 2] = torch.tensor(0x7F800001 + s, dtype=torch.int32).view(
            torch.float32)
        out.append((f, torch.randint(-2**31, 2**31 - 1, (2,), generator=g,
                                     dtype=torch.int32),
                    torch.rand(2, 1, generator=g) < 0.5, torch.empty(0, 3),
                    torch.empty(0, 2, dtype=torch.int64)))
    return out


def _decode_inputs():
    """The TINY network's features of 6 random images, edges (0,1), (2,3),
    (4,5): a batch of 3 that pads to 4."""
    cfg = tmast3r.TINY
    net = tmast3r.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    h, w = cfg.img_size
    g = torch.Generator().manual_seed(1)
    feat, pos = tmast3r.encode(net, torch.randn(6, h, w, 3, generator=g),
                               cfg)
    return net, cfg, [feat[0::2], pos[0::2], feat[1::2], pos[1::2]]


def _traj(n):
    from test_torch_dp_tracking import _traj as jtraj

    return torch.from_numpy(np.array(jtraj(n)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shards")
    T, Xs, Cs, edges, n_kf = _graph()
    net, dcfg, batch = _decode_inputs()
    src = tmp / "inputs.pt"
    torch.save({
        "shards": _shards(),
        "kf": {"T": T, "Xs": Xs, "Cs": Cs, "edges": edges, "n_kf": n_kf,
               "iters": ITERS},
        "track": {"cfg": dict(img_size=(32, 48), enc_embed_dim=32,
                              desc_dim=8, dtype="float32"),
                  "traj": _traj(12), "first": (0, 5), "window": 3},
        "decode": {"cfg": tmast3r.TINY._asdict(), "batch": batch}}, src)
    ranks = _children(tmp, src)
    return {"ranks": ranks, "graph": (T, Xs, Cs, edges, n_kf),
            "decode": (net, dcfg, batch)}


def _bits(t):
    """A tensor's bits, comparable with ``torch.equal`` (NaN payloads and
    the sign of zero included)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _same_bits(a, b):
    if a is None or b is None:
        return a is b
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a), _bits(b)))


def test_exchange_moves_bits_across_processes(runs):
    """Each rank gets from each rank (itself too) exactly what was sent:
    -0.0, a NaN payload, int32 and bool tensors, empty int32 splits and an
    empty float tensor."""
    for r in runs["ranks"]:
        for got, want in zip(r["exchange"], r["exchange_want"]):
            assert len(got) == len(want) == 4
            assert all(_same_bits(a, b) for a, b in zip(got, want))
        assert r["exchange_want"][0][1].numel() == 0      # empty split
        assert torch.signbit(r["exchange"][0][0][0, 0])   # -0.0 kept


def test_all_gather_shards_moves_bits_across_processes(runs):
    """Every rank holds all four shards' tensors in global shard order,
    NaN payloads, -0.0, bool, an empty leading dimension and a dtype empty
    on every shard included."""
    shards = _shards()
    want = [torch.cat([sh[k] for sh in shards]) for k in range(5)]
    for r in runs["ranks"]:
        assert len(r["gathered"]) == 5
        assert all(_same_bits(a, b) for a, b in zip(r["gathered"], want))


def test_collectives_in_one_process_copy_in_shard_order():
    """On a mesh of one process the two moves are local copies: ``exchange``
    returns fresh copies of what this rank sends itself, and
    ``all_gather_shards`` concatenates the shards in order."""
    m = mesh.make_mesh([CPU] * 4)
    shards = _shards()
    got = mesh.all_gather_shards(m, shards)
    assert all(_same_bits(a, torch.cat([sh[k] for sh in shards]))
               for k, a in enumerate(got))
    mine = list(shards[0])
    (back,) = mesh.exchange(m, [mine], [[(t.shape, t.dtype) for t in mine]],
                            (torch.float32, torch.int32, torch.bool))
    assert all(_same_bits(a, b) for a, b in zip(back, mine))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(back, mine)
               if b.numel())


def test_kf_sharded_prep_and_solve_across_processes(runs):
    """Every rank's ``EdgePre`` equals the one-process prep's shard of the
    same global index bit for bit (strides 1 and 2); the ranks' poses are
    bit-identical, within 1e-4 of JAX's keyframe-sharded solve on the
    8-device mesh and moved from the start."""
    T, Xs, Cs, edges, n_kf = runs["graph"]
    m4 = mesh.make_mesh([CPU] * 4)
    Xs_b, Cs_b = dist_ba.shard_keyframe_store(m4, Xs, Cs)
    for stride in (1, 2):
        one = dist_ba.prep_edges_kf_sharded(m4, Xs_b, Cs_b, *edges[:4],
                                            stride=stride)
        assert one[0].XCi.shape[1] == 64 // stride
        for r in runs["ranks"]:
            for l, pre in enumerate(r["kf_pre"][stride]):
                for a, b in zip(pre, one[2 * r["rank"] + l]):
                    assert _same_bits(a, b)
    r0, r1 = runs["ranks"]
    assert _same_bits(r0["kf_T"], r1["kf_T"])
    assert r0["kf_iters"] == r1["kf_iters"]

    j = [jnp.asarray(a.numpy()) for a in edges]
    jp = [jmesh.pad_to_multiple(a, 8, 0, f)
          for a, f in zip(j, (0, 0, 0, False, 0, 0))]
    m8 = jmesh.make_mesh(8)
    Xs_sh, Cs_sh = jdist.shard_keyframe_store(m8, jnp.asarray(Xs.numpy()),
                                              jnp.asarray(Cs.numpy()))
    pre = jdist.prep_edges_kf_sharded(m8, Xs_sh, Cs_sh, *jp[:4])
    j_T = jdist.gauss_newton_rays_dist_pre(
        jnp.asarray(T.numpy()), pre, jp[0], jp[1], jp[3], jp[4], jp[5],
        jnp.asarray(n_kf), m8, jba.BAConfig(max_iters=ITERS, point_chunk=64))
    np.testing.assert_allclose(r0["kf_T"].numpy(), np.asarray(j_T), atol=TOL)
    dense = tba.gauss_newton_rays(T, Xs, Cs, *edges, n_kf,
                                  BAConfig(max_iters=ITERS))
    np.testing.assert_allclose(r0["kf_T"].numpy(), dense.T_WC.numpy(),
                               atol=TOL)
    assert (r0["kf_T"] - T).abs().max() > 1e-3


def test_track_window_dp_one_sequence_a_process(runs):
    """Each rank's window (its global sequence, one device a rank) equals
    the same window run alone, every output and store buffer bit for bit;
    the two ranks tracked different streams."""
    for r in runs["ranks"]:
        dp, dp_store, lone, lone_store = r["track"]
        assert len(dp) == len(lone)
        assert all(_same_bits(a, b) for a, b in zip(dp, lone))
        assert all(_same_bits(a, b) for a, b in zip(dp_store, lone_store))
        assert bool((dp[0][:, 7] == 1).all())            # all tracked
    ids = [r["track"][1][8][0].item() for r in runs["ranks"]]
    assert ids == [0, 5]


def test_inference_symmetric_dp_across_processes(runs):
    """The batch of 3, padded to 4 and decoded a chunk a shard over the
    two ranks: every rank's outputs equal the one-process call over four
    ``cpu`` shards bit for bit, padding cut off."""
    net, cfg, batch = runs["decode"]
    m4 = mesh.make_mesh([CPU] * 4)
    one = dp_tracking.inference_symmetric_dp(
        dp_tracking.replicate_params(net, m4), m4, *batch, cfg)
    for r in runs["ranks"]:
        assert set(r["decode"]) == set(one)
        for k, v in one.items():
            assert v.shape[0] == 3
            assert _same_bits(r["decode"][k], v), k


def test_refusals_across_processes(runs):
    """S != the local device count, K = 22 and E = 58 over the 4-shard
    mesh: each a ``ValueError`` before any collective."""
    for r in runs["ranks"]:
        err = r["errors"]
        assert "one sequence per device: got S = 2 sequences for the 1 " \
               "local devices of a 2-device mesh" in err["S"]
        assert "22 keyframes do not split over 4 devices" in err["K"]
        assert "58 edges do not split over 4 devices" in err["E"]
