"""The port's trainer (``mast3r_slam_tpu_torch/distill.py``) against the JAX
package's (``scripts/distill_oracle.py``) at its ``--quick`` size: 64x96,
encoder 2x64, decoder 2x48, desc 8, 10 frames, batch 2.

The JAX side is the script itself: ``build`` gives the configuration, the
oracle and the initial weights, and ``train`` is stopped right after it
defines its jitted ``step``, whose closure holds the script's ``loss_fn`` and
optax chain. The weights cross by ``from_jax_params``, which also maps a
gradient tree (every map is linear). Tolerances: RoPE's gradient is a few
fp32 products (1e-6); the loss and its parts from the same images and
targets agree to 1e-5 relative, each parameter's gradient to 1e-4 of the
tensor's largest entry once both runs take the same ReLU decisions, 2e-4
as it is (see ``test_loss_and_gradients_match_jax``); the optimizer alone,
fed JAX's gradients, stays within 1e-6
of optax over 5 updates; five whole steps on JAX's index batches, each
package with its own renders and oracle targets, agree to 1e-3 relative in
the loss (the two raycasts differ by a few ulps, which the texture
amplifies: see ``test_render_rgb_matches_jax``)."""

import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from mast3r_slam_tpu.models import convert as jconvert
from mast3r_slam_tpu.models import mast3r as jm
from mast3r_slam_tpu.models import oracle as jo
from mast3r_slam_tpu.models import rope as jrope
from mast3r_slam_tpu_torch import distill
from mast3r_slam_tpu_torch.models import convert as tconvert
from mast3r_slam_tpu_torch.models import mast3r as tm
from mast3r_slam_tpu_torch.models import oracle as to
from mast3r_slam_tpu_torch.models import rope as trope

# the suite runs several test processes side by side on a few cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N_STEPS = 5


def _script():
    spec = importlib.util.spec_from_file_location(
        "distill_oracle", REPO / "scripts" / "distill_oracle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quick_args(steps):
    """The script's arguments at ``--quick`` (its own caps applied)."""
    args = distill._parser().parse_args(["--quick", "--device", "cpu",
                                         "--steps", str(steps)])
    args.frames = min(args.frames, 10)
    return args


class _Stop(Exception):
    pass


def _jax_texture():
    """JAX ``render_rgb``'s texture draws (``oracle.py:150-153``)."""
    key = jax.random.PRNGKey(42)
    return tuple(np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                              (3, 3)) * s)
                 for i, s in ((1, 3.0), (2, 11.0), (3, 29.0)))


def _jax_pairs(args):
    """The index batches of the script's first steps (``:137-140``, keys
    from ``PRNGKey(7)`` as its loop splits them)."""
    key = jax.random.PRNGKey(7)
    out = []
    for _ in range(args.steps):
        key, k = jax.random.split(key)
        k1, k2 = jax.random.split(k)
        i = jax.random.randint(k1, (args.batch,), 0, args.frames)
        off = jax.random.randint(k2, (args.batch,), -4, 5)
        j = jnp.clip(i + off, 0, args.frames - 1)
        out.append((i, j))
    return out


@pytest.fixture(scope="module")
def ref():
    """The script's quick setup, its loss and optimizer, and N_STEPS of its
    updates on its own index batches: params, losses and gradients."""
    import mast3r_slam_tpu.models as jmodels

    script = _script()
    args = _quick_args(N_STEPS)
    # the script's build, its initial weights drawn by the port's
    # init_params (seed 0) and carried into JAX by JAX's convert_state_dict:
    # JAX's eager init compiles each of its random draws alone (~11 s)
    real_init = jmodels.init_params

    def port_init(key, cfg):
        model = tm.init_params(tm.MASt3RConfig(**cfg._asdict()),
                               device="cpu", trainable=True)
        return jconvert.convert_state_dict(
            {k: v.detach().numpy() for k, v in model.state_dict().items()},
            cfg)

    jmodels.init_params = port_init
    try:
        cfg, traj, oparams, params = script.build(args)
    finally:
        jmodels.init_params = real_init
    captured = {}
    real_jit = jax.jit

    def spy(f, *a, **kw):
        if getattr(f, "__name__", "") == "step":
            captured["step"] = f
            raise _Stop
        return real_jit(f, *a, **kw)

    jax.jit = spy
    try:
        script.train(args, cfg, traj, oparams, params)
    except _Stop:
        pass
    finally:
        jax.jit = real_jit
    step = captured["step"]
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    loss_fn, opt = cells["loss_fn"], cells["opt"]
    lcells = dict(zip(loss_fn.__code__.co_freevars,
                      (c.cell_contents for c in loss_fn.__closure__)))

    @jax.jit
    def jstep(p, s, i, j):
        (l, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, i, j)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, l, aux, g

    pairs = _jax_pairs(args)
    p, s = params, opt.init(params)
    trail = {"params": [jax.device_get(p)], "loss": [], "aux": [],
             "grads": []}
    for i, j in pairs:
        p, s, l, aux, g = jstep(p, s, i, j)
        trail["params"].append(jax.device_get(p))
        trail["loss"].append(float(l))
        trail["aux"].append(tuple(float(a) for a in aux))
        trail["grads"].append(jax.device_get(g))
    return dict(args=args, cfg=cfg, traj=traj, oparams=oparams,
                pairs=[(np.asarray(i), np.asarray(j)) for i, j in pairs],
                imgs_n=np.asarray(lcells["imgs_n"]),
                pair_targets=lcells["pair_targets"], **trail)


def _port_model(cfg, params):
    model = tm.init_params(tm.MASt3RConfig(**cfg._asdict()), device="cpu",
                           trainable=True)
    model.load_state_dict(tconvert.from_jax_params(params))
    return model


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_rope_qk_gradient_matches_jax_vjp(out_dtype):
    """``rope_qk`` on the CPU (its plain version) differentiated by autograd
    against ``jax.vjp`` of ``rope_2d`` on q and k; in bf16 the cotangent is
    rounded to bf16 first, as the attention's backward hands it over."""
    rng = np.random.default_rng(0)
    b, heads, nq, nk, d = 2, 3, 24, 18, 16
    q, k = (rng.standard_normal((b, heads, n, d)).astype(np.float32)
            for n in (nq, nk))
    pq, pk = (np.stack([np.arange(n) // 6, np.arange(n) % 6 + s], -1)[None]
              .repeat(b, 0) for n, s in ((nq, 0), (nk, 2)))
    gq, gk = (rng.standard_normal((b, heads, n, d)).astype(np.float32)
              for n in (nq, nk))
    gq_t, gk_t = (_t(g).to(out_dtype) for g in (gq, gk))
    _, vjp = jax.vjp(lambda a, c: (jrope.rope_2d(a, pq), jrope.rope_2d(c, pk)),
                     q, k)
    dq_j, dk_j = vjp((gq_t.float().numpy(), gk_t.float().numpy()))
    qt, kt = _t(q).requires_grad_(), _t(k).requires_grad_()
    tabs = [trope.rope_tables(_t(p), d, 100.0, torch.float32)
            for p in (pq, pk)]
    out = trope.rope_qk(qt, kt, tabs[0], tabs[1], out_dtype)
    dq, dk = torch.autograd.grad(out, (qt, kt), (gq_t, gk_t))
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), rtol=0,
                               atol=1e-6)
    # the backward's plain version is what autograd computes, bit for bit
    pq_, pk_ = trope.rope_qk_bwd_plain(gq_t, gk_t, tabs[0], tabs[1])
    assert torch.equal(pq_, dq) and torch.equal(pk_, dk)


def test_render_rgb_matches_jax(ref, monkeypatch):
    """With JAX's texture draws and the same world points, the port's
    colours are JAX's within 1e-5. Each package raycasts on its own, and
    XLA contracts multiply-adds the port does not (the raycasts differ by up
    to ~5e-5 on points ~10 units away, as much as JAX's jitted and eager
    raycasts differ from each other); the texture's frequencies (up to 29
    a unit) amplify that, so the whole renders agree within 5e-4."""
    cfg, oparams = ref["cfg"], ref["oparams"]
    tcfg = tm.MASt3RConfig(**cfg._asdict())
    top = tconvert.oracle_params_from_jax(jax.device_get(oparams),
                                          device="cpu")
    tex = _jax_texture()
    raycast = jax.jit(lambda p, T: jo._raycast_world(p, T, cfg))
    whole = []
    for i in range(ref["args"].frames):
        want = np.asarray(jo.render_rgb(oparams, i, cfg))
        got = to.render_rgb(top, i, tcfg, tex).numpy()
        assert got.shape == want.shape == (*cfg.img_size, 3)
        whole.append(np.abs(got - want).max())
        Xw = _t(raycast(oparams, oparams["traj"][i]))
        with monkeypatch.context() as m:
            m.setattr(to, "_raycast_world", lambda *a: Xw)
            same = to.render_rgb(top, i, tcfg, tex).numpy()
        np.testing.assert_allclose(same, want, rtol=0, atol=1e-5)
    assert max(whole) <= 5e-4, whole
    # the default texture: numpy draws, deterministic, inside [0, 1]
    a, b = (to.render_rgb(top, 3, tcfg).numpy() for _ in range(2))
    assert np.array_equal(a, b) and 0.0 <= a.min() and a.max() <= 1.0


def _port_grads(ref, monkeypatch, dtype=torch.float32, relu_masks=None):
    """The port's loss, its parts, every parameter's gradient and the inputs
    of DPT's ReLUs (in call order) for the first batch, from JAX's images and
    oracle targets. ``dtype=torch.float64`` computes everything in float64
    (the model's fp32 accumulations, ``.float()``, kept in float64);
    ``relu_masks`` replaces each ReLU's decision by the given one."""
    cfg = ref["cfg"]
    if dtype == torch.float64:
        cfg = cfg._replace(dtype="float64", head_dtype="float64")
    relu_in = []
    real_float, real_relu = torch.Tensor.float, F.relu

    def relu(x):
        relu_in.append(x.detach().double())
        if relu_masks is None:
            return real_relu(x)
        return x * relu_masks[len(relu_in) - 1]

    with monkeypatch.context() as m:
        m.setattr(F, "relu", relu)
        if dtype == torch.float64:
            m.setattr(torch.Tensor, "float", lambda t, *a, **kw: (
                t if t.dtype == torch.float64 else real_float(t, *a, **kw)))
        tcfg = tm.MASt3RConfig(**cfg._asdict())
        model = _port_model(ref["cfg"], ref["params"][0]).to(dtype)
        i, j = ref["pairs"][0]
        t1, t2 = ref["pair_targets"](jnp.asarray(i), jnp.asarray(j))
        targets = tuple({k: _t(v).to(dtype) for k, v in t.items()}
                        for t in (t1, t2))
        loss, (lx, ld) = distill.loss_fn(
            model, tcfg, _t(ref["imgs_n"]).to(dtype), targets, _t(i).long(),
            _t(j).long())
        loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return [float(x.detach()) for x in (loss, lx, ld)], grads, relu_in


def test_loss_and_gradients_match_jax(ref, monkeypatch):
    """One batch, the same images and oracle targets (JAX's), weights from
    ``from_jax_params``: the loss and its parts within 1e-5 relative, and
    every parameter's gradient, mapped through ``from_jax_params``, against
    JAX's and against the float64 gradient.

    A ReLU of DPT whose input lies within fp32 rounding of zero can decide
    one way in one fp32 run and the other way in float64 or in the other
    package; the gradient of that pixel then passes in one and not in the
    other. So the test takes the ReLU inputs of the port's fp32 and float64
    runs, requires every decision they disagree on to sit within 1e-5 of the
    tensor's largest entry from zero, and reruns the fp32 gradient with the
    float64 run's decisions. That gradient, and JAX's fp32 one, must lie
    within 1e-5 of the float64 gradient, and within 1e-4 of each other; the
    port's own gradient within 2e-4 of JAX's, the most one flipped pixel of
    head 2's last ReLU moves a tensor at this seed (1.03e-4 of
    ``act_postprocess.0.1``'s largest entry, with the decisions shared
    2.8e-6). A weight the loss does not reach (refinenet4's first unit,
    which DPT never calls) has no gradient in the port and a zero one in
    JAX."""
    got, grads, pre32 = _port_grads(ref, monkeypatch)
    np.testing.assert_allclose(got, [ref["loss"][0], *ref["aux"][0]],
                               rtol=1e-5)
    _, grads64, pre64 = _port_grads(ref, monkeypatch, torch.float64)
    assert len(pre32) == len(pre64) > 0
    for a, b in zip(pre32, pre64):
        flip = (a > 0) != (b > 0)
        assert bool((b[flip].abs() <= 1e-5 * b.abs().max()).all())
    _, shared, _ = _port_grads(ref, monkeypatch,
                               relu_masks=[(b > 0).float() for b in pre64])
    want = tconvert.from_jax_params(ref["grads"][0])
    assert set(grads) == set(want)
    for name, g in want.items():
        mine = grads[name]
        if mine is None:
            assert grads64[name] is None and float(g.abs().max()) == 0.0
            continue
        g64 = grads64[name]
        err = lambda x, y: float((x.double() - y.double()).abs().max())
        scale = float(g64.abs().max())
        assert err(g, g64) <= 1e-5 * scale, name
        assert err(shared[name], g64) <= 1e-5 * scale, name
        assert err(shared[name], g) <= 1e-4 * scale, name
        assert err(mine, g) <= 2e-4 * scale, name


def test_optimizer_matches_optax(ref):
    """JAX's gradients of the five steps fed to both optimizers: the
    script's optax chain (``clip_by_global_norm(1)``, ``adamw`` under
    ``cosine_decay_schedule``), as its steps applied them, and the port's
    ``optimizer_step``. The global norm crosses 1 within the five, so the
    clip is both idle and active."""
    args = ref["args"]
    norms = [np.sqrt(sum(float(np.sum(np.square(x)))
                         for x in jax.tree_util.tree_leaves(g)))
             for g in ref["grads"]]
    assert min(norms) < 1.0 < max(norms), norms
    model = _port_model(ref["cfg"], ref["params"][0])
    opt = distill.make_optimizer(model, args.lr)
    params = dict(model.named_parameters())
    for t, g in enumerate(ref["grads"]):
        for name, gt in tconvert.from_jax_params(g).items():
            params[name].grad = gt
        distill.optimizer_step(opt, t, args.lr, args.steps)
        want = tconvert.from_jax_params(ref["params"][t + 1])
        err = max(float((params[k].detach() - v).abs().max())
                  for k, v in want.items())
        assert err <= 1e-6, (t, err)
    sched = optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.02)
    np.testing.assert_allclose(
        [distill.cosine_lr(args.lr, args.steps, t) for t in range(7)],
        [float(sched(t)) for t in range(7)], rtol=1e-6)


def test_five_steps_match_jax(ref):
    """Five whole steps of ``distill.train`` on JAX's index batches, with
    the port's own renders (JAX's texture draws) and oracle targets."""
    args, cfg = ref["args"], ref["cfg"]
    tcfg = tm.MASt3RConfig(**cfg._asdict())
    top = tconvert.oracle_params_from_jax(jax.device_get(ref["oparams"]),
                                          device="cpu")
    model = _port_model(cfg, ref["params"][0])
    pairs = [(_t(i).long(), _t(j).long()) for i, j in ref["pairs"]]
    _, losses = distill.train(args, tcfg, _t(ref["traj"]), top, model,
                              texture=_jax_texture(), pairs=pairs)
    np.testing.assert_allclose(losses.numpy(), ref["loss"], rtol=1e-3)
    assert ref["loss"][-1] < ref["loss"][0]


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    """``python -m mast3r_slam_tpu_torch.distill --quick --skip-slam
    --device cpu``; returns its output directory."""
    tmp = tmp_path_factory.mktemp("distill")
    out = tmp / "rehearsal"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "mast3r_slam_tpu_torch.distill", "--quick",
         "--skip-slam", "--device", "cpu", "--out", str(out)],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "step    59 loss" in proc.stdout
    return out


def test_quick_checkpoint_decodes_in_jax(quick_run):
    """The checkpoint the quick run writes loads in JAX's
    ``load_released_checkpoint`` and decodes a pair within 1e-4 of the
    port's decode of the same file; the frames and ground truth are
    written."""
    assert len(list((quick_run / "frames").glob("*.png"))) == 10
    assert len((quick_run / "groundtruth.txt").read_text().splitlines()) == 10
    ckpt = quick_run / "distilled_released.pth"
    jcfg, params = jconvert.load_released_checkpoint(
        ckpt, img_size=(64, 96), dtype="float32")
    tcfg, model = tconvert.load_released_checkpoint(
        ckpt, img_size=(64, 96), device="cpu", dtype="float32")
    assert (jcfg.enc_depth, jcfg.dec_embed_dim, jcfg.desc_dim) == (2, 48, 8)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (2, 64, 96, 3), np.uint8)
    fj, pj = jm.encode(params, jnp.asarray(img), jcfg)
    f, p = _t(fj), _t(pj).long()
    rj = jm.decode_pair(params, fj[:1], pj[:1], fj[1:], pj[1:], jcfg)
    rt = tm.decode_pair(model, f[:1], p[:1], f[1:], p[1:], tcfg)
    for a, b in zip(rt, rj):
        for key in ("pts3d", "conf", "desc", "desc_conf"):
            np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)


def test_quick_cli_leg(quick_run, monkeypatch):
    """The rehearsal's CLI leg on the quick run's frames and checkpoint
    (``distill.run_slam``: ``python -m mast3r_slam_tpu_torch --checkpoint``
    in a child process, base.yaml, on the CPU): it exits 0 after 10 frames
    and writes one TUM line per keyframe, which ``evaluate`` reads. The
    60-step 64x96 network, run at the CLI's 336x512, tracks no further than
    JAX's does there (frame 1 skipped, the rest relocalizing), so this
    checks the path, not the accuracy."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    stdout, wall = distill.run_slam(quick_run / "frames",
                                    quick_run / "distilled_released.pth",
                                    quick_run, "cpu", timeout=300)
    assert "done: 10 frames" in stdout and wall > 0
    traj = quick_run / "logs" / distill.RUN_DIR / "frames.txt"
    lines = traj.read_text().splitlines()
    stats = ast.literal_eval(stdout.split("stats: ", 1)[1].splitlines()[0])
    assert len(lines) == stats["keyframes"] >= 1
    m = distill.evaluate(str(quick_run / "groundtruth.txt"), str(traj))
    assert m["n_pairs"] >= 1 and "ate_rmse" in m
