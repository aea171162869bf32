"""Distil the oracle into a small real MASt3R and run it through the CLI:
the real-geometry rehearsal (counterpart of ``scripts/distill_oracle.py``).

    python -m mast3r_slam_tpu_torch.distill --steps 1200 --out .rehearsal
    python -m mast3r_slam_tpu_torch.distill --quick --skip-slam --device cpu

1. Render a photo-consistent sequence of the oracle scene
   (``models.oracle.render_rgb``).
2. Distil the oracle's two-view outputs (pointmaps, descriptors,
   confidences) into a small MASt3R (ViT encoder, dual decoder, DPT and
   Cat-MLP heads) with the JAX script's loss and optimizer: Huber on the
   pointmaps, descriptor MSE and confidence pulls (``loss_fn``), the
   gradient clipped to a global norm of 1 and AdamW under a cosine
   schedule (``optimizer_step``, optax's rules written out).
3. Save the weights as a released-format ``.pth``
   (``convert.save_released_checkpoint``) and the frames as a directory of
   PNGs with a TUM ground truth.
4. Run the port's CLI (``python -m mast3r_slam_tpu_torch --checkpoint``) on
   them in a child process, and report ATE and RPE against the ground truth
   (``REHEARSAL.json``).

Runs on the GPU unless ``--device cpu`` is given; without a GPU it raises.
Outputs go under ``--out``: ``distilled_released.pth``, ``frames/``,
``groundtruth.txt``, ``logs/rehearsal/frames.txt`` (the CLI's, run in that
directory) and ``REHEARSAL.json``.
"""

from __future__ import annotations

import argparse
import ast
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
SLAM_TIMEOUT_S = 3600     # the CLI child's limit; a timeout fails the run
RUN_DIR = "rehearsal"     # the CLI's --save-as


def model_config(args):
    """The student network: 4x128 encoder, 4x96 dual decoder, desc 16 at
    ``--height`` x ``--width``; with ``--quick`` 2x64 / 2x48, desc 8 at
    64x96. fp32 transformer and head."""
    from .models.mast3r import MASt3RConfig

    h, w = (64, 96) if args.quick else (args.height, args.width)
    return MASt3RConfig(
        img_size=(h, w), enc_depth=2 if args.quick else 4,
        enc_embed_dim=64 if args.quick else 128,
        enc_num_heads=4, dec_depth=2 if args.quick else 4,
        dec_embed_dim=48 if args.quick else 96, dec_num_heads=4,
        desc_dim=8 if args.quick else 16,
        feature_dim=32, last_dim=16, layer_dims=(16, 16, 16, 48),
        dtype="float32", head_dtype="float32")


def build(args, device="cuda"):
    """(cfg, traj, oracle params, trainable model on ``device``); the
    weights come from a generator on the device seeded with ``--seed``."""
    from ._device import resolve_device
    from .models import mast3r, oracle

    dev = resolve_device(device)
    cfg = model_config(args)
    traj = oracle.make_traj(args.frames, args.step_scale)
    oparams = oracle.make_params(traj, desc_dim=cfg.desc_dim,
                                 desc_freq=args.desc_freq, device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    model = mast3r.init_params(cfg, g, device=dev, trainable=True)
    return cfg, traj, oparams, model


def pair_targets(oparams, ofeat, opos, i, j, cfg):
    """The oracle's two-view outputs for pairs (i, j): ground-truth
    geometry in view i's frame and the shared descriptor field."""
    from .models import oracle

    return oracle.decode_pair(oparams, ofeat[i], opos[i], ofeat[j], opos[j],
                              cfg)


def _huber(x, d=0.1):
    a = torch.abs(x)
    return torch.mean(torch.where(a < d, 0.5 * a * a / d, a - 0.5 * d))


def loss_fn(model, cfg, imgs_n, targets, i, j):
    """The distillation loss of pairs (i, j) (``distill_oracle.py:114``):
    returns (loss, (pointmap term, descriptor term))."""
    from .models import mast3r

    f, pos = mast3r.encode_body(model, imgs_n[torch.cat([i, j])], cfg)
    b = i.shape[0]
    r1, r2 = mast3r.decode_pair_body(model, f[:b], pos[:b], f[b:], pos[b:],
                                     cfg)
    t1, t2 = targets
    lx = _huber(r1["pts3d"] - t1["pts3d"]) + _huber(r2["pts3d"] - t2["pts3d"])
    ld = (torch.mean((r1["desc"] - t1["desc"]) ** 2)
          + torch.mean((r2["desc"] - t2["desc"]) ** 2))
    # confidences: push above the SLAM gates (C_conf=0, Q_conf=1.5)
    lc = (torch.mean((r1["conf"] - 2.5) ** 2)
          + torch.mean((r2["conf"] - 2.5) ** 2)
          + torch.mean((r1["desc_conf"] - 3.0) ** 2)
          + torch.mean((r2["desc_conf"] - 3.0) ** 2))
    return lx + 4.0 * ld + 0.05 * lc, (lx, ld)


def make_optimizer(model, lr):
    """AdamW over every parameter, optax's ``adamw`` settings."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def cosine_lr(lr, steps, t, alpha=0.02):
    """optax's ``cosine_decay_schedule(lr, steps, alpha)`` at update t."""
    c = min(t, steps)
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps))
                 + alpha)


def clip_by_global_norm(grads, max_norm=1.0):
    """optax's rule, in place: each g unchanged if the global norm is below
    ``max_norm``, else g / norm * max_norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). No host sync."""
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def optimizer_step(opt, t, lr, steps):
    """Update t (0, 1, ...): the clip, then AdamW at ``cosine_lr``. A
    parameter the loss does not reach gets a zero gradient, as optax gives
    every leaf (weight decay still applies to it)."""
    params = [p for grp in opt.param_groups for p in grp["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm([p.grad for p in params])
    for grp in opt.param_groups:
        grp["lr"] = cosine_lr(lr, steps, t)
    opt.step()


def sample_pairs(gen, n, batch):
    """``batch`` pairs (i, j): i uniform over the n frames, j within 4
    frames of it (``distill_oracle.py:137-140``)."""
    i = torch.randint(0, n, (batch,), generator=gen, device=gen.device)
    off = torch.randint(-4, 5, (batch,), generator=gen, device=gen.device)
    return i, torch.clamp(i + off, 0, n - 1)


def train_step(model, opt, t, args, cfg, data, i, j):
    """One update on pairs (i, j); ``data`` = (normalized frames, oracle
    params, oracle features, positions). Returns the detached (loss, lx,
    ld)."""
    imgs_n, oparams, ofeat, opos = data
    targets = pair_targets(oparams, ofeat, opos, i, j, cfg)
    loss, (lx, ld) = loss_fn(model, cfg, imgs_n, targets, i, j)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    optimizer_step(opt, t, args.lr, args.steps)
    return loss.detach(), lx.detach(), ld.detach()


def train_data(args, cfg, oparams, texture=None):
    """The frames rendered and normalized once, and the oracle's features
    of every frame, on the oracle's device."""
    from .models import oracle

    n = args.frames
    imgs = torch.stack([oracle.render_rgb(oparams, i, cfg, texture)
                        for i in range(n)])
    imgs_n = (imgs - 0.5) / 0.5
    dev = oparams["traj"].device
    ofeat, opos = oracle.encode_fid(oparams, torch.arange(n, device=dev), cfg)
    return imgs_n, oparams, ofeat, opos


def train(args, cfg, traj, oparams, model, texture=None, pairs=None):
    """``args.steps`` updates of ``model``; pairs from a generator on the
    model's device seeded with ``--seed``, or from ``pairs`` (a list of (i,
    j) index tensors, one a step). Returns (model, the losses (steps,) on
    the CPU); the loss is read back only when it is printed."""
    data = train_data(args, cfg, oparams, texture)
    dev = data[0].device
    opt = make_optimizer(model, args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    losses = []
    t0 = time.time()
    for it in range(args.steps):
        i, j = (sample_pairs(gen, args.frames, args.batch) if pairs is None
                else (p.to(dev) for p in pairs[it]))
        loss, lx, ld = train_step(model, opt, it, args, cfg, data, i, j)
        losses.append(loss)
        if it % max(args.steps // 10, 1) == 0 or it == args.steps - 1:
            print(f"step {it:5d} loss {float(loss):.4f} "
                  f"(pts {float(lx):.4f} desc {float(ld):.4f}) "
                  f"[{time.time() - t0:.0f}s]", flush=True)
    return model, torch.stack(losses).cpu()


def write_dataset(args, cfg, traj, oparams, out: pathlib.Path):
    """The renders as ``out/frames/%04d.png`` and the trajectory as
    ``out/groundtruth.txt`` (TUM: the RGBFiles adapter stamps frame i at
    i/30 s); returns the frames' directory."""
    import PIL.Image

    from .lie import sim3
    from .models import oracle

    rgb = out / "frames"
    rgb.mkdir(parents=True, exist_ok=True)
    for i in range(args.frames):
        img = oracle.render_rgb(oparams, i, cfg).cpu().numpy()
        PIL.Image.fromarray((img * 255).astype(np.uint8)).save(
            rgb / f"{i:04d}.png")
    T = sim3.to_se3(traj).numpy()
    with open(out / "groundtruth.txt", "w") as f:
        for i in range(args.frames):
            t, q = T[i, :3], T[i, 3:7]
            f.write(f"{i / 30.0} {t[0]} {t[1]} {t[2]} "
                    f"{q[0]} {q[1]} {q[2]} {q[3]}\n")
    return rgb


def evaluate(gt_file, traj_file, rpe_delta=1):
    """ATE RMSE and RPE of a TUM trajectory, as the JAX package's results
    table evaluates it (``scripts/results_table.py:111-122``)."""
    from .eval import ate

    res = ate.ate_rmse(gt_file, traj_file, max_diff=0.1)
    row = {"ate_rmse": res["rmse"], "n_pairs": res["n_pairs"]}
    try:
        r = ate.rpe(gt_file, traj_file, delta=rpe_delta, max_diff=0.1)
        row["rpe_trans"] = r["trans_rmse"]
        row["rpe_rot_deg"] = r["rot_rmse_deg"]
    except Exception:
        pass
    return row


def run_slam(ds_dir, ckpt, out, device, timeout):
    """The port's CLI on the rendered frames with the distilled checkpoint,
    in a child process working in ``out``; raises SystemExit if it fails or
    outlives ``timeout`` seconds. Returns (stdout, wall seconds)."""
    cmd = [sys.executable, "-m", "mast3r_slam_tpu_torch",
           "--dataset", str(ds_dir.resolve()),
           "--config", str(REPO / "configs" / "base.yaml"), "--no-viz",
           "--checkpoint", str(ckpt.resolve()), "--save-as", RUN_DIR,
           "--device", str(device)]
    print("running:", " ".join(cmd), flush=True)
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(REPO) + (
        os.pathsep + path if path else ""))
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=out, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit(f"SLAM run timed out after {timeout} s")
    dt = time.time() - t0
    print(stdout[-2500:])
    if proc.returncode != 0:
        print(stderr[-2500:])
        raise SystemExit(f"SLAM run failed (exit {proc.returncode})")
    return stdout, dt


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m mast3r_slam_tpu_torch.distill")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--desc-freq", type=float, default=8.0)
    ap.add_argument("--step-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=".rehearsal")
    ap.add_argument("--quick", action="store_true",
                    help="tiny smoke configuration (CI-sized)")
    ap.add_argument("--skip-slam", action="store_true",
                    help="train + export only (no CLI run)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions "
                         "of the kernels)")
    return ap


def main(argv=None, slam_timeout=SLAM_TIMEOUT_S):
    """The rehearsal; returns its record (also written to
    ``REHEARSAL.json`` when the CLI runs). ``slam_timeout``: seconds the
    CLI child may take."""
    args = _parser().parse_args(argv)
    if args.quick:
        args.steps = min(args.steps, 60)
        args.frames = min(args.frames, 10)

    from .models import convert

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cfg, traj, oparams, model = build(args, args.device)
    print(f"training {cfg.img_size} model on {args.frames} rendered frames "
          f"({args.steps} steps) on {args.device}...", flush=True)
    t0 = time.time()
    model, losses = train(args, cfg, traj, oparams, model)
    train_s = time.time() - t0
    k = min(10, args.steps)
    m = {"steps": args.steps, "frames": args.frames, "train_s": train_s,
         "ms_per_step": 1e3 * train_s / max(args.steps, 1),
         "loss_first10": float(losses[:k].mean()),
         "loss_last10": float(losses[-k:].mean())}

    ckpt = out / "distilled_released.pth"
    convert.save_released_checkpoint(model, cfg, ckpt)
    print(f"saved released-format checkpoint: {ckpt}")
    ds_dir = write_dataset(args, cfg, traj, oparams, out)
    print(f"wrote rendered dataset: {ds_dir}")

    if args.skip_slam:
        return m

    stdout, dt = run_slam(ds_dir, ckpt, out, args.device, slam_timeout)
    traj_file = out / "logs" / RUN_DIR / f"{ds_dir.name}.txt"
    gt = out / "groundtruth.txt"
    m.update(evaluate(str(gt), str(traj_file)))
    xyz = np.loadtxt(gt)[:, 1:4]
    m["extent"] = float(np.linalg.norm(xyz.max(0) - xyz.min(0)))
    m["ate_rel"] = m["ate_rmse"] / m["extent"]
    m["fps"] = args.frames / dt
    m["wall_s"] = dt
    m["poses"] = len(traj_file.read_text().splitlines())
    stats = re.search(r"^stats: (\{.*\})$", stdout, re.M)
    if stats:
        m["stats"] = ast.literal_eval(stats.group(1))
    launches = re.search(r"^kernel launches: (\{.*\})$", stdout, re.M)
    if launches:
        m["launches"] = json.loads(launches.group(1))
    print(json.dumps({"rehearsal": m}))
    (out / "REHEARSAL.json").write_text(json.dumps(m, indent=1))
    return m


if __name__ == "__main__":
    main()
