#!/usr/bin/env python
"""GPU smoke run of the PyTorch/CUDA port (``mast3r_slam_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: the GPU's name and power limit, and the build of the CUDA
   kernels of ``mast3r_slam_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel, into ``build/torch_kernels/``).
2. Kernels: each kernel against its plain PyTorch version, on the GPU, at
   the main path's shapes under both matcher presets (integer outputs and
   converged flags exactly equal, floats within the stated tolerance), with
   CUDA-event timings (median of several runs) of the kernel, the plain
   version and, for Scharr, a one-call PyTorch yardstick.
3. Main path at full width: ViT-L MASt3R (384x512, bf16 transformer, bf16
   head, random weights from a seeded generator) driven through
   ``models.oracle_timing`` (the real network runs on every call; the SLAM
   stack sees ground-truth oracle geometry) by ``SLAMSystem.make_frame`` /
   ``process_frame``: 17 frames with the ``tpu_fast`` matcher and tracker
   settings at ``kf_every=4``, then 5 frames with ``base``. The run must be
   healthy (keyframe count, no skipped or relocalizing frame, TRACKING at
   the end, Sim(3)-aligned keyframe RMSE under 0.06 of the trajectory's
   extent) and every kernel's launch count must be > 0.

Output: per-frame and per-stage times, peak memory, then a line
``{"kernels": [...]}``, the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
MEM_BW = 3.35e12        # HBM3 bytes/s
PEAK_OPS = {"fp32": 67e12,      # FLOP/s outside the tensor cores
            "bf16": 989e12,     # tensor cores
            "int8": 1979e12}    # tensor cores, OP/s
KF_EVERY = 4
N_FAST, N_BASE = 17, 5


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of one ``fn()`` call in ms, each call timed
    alone: on a short kernel this is the host's launch cost."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=20, trials=3):
    """Device time of one ``fn()`` call in ms with the launch queue kept
    full: a device-side sleep holds the stream while the host enqueues
    ``reps`` calls, so the events see the calls back to back, not the host's
    launch cost. Median over ``trials``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        # >= 2x the enqueue time at <= 2 GHz
        torch.cuda._sleep(int(4e9 * host_s) + 100_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def make_traj(n, step_scale=1.0):
    """Smooth orbit keeping the oracle scene in view (bench.py::_make_traj
    at phase 0)."""
    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.lie import sim3

    Ts = [sim3.identity()]
    for i in range(1, n):
        xi = torch.tensor([0.03, 0.01 * np.sin(i / 5.0), 0.008, 0.0, 0.012,
                           0.002, 0.0], dtype=torch.float32) * step_scale
        Ts.append(sim3.mul(Ts[-1], sim3.exp(xi)))
    return torch.stack(Ts)


# -- phase 2: kernels ----------------------------------------------------------


def check_kernels(model_cfg, orc):
    """Each kernel vs its plain version at the main path's shapes; returns
    the kernel records (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_tpu_torch.models import oracle
    from mast3r_slam_tpu_torch.ops import gradient, matching

    h, w = model_cfg.img_size
    n = h * w
    f1, p1 = oracle.encode_fid(orc, torch.tensor([1], device="cuda"),
                               model_cfg)
    f0, p0 = oracle.encode_fid(orc, torch.tensor([0], device="cuda"),
                               model_cfg)
    X, C, D, Q = oracle.inference_asymmetric(orc, f1, p1, f0, p0, model_cfg)
    X11 = X[0:1].contiguous()
    X21 = X[1:2].contiguous()
    records = []

    def rec(name, variant, err, kernel, plain, lib, bound_bytes, bound_ops,
            ops_type, replaces, source, plain_reps=20):
        """Times ``kernel``, ``plain`` and ``lib`` (or None) with device_ms;
        call_ms is one kernel call alone, host launch cost included.
        bound_bytes: each input read once, each output written once;
        bound_ops: the operations on inputs of type ops_type."""
        t_bytes = bound_bytes / MEM_BW * 1e3
        t_ops = bound_ops / PEAK_OPS[ops_type] * 1e3
        ms = device_ms(kernel)
        r = {"name": name, "variant": variant, "route": "cuda",
             "source": source, "replaces": replaces, "launches": 0,
             "max_abs_err": err, "ms": ms, "kernel_ms": ms,
             "call_ms": time_ms(kernel),
             "plain_ms": device_ms(plain, reps=plain_reps),
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None if lib is None else device_ms(lib)}
        records.append(r)
        log("kernel", json.dumps(r))

    # 1. Scharr, fused with the ray normalization (the matcher's input)
    got = gradient.prep_rays_grad(X11)
    ref = gradient.prep_rays_grad_plain(X11)
    err = float((got - ref).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"scharr_rays vs plain: {err} > 1e-6")
    # plain-stencil mode: batch 2, c = 9, no normalization
    img9 = torch.cat([ref, ref.flip(1)], 0).contiguous()
    gx, gy = gradient.img_gradient(img9)
    gx0, gy0 = gradient.img_gradient_plain(img9)
    err2 = float(max((gx - gx0).abs().max(), (gy - gy0).abs().max()))
    if not err2 <= 1e-6:
        raise AssertionError(f"scharr_rays (c=9, b=2) vs plain: {err2}")
    kx = torch.tensor([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]],
                      device="cuda") / 32
    wts = torch.stack([kx, kx.T]).repeat(3, 1, 1)[:, None]     # (6,1,3,3)

    def library():
        x = F.normalize(X11, dim=-1).permute(0, 3, 1, 2)
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), wts,
                        groups=3)

    rec("scharr_rays", "prep_rays_grad (1,384,512,3)->(1,384,512,9)",
        max(err, err2), lambda: gradient.prep_rays_grad(X11),
        lambda: gradient.prep_rays_grad_plain(X11), library,
        # per pixel: one normalization (~9 FLOP), 2 x 3 stencils (~11 each)
        n * 3 * 4 + n * 9 * 4, n * (9 + 6 * 11), "fp32",
        "mast3r_slam_tpu/ops/pallas_gradient.py:31 (_scharr_kernel, "
        "pallas_call :68)", "mast3r_slam_tpu_torch/csrc/scharr_rays.cu")
    rays = got

    # 2. iter_proj: tpu_fast coarse subgrid (3 iters), base full grid (10)
    pts = gradient.l2_normalize(X21.reshape(1, n, 3)).contiguous()
    ident = torch.arange(n, device="cuda")[None]
    p_full = matching.lin_to_pixel(ident, w).float().contiguous()
    pc = p_full.reshape(1, h, w, 2)[:, ::2, ::2].reshape(1, -1, 2).contiguous()
    tc = pts.reshape(1, h, w, 3)[:, ::2, ::2].reshape(1, -1, 3).contiguous()
    p_iters = {}
    for variant, (pp, tt, iters) in {
            "tpu_fast coarse (1,49152) x3": (pc, tc, 3),
            "base full (1,196608) x10": (p_full, pts, 10)}.items():
        a, ca = matching.iter_proj(rays, tt, pp, iters)
        b, cb = matching.iter_proj_plain(rays, tt, pp, iters)
        err = float((a - b).abs().max())
        flips = int((ca != cb).sum())
        if not (err <= 1e-5 and flips == 0):
            raise AssertionError(f"iter_proj {variant}: pos err {err}, "
                                 f"{flips} converged flags differ")
        m = tt.shape[1]
        rec("iter_proj", variant, err,
            lambda: matching.iter_proj(rays, tt, pp, iters),
            lambda: matching.iter_proj_plain(rays, tt, pp, iters), None,
            # ~110 FLOP per LM evaluation (bilinear tap, ray error, 2x2 solve)
            n * 9 * 4 + m * (12 + 8 + 8 + 1), m * (iters + 1) * 110, "fp32",
            "mast3r_slam_tpu/ops/matching.py:117 (iter_proj, XLA)",
            "mast3r_slam_tpu_torch/csrc/iter_proj.cu", plain_reps=5)
        p_iters[iters] = a

    # 3. refine_matches: bf16 and int8, r=1 d=1 (tpu_fast), r=3 d=5 (base)
    p1i = p_iters[10].to(torch.int32)
    p1i = torch.stack([p1i[..., 0].clamp(0, w - 1),
                       p1i[..., 1].clamp(0, h - 1)], -1).contiguous()
    for dname, cast, esize in (
            ("bf16", lambda x: x.to(torch.bfloat16), 2),
            ("int8", matching._quantize_int8, 1)):
        D11 = cast(D[0:1]).contiguous()
        D21 = cast(D[1:2].reshape(1, n, -1)).contiguous()
        fdim = D11.shape[-1]
        for r, d in ((1, 1), (3, 5)):
            a = matching.refine_matches(D11, D21, p1i, r, d)
            b = matching.refine_matches_plain(D11, D21, p1i, r, d)
            diff = int((a != b).sum())
            if diff:
                raise AssertionError(f"refine_matches {dname} r={r} d={d}: "
                                     f"{diff} positions differ")
            kk = (2 * r + 1) ** 2
            rec("refine_matches", f"{dname} r={r} d={d} (1,196608)", 0.0,
                lambda: matching.refine_matches(D11, D21, p1i, r, d),
                lambda: matching.refine_matches_plain(D11, D21, p1i, r, d),
                None, n * fdim * esize * 2 + n * 8 * 2,
                n * d * kk * fdim * 2, dname,
                "mast3r_slam_tpu/ops/matching.py:189 (refine_matches; "
                "window_gather.py:183 refine_matches_full_unfold, XLA)",
                "mast3r_slam_tpu_torch/csrc/refine_matches.cu", plain_reps=3)
    torch.cuda.synchronize()
    return records


# -- phase 3: main path --------------------------------------------------------


def run_slam(preset_cfg, params, model_cfg, n_frames, traj):
    """Drive ``n_frames`` through make_frame/process_frame; returns the
    system and per-frame wall times (ms, each ending in a sync)."""
    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.models import oracle_timing
    from mast3r_slam_tpu_torch.slam.system import SLAMSystem

    cfg = preset_cfg
    cfg["tracking"] = dict(cfg["tracking"], kf_every=KF_EVERY)
    cfg["runtime"] = dict(cfg.get("runtime", {}), tracking_window=1)
    h, w = model_cfg.img_size
    system = SLAMSystem(params, model_cfg, cfg, (h, w), keyframe_capacity=16,
                        model_module=oracle_timing, device="cuda")
    rng = np.random.default_rng(1234)
    frames = [oracle_timing.make_frame_image(i, h, w, rng)
              for i in range(n_frames)]
    times = []
    for i in range(n_frames):
        t0 = time.perf_counter()
        system.process_frame(system.make_frame(i, frames[i]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return system, times


def assert_healthy(system, n_frames, traj, label):
    from mast3r_slam_tpu_torch.eval.ate import aligned_rmse
    from mast3r_slam_tpu_torch.slam.frame import Mode

    st = system.stats
    problems = []
    expect_kf = len(range(0, n_frames, KF_EVERY))
    if st["keyframes"] != expect_kf:
        problems.append(f"keyframes {st['keyframes']} != {expect_kf}")
    if st["skipped"] or st["frames_reloc"]:
        problems.append(f"skipped/reloc: {st}")
    if system.mode != Mode.TRACKING:
        problems.append(f"end mode {system.mode}")
    k = len(system.keyframes)
    ids = system.keyframes.dataset_idx[:k].cpu().numpy()
    est = system.keyframes.T_WC[:k, :3].cpu().numpy().astype("float64")
    gt = traj[ids, :3].cpu().numpy().astype("float64")
    rmse, extent = aligned_rmse(est, gt)
    if not rmse < 0.06 * max(extent, 1e-6):
        problems.append(f"keyframe RMSE {rmse} >= 0.06 * extent {extent}")
    if problems:
        raise AssertionError(f"unhealthy {label} run: " + "; ".join(problems))
    return rmse, extent


def stage_split(params, model_cfg, mcfg, tcfg):
    """Isolated CUDA-event times of the frontend's stages on one tracked
    frame (frame 1 against keyframe 0), in the order the path runs them."""
    import torch

    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.models import mast3r, oracle_timing
    from mast3r_slam_tpu_torch.ops import matching
    from mast3r_slam_tpu_torch.slam import system as sysmod
    from mast3r_slam_tpu_torch.slam import tracker
    from mast3r_slam_tpu_torch.slam.frame import fuse_pointmap

    h, w = model_cfg.img_size
    imgs = [torch.from_numpy(oracle_timing.make_frame_image(i, h, w))
            .cuda()[None] for i in (0, 1)]
    fk, pk = oracle_timing.encode(params, imgs[0], model_cfg)
    ff, pf = oracle_timing.encode(params, imgs[1], model_cfg)
    fk = fk.to(torch.bfloat16)           # as the keyframe store keeps it
    out = {}
    out["encode_network"] = time_ms(
        lambda: mast3r.encode(params["net"], imgs[1], model_cfg), reps=10)
    out["encode"] = time_ms(
        lambda: oracle_timing.encode(params, imgs[1], model_cfg), reps=10)
    out["decode_heads_network"] = time_ms(
        lambda: mast3r.inference_asymmetric(params["net"], ff, pf, fk, pk,
                                            model_cfg), reps=10)
    out["decode_heads"] = time_ms(
        lambda: oracle_timing.inference_asymmetric(params, ff, pf, fk, pk,
                                                   model_cfg), reps=10)
    X, C, D, Q = oracle_timing.inference_asymmetric(params, ff, pf, fk, pk,
                                                    model_cfg)
    args = (X[0:1], X[1:2], D[0:1], D[1:2])
    out["match"] = time_ms(lambda: matching.match(*args, **mcfg._asdict()))
    idx, valid = matching.match(*args, **mcfg._asdict())
    idx, valid = idx[0], valid[0]
    n = h * w
    Xf, Qf, Cf = X[0].reshape(n, 3), Q[0].reshape(n, 1), C[0].reshape(n, 1)
    Xk = X[1].reshape(n, 3)          # keyframe map, here in the frame's coords
    Qk, valid_opt, _ = sysmod._track_gate_pre(
        idx, valid, Qf[idx], Q[1].reshape(n, 1), Cf[idx], Cf, tcfg.C_conf,
        tcfg.Q_conf)
    T0 = sim3.identity(device="cuda")
    res = tracker.opt_pose_ray_dist_sim3(Xf[idx], Xk, T0, Qk, valid_opt, tcfg)
    out["gn"] = time_ms(lambda: tracker.opt_pose_ray_dist_sim3(
        Xf[idx], Xk, T0, Qk, valid_opt, tcfg), reps=10)
    out["gn_iters"] = res.iters
    N = torch.ones((), dtype=torch.int32, device="cuda")
    out["fusion"] = time_ms(lambda: fuse_pointmap(
        "weighted_pointmap", Xk, Cf, N, sim3.act(res.T_CkCf, Xk), Cf))
    return out


def device_busy(system, frame_id, image):
    """Profile one more tracked frame: device time summed over its kernels
    against its wall time, and the heaviest kernels."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        system.process_frame(system.make_frame(frame_id, image))
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    # the kernels themselves (operator rows would count their time twice)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name = collections.Counter()
    for e in kernels:
        per_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    return {"profiled_wall_ms": wall,
            "device_busy_ms": sum(per_name.values()),
            "kernels_run": len(kernels),
            "top_kernels_ms": dict(per_name.most_common(8))}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from mast3r_slam_tpu_torch.config import base_config, tpu_fast_config
    from mast3r_slam_tpu_torch.models import mast3r, oracle, oracle_timing
    from mast3r_slam_tpu_torch.ops import _kernels

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({smi}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    outs = _kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(sorted(outs)) or 'cached'})")
    for name, text in sorted(outs.items()):
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"  {name}: {regs}")

    model_cfg = mast3r.MASt3RConfig(head_dtype="bfloat16")
    h, w = model_cfg.img_size
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    net = mast3r.init_params(model_cfg, g, device="cuda")
    torch.cuda.synchronize()
    log(f"ViT-L MASt3R init: {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in net.parameters()) / 1e6:.1f} M params")

    n_traj = max(N_FAST, N_BASE) + 1      # one more frame for the profile
    traj = make_traj(n_traj).cuda()
    orc = oracle.make_params(traj, desc_dim=model_cfg.desc_dim, seed=0,
                             device="cuda")
    params = oracle_timing.make_params(net, orc)

    # phase 2: every kernel against its plain version
    records = check_kernels(model_cfg, orc)

    # phase 3: the main path, tpu_fast presets
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    system, times = run_slam(tpu_fast_config(), params, model_cfg, N_FAST,
                             traj)
    launches = dict(_kernels.LAUNCHES)
    rmse, extent = assert_healthy(system, N_FAST, traj, "tpu_fast")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    tracked = times[1:]
    med = statistics.median(tracked)
    log(f"tpu_fast main path: {N_FAST} frames, stats {system.stats}, "
        f"launches {launches}, keyframe RMSE {rmse:.6f} of extent "
        f"{extent:.6f}")
    log(f"per-frame ms (tracked frames): median {med:.3f}, all "
        f"{[round(t, 3) for t in times]}; frames/s {1e3 / med:.3f}")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    split = stage_split(params, model_cfg, system.tracker.mcfg,
                        system.tracker.tcfg)
    log("stage split (isolated, ms): " + json.dumps(split))
    busy = device_busy(system, N_FAST, oracle_timing.make_frame_image(
        N_FAST, h, w))
    busy["device_idle_share"] = 1.0 - busy["device_busy_ms"] / med
    log("one tracked frame under the profiler: " + json.dumps(busy))

    # the base presets: radius 3, dilation 5, 10 LM iterations
    _kernels.reset_launch_counts()
    sys_b, times_b = run_slam(base_config(), params, model_cfg, N_BASE, traj)
    launches_b = dict(_kernels.LAUNCHES)
    rmse_b, extent_b = assert_healthy(sys_b, N_BASE, traj, "base")
    if min(launches_b.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the base path: "
                             f"{launches_b}")
    log(f"base main path: {N_BASE} frames, stats {sys_b.stats}, launches "
        f"{launches_b}, keyframe RMSE {rmse_b:.6f} of extent {extent_b:.6f}, "
        f"per-frame ms median {statistics.median(times_b[1:]):.3f}")
    split_b = stage_split(params, model_cfg, sys_b.tracker.mcfg,
                          sys_b.tracker.tcfg)
    log("stage split base (isolated, ms): " + json.dumps(split_b))

    for r in records:
        r["launches"] = launches[r["name"]]
        r["launches_base_run"] = launches_b[r["name"]]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
