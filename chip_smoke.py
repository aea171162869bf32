#!/usr/bin/env python
"""GPU smoke run of the PyTorch/CUDA port (``mast3r_slam_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: the GPU's name and power limit, and the build of the CUDA
   kernels of ``mast3r_slam_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel, into ``build/torch_kernels/``) and of the native ASMK
   inverted file (``g++``, same directory).
2. Kernels: each kernel against its plain PyTorch version, on the GPU, at
   the main path's shapes under both matcher presets (integer outputs,
   converged flags and gathered values exactly equal, floats within the
   stated tolerance, the two reductions bit-equal across two calls), with
   CUDA-event timings (median of several runs) of the kernel, the plain
   version and, where one PyTorch call computes the function, that call.
   ``take_along`` alone at the probe's and the gate's shapes, and both
   directions of the edge gate in one launch (``take_along_pair``) on
   random indices and on an edge's match indices, bit-equal to its plain
   version and to two ``torch.take_along_dim`` calls.
   ``scharr_rays`` (tiled, in the 9-float and the padded 12-float record,
   and its first design, one thread a pixel) must equal the plain version
   bit for bit, the pad exactly zero; ``iter_proj`` on both records and its
   first design, at the tpu_fast coarse grid, the base full grid and the
   edge batch of 2: positions bit-equal, converged flags equal. Their
   records carry the first design's time (``baseline_ms``).
   ``coarse_correlate`` runs on the tensor cores and is held to
   ``dense_matcher.check_coarse_correlate``'s tie rule at both shapes, to
   exact planted winners, and to rows whose answer is known (NaN query,
   all-equal row, a maximum of zero, a NaN cell; widths 8, 16 and 32; a row
   count that is no multiple of a block's rows). ``refine_matches`` and
   ``refine_separable`` must equal their plain versions at every point,
   on every ``utils/kernel_cases`` kind at full size (smooth, uniformly
   random and border starts, NaNs, exact ties, +-inf, values whose
   products overflow and underflow fp32); the separable search is timed
   on the oracle's starts at batch 1 and 2, also on smooth and random
   starts (``by_starts_ms``), and both searches report registers a thread
   and resident blocks an SM (from their ptxas lines).
   ``match(payload=)`` at base's settings on the full grid, with the
   tracker's at-match channels (C and Q of view 1) as payload: idx and
   valid equal to the call without a payload, the picked-up rows bit-equal
   to the plain gather of ``[X11, payload]`` at the match, one
   ``gather_rows`` launch in the call (timed as its own record).
   ``gn_step`` (the tracker's whole solve in one launch) is held to
   ``tracker.gn_solve_plain`` at N = 196,608 in both residual modes: a
   solve that converges, one with no valid match (fails in 1 iteration)
   and one that runs to ``max_iters`` (equal iterations and failed flags,
   pose within 2e-5, cost within 1e-5 relative); ``ba_edge_terms`` (the
   BA system in one launch) to ``ba.edge_system_plain`` in three modes at
   E = 8, every 4th and every point, at E = 42, 9 keyframes, and from 64
   to 256 keyframes with up to 1,204 edges (1e-5 of the largest entry of
   each output). Both are timed where their fixed costs show (few points)
   and at full size; the BA kernel also against the terms-then-assemble
   path that it replaced. ``conv2d_3xtf32`` (fp32 convolution in split
   TF32 on the tensor cores) at every distinct conv shape of a ViT-L
   ``head_forward`` at batch 1, its relative RMS error against a float64
   convolution held to at most twice cuDNN fp32's (TF32 off) and 100x below
   plain TF32's; then a head_forward's 30 convs together at batch 1 and 2,
   also timed in turns against cuDNN fp32 (``turns_ms``).
3. Main path at full width: ViT-L MASt3R (384x512, bf16 transformer, bf16
   head, random weights from a seeded generator) driven through
   ``models.oracle_timing`` (the real network runs on every call; the SLAM
   stack sees ground-truth oracle geometry) by ``SLAMSystem.make_frame`` /
   ``process_frame`` / ``backend_step`` (the backend drained after every
   frame): 17 frames with the ``tpu_fast`` settings at ``kf_every=4``
   (consecutive edges from the tracker's match, bundle adjustment on every
   4th point), 5 frames with ``base`` at ``kf_every=2`` (edges by symmetric
   decode + match, bundle adjustment on every point), and 5 calibrated
   ``base`` frames (pixel + log-depth residuals in tracker and bundle
   adjustment). Each run must be healthy (keyframe and edge counts, no
   dropped edge, no skipped or relocalizing frame, TRACKING at the end,
   graph invariants, Sim(3)-aligned keyframe RMSE after bundle adjustment
   under 0.06 of the trajectory's extent) and must have launched the
   kernels of its path; every kernel must be launched by some run.
4. Loop closure and relocalization at full width, with a seeded random
   retrieval head (1024 -> 1024) and a 65,536 x 1024 codebook, the native
   inverted file, ``tpu_fast`` as its YAML states it (dense edge matcher,
   consecutive edges from the tracker's match, every 4th point): a **loop**
   run of 33 frames at ``kf_every=4`` with ``backend_prefetch()`` before
   every frame (9 keyframes, loop closures found and kept as edges), and
   three **teleport** runs of 9 frames (4 good frames, then a jump of 60
   units): relocalizing forever (``reinit_after=0``), re-initializing
   after two failures (``reinit_after=2``), and a camera that returns to
   the mapped scene and relocalizes.

5. The run loop at full width: ``SLAMSystem.run`` over
   ``io.datasets.RGBFiles`` on PNG files of the base run's 5 frames, once
   with ``single_thread`` (the frame-by-frame base run's stats, edge count
   and RMSE gate) and once with the backend in a host thread (graph
   invariants, finite poses, ``TERMINATED``); ``save_traj``,
   ``save_reconstruction`` and ``save_keyframes`` of the single-thread run,
   and ``eval.ate.ate_rmse`` of its TUM file against the oracle trajectory
   under 0.06 of the extent. Then the command line, ``cli.main`` with
   random weights on ``scripts/make_synth_dataset.py``'s 16 frames of
   480x640 (``configs/eval_no_calib.yaml``, ``--no-viz --max-frames 8``):
   its frames/s line, one TUM line per keyframe, a PLY that parses.

6. The windowed frontend, checkpoints and released weights, with
   ``configs/tpu_fast.yaml``'s ``tracking_window: 8`` as shipped:
   ``run()`` over PNG files of the tpu_fast frames at W = 8 (frame 0, then
   two windows; the frame-by-frame tpu_fast run's keyframes and stats,
   its health gates and poses within ``POSE_TOL_WINDOW``) beside the same
   ``run()`` at W = 1 (per-frame ms of both from this call), a third W = 8
   run counting each window's host syncs (at most one, the stats read), the
   loop run's 33 frames with retrieval at W = 8 (its gates), a crash after
   the first window resumed from the checkpoint in a fresh system, and
   ``cli.main`` with ``configs/tpu_fast.yaml``, ``--checkpoint`` on a
   released-format ``.pth`` of the smoke's random weights (read back
   bit-equal), ``--save-state`` and ``--resume``. ``rope_qk`` is also held
   to its plain version at the window's encoder batch (8, 16, 768, 64).

7. The separable search, the step-by-step tracker, the live viewer and
   the CLI's renders: **separable** (the base run with
   ``matching.separable_refine: true``: tracking and ``add_factors`` at
   batch 2 through the ``refine_separable`` kernel, held to base's health
   gates; ``refine_separable`` is held bit-equal to its plain version at
   base's shape, r = 3 d = 5 and r = 1 d = 1, bf16 and int8, batch 1 and
   2, in phase 2),
   **steps** (the base run with ``tracker.fused = False``: the fused run's
   stats and keyframes, keyframe poses within 1e-4; the host syncs of one
   of its tracked frames), **viewer** (``run()`` as the run_loop run with
   ``LiveViewer(port=0, refresh_s=0)``, paused from the start: a ``/ctrl``
   without the token refused, one step advances one frame; run_loop's
   stats and poses; ``/scene`` equal to ``viz.build_scene`` on CPU copies
   of the store; ``run()`` timed with the viewer beside run_loop), the
   viewer's refresh at the loop run's 9 keyframes and at 256 keyframes (ms,
   bytes read back, host syncs; none when no refresh is due, and a tracked
   frame with the viewer attached keeps its one sync) and **cli_viz**
   (``cli.main`` as the cli run without ``--no-viz`` and with
   ``--serve-viz 0``: the four renders, or the HTML viewer and the
   ``ImportError`` of the PNG renders where matplotlib is not installed).

8. The backend across devices, over a device list that repeats cuda:0
   (the machine has one GPU, so no cross-GPU copy is measured): **mirror**
   (the loop run and teleport (return) with ``runtime.backend_device: 1``
   over (cuda:0, cuda:0), the factor graph on a ``BackendMirror``: the
   loop run's counts, 9 keyframes, 13 loop closures, 42 edges, none
   dropped, its keyframe poses within 1e-5 of the dense loop run's, the
   teleport relocalized through ``seed_pose``; the syncs, bytes and ms of
   a sync, the host syncs of one backend step), **sharded BA on the loop
   graph** (its final graph solved dense, edge-sharded over 2 and 4 shards,
   keyframe-sharded over 2 and by Schur over 2, which falls back to
   edge-sharded when the separator dominates; poses within 1e-4 of dense,
   iterations and their step norms, ms per solve, the host syncs of a
   sharded solve), **Schur on a chain** (24 synthetic
   keyframes at 384x512 with two loop edges, not separator-dominated over
   2 or 4 shards: rays and calibrated, dense, edge-sharded and Schur,
   poses within 1e-4 of dense) and **sharded loop** (the loop run with
   ``parallel.ba_backend: edge_sharded`` over 2 x cuda:0: the dense loop
   run's gates and counts, keyframe poses within 1e-4 of it).

9. Data-parallel tracking, the sharded decode and multi-host runs:
   **dp_tracking** (two tpu_fast streams, first frames ``DP_FIRST``, one
   W = 8 window each through ``track_window_dp`` over (cuda:0, cuda:0):
   every output and store row bit-equal to the same window run alone, no
   host sync while both are enqueued; wall ms of both beside two lone
   windows), **sharded decode** (3 of the loop run's edges through
   ``inference_symmetric_dp`` over (cuda:0, cuda:0) against the one-device
   decode, within ``DECODE_TOL``), **multi-host BA** (two child processes
   of this script, ``--phase9-child ba``, that share cuda:0 and meet over
   gloo: the loop graph edge-sharded and by the Schur rule, the chain by
   Schur, each over the 2 ranks; the ranks' poses bit-identical and within
   ``SHARD_TOL`` of dense; the ms of a solve and of one all-reduce),
   **multi-host loop** (``--phase9-child loop``: the loop run in both
   processes with ``parallel.ba_backend: edge_sharded`` over a mesh of the
   two ranks: the dense loop run's counts, poses bit-identical between the
   ranks and within ``SHARD_TOL`` of the dense run's) and
   **multi-host CLI** (``--phase9-child cli``: ``cli.main`` with
   ``--coordinator 127.0.0.1:<port> --num-hosts 2 --host-id r --ba-backend
   edge_sharded`` and ``SLAM_DIST_BACKEND=gloo`` on the cli run's frames:
   both exit 0 and write byte-identical TUM files with the one-process
   run's keyframes), then three more pairs of children on cuda:0 over
   gloo: **multi-host kf BA** (``--phase9-child kf_ba``: the loop graph,
   K = 9 padded to 10, keyframe-sharded across the ranks, each rank's
   ``EdgePre`` bit-equal to the one-process prep of its shard, the ranks'
   poses bit-identical and within ``SHARD_TOL`` of dense; the exchange's
   bytes and ms, the solve's ms and iterations), **multi-host dp serving**
   (``--phase9-child dp_serve``: ``track_window_dp`` with one tpu_fast
   stream a rank, W = ``WINDOW``, bit-equal to a lone window of the same
   stream; the window's ms on each rank) and **multi-host sharded decode**
   (``--phase9-child dp_decode``: the loop run's 3-edge batch padded to 4,
   every rank's gathered outputs bit-equal to the one-process call over
   (cuda:0, cuda:0); the all-gather's bytes and ms). Each child runs under
   ``CHILD_TIMEOUT``, prints its launch counts in one ``PHASE9_CHILD`` JSON
   line, and fails the smoke if it fails.

10. Training: ``rope_qk_bwd`` (the backward of ``rope_qk``) bit-equal to
   autograd through ``rope_qk_plain`` with fp32 and bf16 gradients, timed
   beside the forward, at the full-width step's shapes and at the
   rehearsal student's (whose head dims, 32 and 24, take both kernels'
   scalar branch; ``rope_qk`` is held and timed there too); the full-width
   step's gradient through the kernels against the same step through
   ``rope_qk_plain`` (``GRAD_TOL``, every gradient nonzero); ``TRAIN_STEPS``
   trainer steps (``distill.loss_fn``, ``backward``,
   ``distill.optimizer_step``) of ViT-L MASt3R at its published widths,
   fp32, 384x512, 2 pairs of rendered oracle frames: every gradient finite,
   every parameter the loss reaches changed, ``ATTN_CALLS`` launches of
   ``rope_qk`` and of ``rope_qk_bwd`` a step, ms a step split into forward,
   backward and optimizer, peak memory, and the same steps' losses at
   ``PROBE_LR``; then the rehearsal
   (``distill.main``) shortened to ``REHEARSAL_STEPS`` steps and
   ``REHEARSAL_FRAMES`` frames, whose CLI child (``REHEARSAL_TIMEOUT``)
   must exit 0 with one pose per frame and launch ``REHEARSAL_KERNELS``
   (its ``kernel launches`` line), the loss falling; ATE and RPE printed.

The loop run's final factor graph is also put through ``ba_edge_terms``,
its plain version and the plain version in float64, the tracker's solve
on an oracle frame is held to ``tracker.gn_solve_plain``
(``check_oracle_gn``), and one more tracked frame of the tpu_fast run
counts its host syncs (PyTorch's sync debug mode).

Output: per-frame and per-keyframe backend times, peak memory, then a
line
``{"kernels": [...]}``, the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
MEM_BW = 3.35e12        # HBM3 bytes/s
PEAK_OPS = {"fp32": 67e12,      # FLOP/s outside the tensor cores
            "bf16": 989e12,     # tensor cores
            "tf32": 495e12,     # tensor cores
            "int8": 1979e12}    # tensor cores, OP/s
# fp32 instructions/s when each FLOP is one instruction (the kernels are
# built with -fmad=false: no fused multiply-add); reported beside the bound
FP32_NOFMA = 33.5e12
N_FAST, KF_FAST = 17, 4
N_BASE, KF_BASE = 5, 2
N_CALIB, KF_CALIB = 5, 2
N_LOOP, KF_LOOP = 33, 4
N_TRAJ = max(N_FAST + 1, N_BASE, N_LOOP)   # one more: the syncs' frame
KF_TELEPORT = 2
WINDOW = 8                          # configs/tpu_fast.yaml's tracking_window
# keyframe poses (all 8 numbers, max abs) of the window run against the
# frame-by-frame run: the chain tracks a window's frames against keyframe
# poses that bundle adjustment has not moved yet (it runs between windows)
POSE_TOL_WINDOW = 1e-3
# a resumed window run against the uninterrupted one: the keyframes queued
# at the checkpoint get their consecutive edges by decode + dense match
# (the tracker's matches are not part of a checkpoint), so the two runs
# solve slightly different graphs: their keyframe positions, Sim(3)-aligned,
# must agree within this share of the trajectory's extent
RESUME_TOL = 0.01
EDGE_CAPACITY = 64
EDGE_CAPACITY_LOOP = 256            # configs/base.yaml's
CODEBOOK = 65536
FRONTEND = {"scharr_rays", "iter_proj", "refine_matches", "gn_step",
            "rope_qk"}
BA_KERNELS = {"gather_rows", "ba_edge_terms"}
LOOP_KERNELS = FRONTEND | BA_KERNELS | {"coarse_correlate", "take_along"}


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def log(*a):
    print(*a, flush=True)


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


def device_ms(fn, reps=20, trials=3, host=None):
    """Device time of one ``fn()`` call in ms with the launch queue kept
    full: a device-side sleep holds the stream while the host enqueues
    ``reps`` calls, so the events see the calls back to back, not the host's
    launch cost. Median over ``trials``. ``host``: a list that receives the
    host's time to enqueue one call (ms), which is what a launch-bound
    caller pays."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    if host is not None:
        host.append(host_s / reps * 1e3)
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


def teleport_traj(n_good, n_bad, n_back=0):
    """Smooth motion, then a jump of 60 units to a disjoint scene region,
    where tracking must fail (``tests/test_failure_paths.py::
    _teleport_traj``); with ``n_back`` the camera then reappears next to
    its last good pose and moves on slowly."""
    import torch

    from mast3r_slam_tpu_torch.lie import sim3

    step = torch.tensor([0.15, 0.0, 0.03, 0.0, 0.05, 0.0, 0.0])
    Ts = [sim3.identity()]
    for _ in range(1, n_good):
        Ts.append(sim3.mul(Ts[-1], sim3.exp(step)))
    last_good = Ts[-1]
    far = sim3.exp(torch.tensor([60.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]))
    Ts.append(sim3.mul(far, Ts[-1]))
    for _ in range(1, n_bad):
        Ts.append(sim3.mul(Ts[-1], sim3.exp(step)))
    for _ in range(n_back):
        last_good = sim3.mul(last_good, sim3.exp(0.3 * step))
        Ts.append(last_good)
    return torch.stack(Ts)


def refine_occupancy():
    """Registers a thread and resident 128-thread blocks an SM of the two
    descriptor searches, from their ptxas lines: ``refine_matches`` by
    (dtype, F), ``refine_separable`` by (dtype, F, radius) for the radii it
    specialises (blocks from the register file: 256-register warp slots,
    16,384 registers an SM partition, at most 2,048 threads an SM)."""
    import re

    from mast3r_slam_tpu_torch.ops import _kernels

    occ = {}
    for name, kernel in (("refine_matches", "refine_kernel"),
                         ("refine_separable", "separable_kernel")):
        _kernels.library(name)
        text = (_kernels.BUILD_DIR / f"{name}.log").read_text()
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                t = re.search(kernel + r"I([ta])Li(\d+)E(?:Li(n?\d+)E)?",
                              entry)
                regs = int(m.group(1))
                warp = -(-regs * 32 // 256) * 256
                key = (name, "int8" if t.group(1) == "a" else "bf16",
                       int(t.group(2)))
                if t.group(3) is not None:
                    key += (int(t.group(3).replace("n", "-")),)
                occ[key] = {"registers": regs,
                            "blocks_per_sm": min(16384 // warp, 2048 // 128)}
                entry = None
    return occ


# -- phase 2: kernels ----------------------------------------------------------


def kernel_record(records, name, variant, err, kernel, plain, lib,
                  bound_bytes, bound_ops, ops_type, replaces, source,
                  plain_reps=20, tolerance="exact", **extra):
    """Times ``kernel``, ``plain`` and ``lib`` (or None) with device_ms and
    appends the kernel's record to ``records``; call_ms is one kernel call
    alone, host launch cost included. bound_bytes: each input read once,
    each output written once; bound_ops: the operations on inputs of type
    ops_type."""
    t_bytes = bound_bytes / MEM_BW * 1e3
    t_ops = bound_ops / PEAK_OPS[ops_type] * 1e3
    host_k, host_p = [], []
    ms = device_ms(kernel, host=host_k)
    r = {"name": name, "variant": variant, "route": "cuda",
         "source": source, "replaces": replaces, "launches": 0,
         "max_abs_err": err, "tolerance": tolerance, "ms": ms,
         "kernel_ms": ms,
         "call_ms": time_ms(kernel),
         "plain_ms": device_ms(plain, reps=plain_reps, host=host_p),
         "host_enqueue_ms": host_k[0], "plain_host_enqueue_ms": host_p[0],
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": None if lib is None else device_ms(lib), **extra}
    records.append(r)
    log("kernel", json.dumps(r))


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
    # the tracker's at-match channels of view 1 (C, Q) as match's payload
    pay = torch.stack([C[0], Q[0]], -1)[None].contiguous()
    records = []

    rec = functools.partial(kernel_record, records)

    # 1. Scharr, fused with the ray normalization (the matcher's input): the
    # tiled kernel in both records, and the first design (one thread a
    # pixel) as the yardstick; every one bit-equal
    ref = gradient.prep_rays_grad_plain(X11)
    exact = lambda a, b: float((a - b).abs().max())
    for out_c, tiled in ((9, True), (12, True), (9, False)):
        got = gradient._scharr_cuda(X11, True, out_c, tiled)
        err = exact(got[..., :9], ref)
        pad = float(got[..., 9:].abs().max()) if out_c == 12 else 0.0
        if not (err == 0.0 and pad == 0.0):
            raise AssertionError(f"scharr_rays record {out_c} tiled {tiled} "
                                 f"vs plain: {err}, pad {pad}")
    # plain-stencil mode: batch 2, c = 9, no normalization
    img9 = torch.cat([ref, ref.flip(1)], 0).contiguous()
    gx, gy = gradient.img_gradient(img9)
    gx0, gy0 = gradient.img_gradient_plain(img9)
    err2 = max(exact(gx, gx0), exact(gy, gy0))
    if not err2 == 0.0:
        raise AssertionError(f"scharr_rays (c=9, b=2) vs plain: {err2}")
    kx = torch.tensor([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]],
                      device="cuda") / 32
    wts = torch.stack([kx, kx.T]).repeat(3, 1, 1)[:, None]     # (6,1,3,3)

    def library():
        x = F.normalize(X11, dim=-1).permute(0, 3, 1, 2)
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), wts,
                        groups=3)

    # per pixel: one normalization (~9 FLOP), 2 x 3 stencils (~11 each);
    # the bound is the function's (9 floats out), the pad is the design's
    bound_bytes, bound_ops = n * 3 * 4 + n * 9 * 4, n * (9 + 6 * 11)
    for out_c, variant, fn, plain in (
            (12, "prep_rays_grad_padded (1,384,512,3)->(1,384,512,12), the "
             "matcher's", gradient.prep_rays_grad_padded,
             gradient.prep_rays_grad_padded_plain),
            (9, "prep_rays_grad (1,384,512,3)->(1,384,512,9)",
             gradient.prep_rays_grad, gradient.prep_rays_grad_plain)):
        extra = ({"baseline": "one thread a pixel, 9 floats (the first "
                              "design)",
                  "baseline_ms": device_ms(lambda: gradient._scharr_cuda(
                      X11, True, 9, False))} if out_c == 9 else {})
        rec("scharr_rays", variant, max(exact(fn(X11)[..., :9], ref), err2),
            lambda: fn(X11), lambda: plain(X11), library, bound_bytes,
            bound_ops, "fp32",
            "mast3r_slam_tpu/ops/pallas_gradient.py:31 (_scharr_kernel, "
            "pallas_call :68)", "mast3r_slam_tpu_torch/csrc/scharr_rays.cu",
            tolerance="exact (channels 0-8 bit-equal, the pad zero)",
            tile="32x8",
            bound_ms_with_pad=(n * 3 * 4 + n * out_c * 4) / MEM_BW * 1e3,
            **extra)
    rays9 = gradient.prep_rays_grad(X11)
    rays12 = gradient.prep_rays_grad_padded(X11)

    # 2. iter_proj: tpu_fast coarse subgrid (3 iters), base full grid (10),
    # and the edge builder's batch of 2 at the base grid; both records, and
    # the first design as the yardstick; every one bit-equal
    pts = gradient.l2_normalize(X21.reshape(1, n, 3)).contiguous()
    ident = torch.arange(n, device="cuda")[None]
    p_full = matching.lin_to_pixel(ident, w).float().contiguous()
    pc = p_full.reshape(1, h, w, 2)[:, ::2, ::2].reshape(1, -1, 2).contiguous()
    tc = pts.reshape(1, h, w, 3)[:, ::2, ::2].reshape(1, -1, 3).contiguous()
    rays9_b2 = gradient.prep_rays_grad(X)
    rays12_b2 = gradient.prep_rays_grad_padded(X)
    pts_b2 = gradient.l2_normalize(X.flip(0).reshape(2, n, 3)).contiguous()
    p_b2 = p_full.expand(2, n, 2).contiguous()
    p_iters = {}
    for variant, (r9, r12, pp, tt, iters) in {
            "tpu_fast coarse (1,49152) x3": (rays9, rays12, pc, tc, 3),
            "base full (1,196608) x10": (rays9, rays12, p_full, pts, 10),
            "edge batch full (2,196608) x10": (rays9_b2, rays12_b2, p_b2,
                                               pts_b2, 10)}.items():
        b_, m = tt.shape[:2]
        b, cb = matching.iter_proj_plain(r9, tt, pp, iters)
        for c, img, first in ((12, r12, False), (9, r9, False),
                              (9, r9, True)):
            a, ca = matching._iter_proj_cuda(img, tt, pp, iters, 1e-8, 1e-6,
                                             first)
            err, flips = exact(a, b), int((ca != cb).sum())
            if not (err == 0.0 and flips == 0):
                raise AssertionError(
                    f"iter_proj {variant} record {c} first {first}: pos err "
                    f"{err}, {flips} converged flags differ")
        record9_ms = device_ms(lambda: matching.iter_proj(r9, tt, pp, iters))
        first_ms = device_ms(lambda: matching._iter_proj_cuda(
            r9, tt, pp, iters, 1e-8, 1e-6, True))
        a, ca = matching.iter_proj(r12, tt, pp, iters)
        err = exact(a, b)
        if not (err == 0.0 and torch.equal(ca, cb)):
            raise AssertionError(f"iter_proj {variant}: pos err {err}")
        rec("iter_proj", f"{variant}, 12-float record",
            err, lambda: matching.iter_proj(r12, tt, pp, iters),
            lambda: matching.iter_proj_plain(r12, tt, pp, iters), None,
            # ~110 FLOP per LM evaluation (bilinear tap, ray error, 2x2
            # solve); the bound reads the 9-float image once (the pad is the
            # design's cost, not the work's)
            b_ * n * 9 * 4 + b_ * m * (12 + 8 + 8 + 1),
            b_ * m * (iters + 1) * 110, "fp32",
            "mast3r_slam_tpu/ops/matching.py:117 (iter_proj, XLA)",
            "mast3r_slam_tpu_torch/csrc/iter_proj.cu", plain_reps=5,
            tolerance="exact (positions bit-equal, converged flags equal), "
            "both records and the first design",
            record9_ms=record9_ms,
            baseline="one thread a point, 9-float record, scalar loads (the "
            "first design)", baseline_ms=first_ms)
        p_iters[(b_, iters)] = a

    # 3. refine_matches: bf16 and int8, r=1 d=1 (tpu_fast), r=3 d=5 (base),
    # on the oracle's smooth starts
    from mast3r_slam_tpu_torch.utils import kernel_cases

    p1i = p_iters[(1, 10)].to(torch.int32)
    p1i = torch.stack([p1i[..., 0].clamp(0, w - 1),
                       p1i[..., 1].clamp(0, h - 1)], -1).contiguous()
    p1e = p_iters[(2, 10)].to(torch.int32)          # the edge batch's
    p1e = torch.stack([p1e[..., 0].clamp(0, w - 1),
                       p1e[..., 1].clamp(0, h - 1)], -1).contiguous()
    casts = (("bf16", lambda x: x.to(torch.bfloat16), 2),
             ("int8", matching._quantize_int8, 1))
    occ = refine_occupancy()

    def refine_equal(D11, D21, p1, r, d, label):
        """The kernel against the plain version, point by point."""
        ref = matching.refine_matches_plain(D11, D21, p1, r, d)
        got = matching.refine_matches(D11, D21, p1, r, d, grid_width=w)
        diff = int((got != ref).any(-1).sum())
        if diff:
            raise AssertionError(f"refine_matches {label} r={r} d={d}: "
                                 f"{diff} points differ")

    def separable_equal(D11, D21, p1, r, d, label):
        ref = matching.refine_matches_separable_plain(D11, D21, p1, r, d)
        got = matching.refine_matches_separable(D11, D21, p1, r, d,
                                                grid_width=w)
        diff = int((got != ref).any(-1).sum())
        if diff:
            raise AssertionError(f"refine_separable {label} r={r} d={d}: "
                                 f"{diff} points differ")

    for dname, cast, esize in casts:
        D11 = cast(D[0:1]).contiguous()
        D21 = cast(D[1:2].reshape(1, n, -1)).contiguous()
        fdim = D11.shape[-1]
        for r, d in ((1, 1), (3, 5)):
            refine_equal(D11, D21, p1i, r, d, dname)
            kk = (2 * r + 1) ** 2
            ops = n * d * kk * fdim * 2
            rec("refine_matches", f"{dname} r={r} d={d} (1,196608)", 0.0,
                lambda: matching.refine_matches(D11, D21, p1i, r, d,
                                                grid_width=w),
                lambda: matching.refine_matches_plain(D11, D21, p1i, r, d),
                None, n * fdim * esize * 2 + n * 8 * 2, ops, dname,
                "mast3r_slam_tpu/ops/matching.py:189 (refine_matches; "
                "window_gather.py:183 refine_matches_full_unfold, XLA)",
                "mast3r_slam_tpu_torch/csrc/refine_matches.cu", plain_reps=3,
                bound_ms_fp32_cores=ops / PEAK_OPS["fp32"] * 1e3,
                **occ[("refine_matches", dname, fdim)])

    # the separable search: 2 (2r+1) taps a level, on the oracle's starts
    # (the tracker's at batch 1, add_factors' at batch 2); each record also
    # times it on smooth and on uniformly random starts at the same batch
    # (by_starts_ms), every point of every input compared first
    sep_inputs = {(1, "oracle"): (D[0:1], D[1:2].reshape(1, n, -1), p1i),
                  (2, "oracle"): (D, D.flip(0).reshape(2, n, -1), p1e)}
    for starts in ("smooth", "random"):
        A, Q, p1 = (torch.from_numpy(a).cuda() for a in
                    kernel_cases.refine_case(starts, 1, h, w, h, w,
                                             D.shape[-1], seed=3))
        sep_inputs[(1, starts)] = (A, Q, p1)
        # batch 2: the second item is the first one mirrored left to right
        # (image, query grid and starts), the same kind of starts
        mirror = lambda x: x.reshape(1, h, w, -1).flip(2).reshape(1, n, -1)
        p1m = mirror(torch.stack([w - 1 - p1[..., 0], p1[..., 1]], -1))
        sep_inputs[(2, starts)] = (torch.cat([A, A.flip(2)]),
                                   torch.cat([Q, mirror(Q)]),
                                   torch.cat([p1, p1m]).contiguous())
    for dname, cast, esize in casts:
        for r, d in ((1, 1), (3, 5)):
            for b_ in (1, 2):
                by_starts = {}
                for starts in ("oracle", "smooth", "random"):
                    A, Q, p1 = sep_inputs[(b_, starts)]
                    D11, D21 = cast(A).contiguous(), cast(Q).contiguous()
                    separable_equal(D11, D21, p1, r, d, f"{starts} {dname}")
                    if starts != "oracle":
                        by_starts[starts] = device_ms(
                            lambda: matching.refine_matches_separable(
                                D11, D21, p1, r, d, grid_width=w), reps=10)
                A, Q, p1 = sep_inputs[(b_, "oracle")]
                D11, D21 = cast(A).contiguous(), cast(Q).contiguous()
                fdim = D11.shape[-1]
                ops = b_ * n * d * 2 * (2 * r + 1) * fdim * 2
                rec("refine_separable",
                    f"{dname} r={r} d={d} oracle starts ({b_},{n})", 0.0,
                    lambda: matching.refine_matches_separable(
                        D11, D21, p1, r, d, grid_width=w),
                    lambda: matching.refine_matches_separable_plain(
                        D11, D21, p1, r, d),
                    None, b_ * (n * fdim * esize * 2 + n * 8 * 2), ops,
                    dname,
                    "mast3r_slam_tpu/ops/window_gather.py:374 "
                    "(refine_matches_separable with _axis_pass :353, XLA; "
                    "run by ops/matching.py:372 under separable_refine)",
                    "mast3r_slam_tpu_torch/csrc/refine_separable.cu",
                    plain_reps=3 if b_ == 1 else 1,
                    bound_ms_fp32_cores=ops / PEAK_OPS["fp32"] * 1e3,
                    by_starts_ms=by_starts,
                    **occ[("refine_separable", dname, fdim, r)])

    # both searches from starts that try to break them, full size, every
    # point compared with the plain versions
    for kind in kernel_cases.REFINE_KINDS:
        A, Q, p1 = sep_inputs.get((1, kind)) or (
            torch.from_numpy(a).cuda() for a in kernel_cases.refine_case(
                kind, 1, h, w, h, w, D.shape[-1], seed=3))
        for dname, cast, _ in casts:
            if dname == "int8" and kind in kernel_cases.BF16_ONLY_KINDS:
                continue
            Ad, Qd = cast(A).contiguous(), cast(Q).contiguous()
            for r, d in ((1, 1), (3, 5)):
                refine_equal(Ad, Qd, p1, r, d, f"{kind} {dname}")
                separable_equal(Ad, Qd, p1, r, d, f"{kind} {dname}")
                log(f"refine_matches and refine_separable {kind} starts "
                    f"{dname} r={r} d={d}: equal to the plain versions at "
                    f"all {n} points")
    check_match_payload(rec, X, D, pay, h, w)
    check_backend_kernels(rec, X, D, n)
    check_loop_kernels(rec, model_cfg, D)
    torch.cuda.synchronize()
    return records


def check_conv_3xtf32(records):
    """``conv2d_3xtf32`` at every conv of a ViT-L 512 ``head_forward``
    (``kernel_cases.dpt_conv_shapes``, channels-last inputs and weights as
    the DPT passes them): a record a distinct shape at batch 1, its error
    against a float64 convolution beside cuDNN's fp32 one (TF32 off) and
    plain TF32's, held to at most twice cuDNN's and 100x below TF32's; then
    a record of a head_forward's 30 convs together at batch 1 and at an
    edge's batch 2, each also timed in turns (cuDNN, kernel, kernel, cuDNN:
    ``turns_ms``). The bound is 3 x the FLOPs at the TF32 peak;
    ``library_ms`` is ``F.conv2d`` in fp32 on NCHW tensors plus the bias,
    what ``layers.conv2d`` ran before (the yardstick only)."""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_tpu_torch._device import exact_fp32
    from mast3r_slam_tpu_torch.models import mast3r
    from mast3r_slam_tpu_torch.ops import conv
    from mast3r_slam_tpu_torch.utils import kernel_cases

    exact_fp32()
    cl = torch.channels_last
    source = "mast3r_slam_tpu_torch/csrc/conv2d_3xtf32.cu"
    replaces = ("none: mast3r_slam_tpu/models/dpt.py's convolutions "
                "(models/layers.py::conv2d) are XLA's")

    def rel(a, ref):
        return float((a.double() - ref).norm() / ref.norm())

    def case(shape, seed):
        (b, c, h, w), (n, _, r, s), stride, pad, has_bias = shape
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(b, c, h, w, generator=g, device="cuda")
        wt = ((torch.rand(n, c, r, s, generator=g, device="cuda") * 2 - 1)
              / math.sqrt(c * r * s))
        bias = ((torch.rand(n, generator=g, device="cuda") * 2 - 1) * 0.02
                if has_bias else None)
        return dict(x=x, w=wt, bias=bias, stride=stride, pad=pad,
                    xc=x.contiguous(memory_format=cl),
                    wc=wt.contiguous(memory_format=cl))

    def kernel(k):
        return conv.conv2d_3xtf32(k["xc"], k["wc"], k["bias"], k["stride"],
                                  k["pad"])

    def plain(k):
        return conv.conv2d_3xtf32_plain(k["x"], k["w"], k["bias"],
                                        k["stride"], k["pad"])

    def library(k):
        y = F.conv2d(k["x"], k["w"], stride=k["stride"],
                     padding=k["pad"]).float()
        return y if k["bias"] is None else y + k["bias"][:, None, None]

    def flops(shape):
        (b, c, h, w), (n, _, r, s), stride, pad, _ = shape
        ho = (h + 2 * pad - r) // stride + 1
        wo = (w + 2 * pad - s) // stride + 1
        return 2 * b * ho * wo * n * c * r * s

    def io_bytes(shape):
        (b, c, h, w), (n, _, r, s), stride, pad, has_bias = shape
        ho = (h + 2 * pad - r) // stride + 1
        wo = (w + 2 * pad - s) // stride + 1
        return 4 * (b * c * h * w + n * c * r * s + b * n * ho * wo
                    + (n if has_bias else 0))

    cfg = mast3r.MASt3RConfig(head_dtype="float32")
    worst = {"ratio": 0.0, "tf32_margin": float("inf")}
    for i, shape in enumerate(dict.fromkeys(
            kernel_cases.dpt_conv_shapes(cfg, 1))):
        k = case(shape, 40 + i)
        got = kernel(k)
        ref = F.conv2d(k["x"].double(), k["w"].double(),
                       None if k["bias"] is None else k["bias"].double(),
                       stride=k["stride"], padding=k["pad"])
        tf32 = F.conv2d(conv.tf32_round(k["x"]), conv.tf32_round(k["w"]),
                        k["bias"], stride=k["stride"], padding=k["pad"])
        err, e32, etf = rel(got, ref), rel(library(k), ref), rel(tf32, ref)
        eplain = rel(plain(k), ref)
        del ref
        if not (err <= 2.0 * e32 and 100.0 * err <= etf):
            raise AssertionError(f"conv2d_3xtf32 at {shape}: error {err} "
                                 f"against cuDNN fp32's {e32}, TF32's {etf}")
        worst["ratio"] = max(worst["ratio"], err / e32)
        worst["tf32_margin"] = min(worst["tf32_margin"], etf / err)
        (b, c, h, w), (n, _, r, s), stride, pad, has_bias = shape
        bn, per, splits = conv.plan(b * got.shape[2] * got.shape[3], n, c, r,
                                    s, torch.cuda.get_device_properties(0)
                                    .multi_processor_count)
        kernel_record(
            records, "conv2d_3xtf32",
            f"x {shape[0]} w {shape[1]} stride {stride} pad {pad} bias "
            f"{has_bias}: tile 128x{bn}, {splits} K range(s)", err,
            functools.partial(kernel, k), functools.partial(plain, k),
            functools.partial(library, k), io_bytes(shape),
            3 * flops(shape), "tf32", replaces, source, plain_reps=5,
            tolerance="relative RMS against float64 <= 2x cuDNN fp32's "
                      "and <= TF32's / 100",
            gflop=flops(shape) / 1e9, cudnn_fp32_err=e32, tf32_err=etf,
            plain_err=eplain)
    log(f"conv2d_3xtf32 at the DPT shapes: error at most {worst['ratio']:.3f}"
        f" x cuDNN fp32's, at least {worst['tf32_margin']:.0f} x below "
        f"TF32's")

    for b in (1, 2):
        shapes = kernel_cases.dpt_conv_shapes(cfg, b)
        cases = [case(sh, 90 + i) for i, sh in enumerate(shapes)]

        def run(fn):
            for k in cases:
                fn(k)

        turns = [(name, device_ms(functools.partial(run, fn), reps=5))
                 for name, fn in (("cudnn", library), ("kernel", kernel),
                                  ("kernel", kernel), ("cudnn", library))]
        gf = sum(flops(sh) for sh in shapes)
        kernel_record(
            records, "conv2d_3xtf32",
            f"a ViT-L 512 head_forward's {len(shapes)} convs, b={b}, "
            f"{gf / 1e9:.1f} GFLOP", worst["ratio"],
            functools.partial(run, kernel), functools.partial(run, plain),
            functools.partial(run, library),
            sum(io_bytes(sh) for sh in shapes), 3 * gf, "tf32", replaces,
            source, plain_reps=3,
            tolerance="per shape as above (max_abs_err: the largest "
                      "error ratio to cuDNN fp32)",
            gflop=gf / 1e9, turns_ms=turns,
            kernel_share_of_cudnn=(turns[1][1] + turns[2][1])
            / (turns[0][1] + turns[3][1]))


def check_match_payload(rec, X, D, pay, h, w):
    """``match(payload=)`` at base's settings (r = 3, d = 5, full grid) with
    the tracker's at-match channels (C and Q of view 1) as payload: idx and
    valid equal to the call without a payload, ``[X11, payload]`` at the
    match bit-equal to the plain gather of the same rows, one
    ``gather_rows`` launch in the call; that gather timed as a record."""
    import torch

    from mast3r_slam_tpu_torch.ops import _kernels, gather, matching

    n = h * w
    X11, X21 = X[0:1].contiguous(), X[1:2].contiguous()
    kw = dict(max_iter=10, radius=3, dilation_max=5)
    before = dict(_kernels.LAUNCHES)
    idx, valid, pay_m = matching.match(X11, X21, D[0:1], D[1:2],
                                       payload=pay, **kw)
    torch.cuda.synchronize()
    launches = {k: v - before.get(k, 0) for k, v in _kernels.LAUNCHES.items()
                if v != before.get(k, 0)}
    idx0, valid0 = matching.match(X11, X21, D[0:1], D[1:2], **kw)
    table = torch.cat([X11, pay], -1).reshape(n, -1).contiguous()
    rows = idx.reshape(-1).to(torch.int32)
    want = gather.gather_rows_plain(table, rows).reshape(pay_m.shape)
    same = torch.equal(pay_m.view(torch.int32), want.view(torch.int32))
    if not (torch.equal(idx, idx0) and torch.equal(valid, valid0) and same
            and launches.get("gather_rows") == 1):
        raise AssertionError(
            f"match(payload=): idx equal {torch.equal(idx, idx0)}, valid "
            f"equal {torch.equal(valid, valid0)}, payload bit-equal {same}, "
            f"launches {launches}")
    log(f"match(payload=) base r=3 d=5 (1,{n}) with [C, Q]: idx and valid "
        f"equal to the call without a payload, the payload at the match "
        f"bit-equal to the plain gather, launches {launches}")
    rows64 = rows.long()
    c = table.shape[1]
    rec("gather_rows", f"match(payload=) pickup ({n},{c}) x{n}", 0.0,
        lambda: gather.gather_rows(table, rows),
        lambda: gather.gather_rows_plain(table, rows),
        lambda: torch.index_select(table, 0, rows64),
        2 * n * c * 4 + n * 4, 0, "fp32",
        "mast3r_slam_tpu/ops/matching.py:330 (match(payload=): the pickup "
        "of window_gather.py:275 refine_and_gather_full_unfold, XLA); the "
        "row gather of scripts/probe_pallas_gather.py:38 and :52",
        "mast3r_slam_tpu_torch/csrc/gather_rows.cu",
        match_ms=time_ms(lambda: matching.match(
            X11, X21, D[0:1], D[1:2], payload=pay, **kw), reps=5, warmup=1),
        match_without_payload_ms=time_ms(lambda: matching.match(
            X11, X21, D[0:1], D[1:2], **kw), reps=5, warmup=1))


def check_loop_kernels(rec, model_cfg, D):
    """``coarse_correlate`` at the dense edge matcher's shapes (b = 2: both
    directions of one candidate edge; 12,288 query rows at ``query_stride``
    4, 49,152 at 1) and ``rope_qk`` at the encoder's and decoder's shapes,
    b = 1 (tracking) and 4 (two candidate edges), and the encoder's at
    b = 8 (a window's frames)."""
    import torch

    from mast3r_slam_tpu_torch.models import rope
    from mast3r_slam_tpu_torch.ops import dense_matcher

    h, w = model_cfg.img_size
    f = D.shape[-1]
    stride = 4
    hc, wc = h // stride, w // stride
    nc = hc * wc
    D11 = D.to(torch.bfloat16).contiguous()                 # (2, h, w, f)
    Dc = D11[:, ::stride, ::stride].reshape(2, nc, f).contiguous()
    D21_full = D11.flip(0)            # each view queried against the other
    def held(got, D21, D11, label):
        """The tie rule of ``dense_matcher.check_coarse_correlate``."""
        chk = dense_matcher.check_coarse_correlate(got, D21, D11, stride)
        if chk["score_off"] or chk["unique_moved"] or chk["nan_wrong"]:
            raise AssertionError(f"coarse_correlate {label}: {chk}")
        return chk

    for qs in (4, 1):
        D21 = D21_full[:, :, ::qs][:, ::2, ::2].reshape(2, -1, f).contiguous()
        rows = D21.shape[1]
        got = dense_matcher.coarse_correlate(D21, D11, stride)
        chk = held(got, D21, D11, f"rows {rows} (oracle descriptors)")
        # random descriptors (the oracle's smooth field repeats itself, so
        # its cells are no unique winners): the rule, the share of identical
        # indices, and planted unique winners (twice a cell's descriptor)
        g = torch.Generator(device="cuda").manual_seed(rows)
        Dr = torch.nn.functional.normalize(
            torch.randn(2, h, w, f, generator=g, device="cuda"),
            dim=-1).to(torch.bfloat16)
        Qr = torch.nn.functional.normalize(
            torch.randn(2, rows, f, generator=g, device="cuda"),
            dim=-1).to(torch.bfloat16)
        chk_r = held(dense_matcher.coarse_correlate(Qr, Dr, stride), Qr, Dr,
                     f"rows {rows} (random descriptors)")
        pick = torch.randint(0, nc, (2, 4096), generator=g, device="cuda")
        cell_desc = Dr[:, ::stride, ::stride].reshape(2, nc, f).float()
        planted = (2.0 * torch.gather(
            cell_desc, 1, pick[..., None].expand(-1, -1, f))).to(
                torch.bfloat16)
        gp = dense_matcher.coarse_correlate(planted, Dr, stride)
        expect = ((pick // wc * stride + stride // 2) * w
                  + pick % wc * stride + stride // 2)
        if (not torch.equal(gp.long(), expect)
                or chk_r["identical_share"] < 0.99):
            raise AssertionError(
                f"coarse_correlate rows {rows}: planted winners equal: "
                f"{torch.equal(gp.long(), expect)}; identical indices on "
                f"random descriptors {chk_r['identical_share']} < 0.99")
        ops = 2 * 2 * rows * nc * f

        def library():
            return torch.argmax(torch.bmm(D21, Dc.transpose(1, 2)), dim=-1)

        rec("coarse_correlate",
            f"b=2 rows={rows} cells={nc} f={f} (query_stride {qs})",
            float(1.0 - chk["identical_share"]),
            lambda: dense_matcher.coarse_correlate(D21, D11, stride),
            lambda: dense_matcher.coarse_correlate_plain(D21, D11, stride),
            library, (2 * rows + 2 * nc) * f * 2 + 2 * rows * 4, ops, "bf16",
            "mast3r_slam_tpu/ops/dense_matcher.py:37 (coarse_correlate, XLA)",
            "mast3r_slam_tpu_torch/csrc/coarse_correlate.cu", plain_reps=2,
            tolerance="on every row the plain bf16 score of the chosen cell "
            "is within one bf16 step of the row's plain maximum; rows whose "
            "plain maximum is unique by more than one step have the plain "
            "index; NaN rows pick the first NaN cell; planted winners exact; "
            "max_abs_err is the share of rows whose index differs from the "
            "plain version's on the oracle's descriptors",
            identical_index_share=chk["identical_share"],
            identical_index_share_random=chk_r["identical_share"],
            bound_ms_fp32_cores=ops / PEAK_OPS["fp32"] * 1e3,
            library="torch.bmm (bf16, contiguous cells) + argmax")

    # rows whose answer is known (a NaN query, an all-equal row, a maximum
    # of exactly zero, a NaN cell), other widths, and a row count that is no
    # multiple of the block's rows
    from mast3r_slam_tpu_torch.utils import kernel_cases

    for b_, h_, w_, f_, n_ in ((2, 64, 96, 8, 1000), (2, 64, 96, 32, 333),
                               (1, 50, 70, 16, 77), (2, 384, 512, 24, 12289)):
        A, Q, expect = kernel_cases.coarse_edge_case(b_, h_, w_, f_, n_,
                                                     stride, seed=f_)
        A, Q = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (A, Q))
        got = dense_matcher.coarse_correlate(Q, A, stride)
        chk = held(got, Q, A, f"edge cases b={b_} f={f_} n={n_}")
        got_host = got.cpu()
        wrong = [(i, r, c) for i, r, c in expect if int(got_host[i, r])
                 != kernel_cases.cell_center(c, h_, w_, stride)]
        if wrong:
            raise AssertionError(f"coarse_correlate edge cases b={b_} f={f_} "
                                 f"n={n_}: wrong rows {wrong[:5]}")
        log(f"coarse_correlate edge cases b={b_} h={h_} w={w_} f={f_} "
            f"n={n_}: {len(expect)} known rows exact, {chk}")

    n_tok = model_cfg.num_patches
    ys = torch.arange(h // 16, device="cuda").repeat_interleave(w // 16)
    xs = torch.arange(w // 16, device="cuda").repeat(h // 16)
    pos = torch.stack([ys, xs], dim=-1)
    g = torch.Generator(device="cuda").manual_seed(5)
    # the encoder also at batch W = 8: the windowed frontend encodes its
    # frames as one batch
    for part, dim, heads, batches in (
            ("encoder", model_cfg.enc_embed_dim, model_cfg.enc_num_heads,
             (1, 4, WINDOW)),
            ("decoder", model_cfg.dec_embed_dim, model_cfg.dec_num_heads,
             (1, 4))):
        d = dim // heads
        for b in batches:
            qkv = torch.randn(b, n_tok, 3, heads, d, generator=g,
                              device="cuda")
            q, k = (qkv[:, :, i].transpose(1, 2) for i in (0, 1))
            tabs = rope.rope_tables(pos.expand(b, n_tok, 2), d,
                                    model_cfg.rope_base, torch.float32)
            err = 0.0
            for dt in (torch.float32, torch.bfloat16):
                a = rope.rope_qk(q, k, tabs, tabs, dt)
                r = rope.rope_qk_plain(q, k, tabs, tabs, dt)
                err = max(err, *(float((x.float() - y.float()).abs().max())
                                 for x, y in zip(a, r)))
            if err != 0.0:
                raise AssertionError(f"rope_qk {part} b={b}: differs from "
                                     f"the plain version by {err}")
            el = b * heads * n_tok * d
            rec("rope_qk", f"{part} q,k ({b},{heads},{n_tok},{d}) fp32 -> "
                "fp32 (strided views of the qkv projection)", err,
                lambda: rope.rope_qk(q, k, tabs, tabs, torch.float32),
                lambda: rope.rope_qk_plain(q, k, tabs, tabs, torch.float32),
                None, 2 * el * 8 + 2 * b * n_tok * d * 4, 2 * el * 3, "fp32",
                "mast3r_slam_tpu/models/rope.py:33 (rope_2d on q and k, "
                "models/vit.py:57-59 and :68-70, XLA)",
                "mast3r_slam_tpu_torch/csrc/rope_qk.cu",
                tolerance="bit-equal, fp32 and bf16 outputs")


def check_backend_kernels(rec, X, D, n):
    """The gathers (exact) and the two reductions (1e-5 of the largest
    entry, bit-equal across two calls) at the backend's shapes."""
    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.config import base_config, make_matching_config
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.ops import gather, matching
    from mast3r_slam_tpu_torch.slam import ba, tracker

    rng = np.random.default_rng(7)
    dev = "cuda"
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    probe = "scripts/probe_pallas_gather.py"

    # 4. gather_rows: the probe's shape and the BA shape
    for variant, R, C, N in (("probe (4096,256) x1024", 4096, 256, 1024),
                             ("BA (8*196608,4) x8*49152", 8 * n, 4,
                              8 * n // 4)):
        table = f32(rng.standard_normal((R, C)))
        idx = i32(rng.integers(0, R, N))
        idx64 = idx.long()
        got = gather.gather_rows(table, idx)
        if not torch.equal(got, gather.gather_rows_plain(table, idx)):
            raise AssertionError(f"gather_rows {variant} differs from plain")
        rec("gather_rows", variant, 0.0,
            lambda: gather.gather_rows(table, idx),
            lambda: gather.gather_rows_plain(table, idx),
            lambda: torch.index_select(table, 0, idx64),
            2 * N * C * 4 + N * 4, 0, "fp32",
            f"{probe}:38 (variant_a, pallas_call :43) and :52 (variant_b, "
            "pallas_call :67); mast3r_slam_tpu/slam/ba.py:72 "
            "(_gather_points, XLA)",
            "mast3r_slam_tpu_torch/csrc/gather_rows.cu")

    # 5. take_along: the probe's shape (axis 0), the edge gate's (axis 1),
    # one problem a launch; then the gate's two directions in one launch,
    # on uniform random indices and on the match indices of an edge (the
    # oracle's two views matched both ways at base settings), whose
    # neighbouring pixels gather neighbouring values as on the main path
    tag = (f"{probe}:76 (variant_c, pallas_call :83); "
           "mast3r_slam_tpu/slam/factor_graph.py:117 (_gate_edges, XLA)")
    src = "mast3r_slam_tpu_torch/csrc/take_along.cu"
    for variant, axis, tshape in (("probe (1024,128) axis 0", 0, (1024, 128)),
                                  ("gate (2,196608) axis 1", 1, (2, n))):
        t = f32(rng.standard_normal(tshape))
        idx = i32(rng.integers(0, tshape[axis], tshape))
        idx64 = idx.long()
        got = gather.take_along(t, idx, axis)
        if not torch.equal(got, gather.take_along_plain(t, idx, axis)):
            raise AssertionError(f"take_along {variant} differs from plain")
        tot = tshape[0] * tshape[1]
        rec("take_along", variant, 0.0,
            lambda: gather.take_along(t, idx, axis),
            lambda: gather.take_along_plain(t, idx, axis),
            lambda: torch.take_along_dim(t, idx64, dim=axis),
            tot * 12, 0, "fp32", tag, src)
    mcfg = make_matching_config(base_config())._asdict()
    edge_idx, _ = matching.match(X, X.flip(0).contiguous(), D,
                                 D.flip(0).contiguous(), **mcfg)
    edge_idx = edge_idx.to(torch.int32).contiguous()
    for variant, (i0, i1) in (
            ("gate pair 2 x (2,196608) axis 1, uniform random indices",
             (i32(rng.integers(0, n, (2, n))),
              i32(rng.integers(0, n, (2, n))))),
            ("gate pair 2 x (2,196608) axis 1, an edge's match indices",
             (edge_idx, edge_idx.flip(0).contiguous()))):
        t0, t1 = f32(rng.uniform(1, 4, (2, n))), f32(rng.uniform(1, 4, (2, n)))
        l0, l1 = i0.long(), i1.long()
        got = gather.take_along_pair(t0, i0, t1, i1, 1)
        ref = gather.take_along_pair_plain(t0, i0, t1, i1, 1)
        lib = (torch.take_along_dim(t0, l0, dim=1),
               torch.take_along_dim(t1, l1, dim=1))
        if not all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(got, ref, lib)):
            raise AssertionError(f"take_along {variant} differs from plain "
                                 "or from torch.take_along_dim")
        rec("take_along", variant, 0.0,
            lambda: gather.take_along_pair(t0, i0, t1, i1, 1),
            lambda: gather.take_along_pair_plain(t0, i0, t1, i1, 1),
            lambda: (torch.take_along_dim(t0, l0, dim=1),
                     torch.take_along_dim(t1, l1, dim=1)),
            2 * 2 * n * 12, 0, "fp32", tag, src,
            library_call="two torch.take_along_dim calls",
            two_single_calls_ms=device_ms(
                lambda: (gather.take_along(t0, i0, 1),
                         gather.take_along(t1, i1, 1))))

    def rel_err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # 6. gn_step: both modes at N = 196,608 on the oracle's two views
    Xf = X[0].reshape(n, 3).contiguous()
    Xk = X[1].reshape(n, 3).contiguous()
    h, w = X.shape[1], X.shape[2]
    T = sim3.exp(f32([0.01, -0.02, 0.01, 0.004, -0.003, 0.002, 0.01]))
    Qk = f32(rng.uniform(1.0, 4.0, n)) * f32(rng.random(n) > 0.1)
    tcfg = tracker.TrackerConfig()
    for mode in ("ray_dist", "calib"):
        if mode == "ray_dist":
            proj = None
            si = torch.stack([Qk / tcfg.sigma_ray] * 3
                             + [Qk / tcfg.sigma_dist])
            tgt, _, _ = tracker._ray_dist_t(Xk.T)
        else:
            proj = tracker.CalibProj(0.8 * w, 0.8 * w, w / 2.0, h / 2.0, w,
                                     h, tcfg.pixel_border, tcfg.depth_eps)
            K = f32([[proj.fx, 0, proj.cx], [0, proj.fy, proj.cy], [0, 0, 1]])
            si = torch.stack([Qk / tcfg.sigma_pixel] * 2
                             + [Qk / tcfg.sigma_depth])
            meas, _ = tracker.calib_measurements(Xk, K, (h, w),
                                                 tcfg.depth_eps)
            tgt = meas.T
        tgt, si = tgt.contiguous(), si.contiguous()
        d = tgt.shape[0]
        a = tracker.gn_step(T, Xf, tgt, si, tcfg.huber, proj)
        b = tracker.gn_step(T, Xf, tgt, si, tcfg.huber, proj)
        ref = tracker.gn_step_plain(T, Xf, tgt, si, tcfg.huber, proj)
        errs = [rel_err(a[sl], ref[sl]) for sl in
                (slice(0, 49), slice(49, 56), slice(56, 57))]
        if not (torch.equal(a, b) and max(errs) <= 1e-5):
            raise AssertionError(f"gn_step {mode}: rel err H/g/cost {errs}, "
                                 f"two calls equal: {torch.equal(a, b)}")
        rec("gn_step", f"{mode} N={n} one linearization (one iteration)",
            float((a - ref).abs().max()),
            lambda: tracker.gn_step(T, Xf, tgt, si, tcfg.huber, proj),
            lambda: tracker.gn_step_plain(T, Xf, tgt, si, tcfg.huber, proj),
            None, n * (12 + 8 * d) + 57 * 4 + 32,
            # FLOP per row: residual + weight ~25, A (7), A A^T (56), g (14)
            n * (40 + d * 105), "fp32",
            "mast3r_slam_tpu/slam/tracker.py:60 (_gn_step_t with _act_t, "
            "_ray_dist_t and the pose Jacobians, XLA)",
            "mast3r_slam_tpu_torch/csrc/gn_step.cu",
            tolerance="1e-5 of the largest entry of each of H, g, cost",
            ref_max_abs=float(ref.abs().max()), max_rel_err=max(errs),
            two_calls_bit_equal=True,
            bound_ms_fp32_nofma=n * (40 + d * 105) / FP32_NOFMA * 1e3)
        check_gn_solve(rec, rel_err, mode, Xk, tgt, si, proj, tcfg, d, n)

    check_edge_system(rec, rel_err, rng, n, h, w)
    solver_scaling(lambda r: log("solver scaling", json.dumps(r)))


def check_gn_solve(rec, rel_err, mode, Xk, tgt, si, proj, tcfg, d, n):
    """The fused solve (one launch of ``gn_step``: every iteration on the
    device) against ``gn_solve_plain`` at N = 196,608: frame points that
    the true pose maps onto the keyframe's, plus noise and outliers, so the
    solve converges; the same with no valid match (fails in 1 iteration);
    and with both thresholds at 0 (runs to ``max_iters``)."""
    import torch

    from mast3r_slam_tpu_torch import geometry
    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam import tracker

    if proj is not None:    # the calibrated tracker's points lie on rays
        K = torch.tensor([[proj.fx, 0, proj.cx], [0, proj.fy, proj.cy],
                          [0, 0, 1.0]], device="cuda")
        Xk = geometry.constrain_points_to_ray((proj.h, proj.w), Xk, K)
    g = torch.Generator(device="cuda").manual_seed(11)
    T_true = sim3.exp(torch.tensor([0.02, -0.01, 0.015, 0.006, -0.004, 0.003,
                                    0.008], device="cuda"))
    Xf = sim3.act(sim3.inv(T_true), Xk)
    Xf = Xf + 0.002 * torch.randn(Xf.shape, generator=g, device="cuda")
    bad = torch.rand(n, generator=g, device="cuda") < 0.03
    Xf = torch.where(bad[:, None], Xf + torch.randn(
        Xf.shape, generator=g, device="cuda"), Xf).contiguous()
    T0 = sim3.identity(device="cuda")
    cases = {"converges": (si, tcfg),
             "no_valid_match": (torch.zeros_like(si), tcfg),
             "max_iters": (si, tcfg._replace(max_iters=8, rel_error=0.0,
                                             delta_norm=0.0))}
    for case, (s, cfg) in cases.items():
        a = tracker.gn_solve(T0, Xf, tgt, s, cfg, proj)
        b = tracker.gn_solve(T0, Xf, tgt, s, cfg, proj)
        ref = tracker.gn_solve_plain(T0, Xf, tgt, s, cfg, proj)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        it, it_ref = int(a.iters), int(ref.iters)
        t_err = float((a.T_CkCf - ref.T_CkCf).abs().max())
        c_err = abs(float(a.cost) - float(ref.cost)) / max(
            abs(float(ref.cost)), 1e-30)
        expect = {"converges": 1 < it < cfg.max_iters and not bool(a.failed),
                  "no_valid_match": it == 1 and bool(a.failed),
                  "max_iters": it == cfg.max_iters and not bool(a.failed)}
        if not (same and it == it_ref and bool(a.failed) == bool(ref.failed)
                and t_err <= 2e-5 and c_err <= 1e-5 and expect[case]):
            raise AssertionError(
                f"gn_step solve {mode} {case}: iters {it} / plain {it_ref}, "
                f"failed {bool(a.failed)} / {bool(ref.failed)}, pose err "
                f"{t_err}, cost rel err {c_err}, two calls equal {same}")
        log(f"gn_step solve {mode} {case}: {it} iterations as the plain "
            f"loop, failed {bool(a.failed)}, pose err {t_err:.3g}, cost rel "
            f"err {c_err:.3g}, two calls bit-equal")
        if case == "no_valid_match":
            continue
        ops = it * n * (40 + d * 105)
        rec("gn_step", f"{mode} N={n} whole solve, {case} ({it} iterations)",
            t_err, lambda: tracker.gn_solve(T0, Xf, tgt, s, cfg, proj),
            lambda: tracker.gn_solve_plain(T0, Xf, tgt, s, cfg, proj), None,
            # inputs read once (the frame stays in L2 between iterations)
            n * (12 + 8 * d) + 66 * 4 + 32, ops, "fp32",
            "mast3r_slam_tpu/slam/tracker.py:171 (_run_gn: lax.while_loop "
            "of _gn_step_t :60, _solve7 :81, sim3.retr, robust.converged)",
            "mast3r_slam_tpu_torch/csrc/gn_step.cu", plain_reps=3,
            tolerance="iterations and failed equal to the plain loop's, pose "
            "within 2e-5, cost within 1e-5 relative, two calls bit-equal",
            iterations=it, cost_rel_err=c_err,
            bound_ms_fp32_nofma=ops / FP32_NOFMA * 1e3)


BA_REPLACES = ("mast3r_slam_tpu/slam/ba.py:203 (_edge_terms with "
               "_edge_terms_rays :320, _calib :358, _points :340) and :394 "
               "(_assemble), XLA")


def check_edge_system(rec, rel_err, rng, n, h, w):
    """The fused BA system (one launch of ``ba_edge_terms``: edge terms,
    conjugation and assembly) against ``edge_system_plain`` in three modes
    at E = 8, every 4th and every point, and at the loop run's final size
    (9 keyframes, 42 edges, every 4th point, rays); the raw per-edge sums
    (``ba.ba_edge_terms``) against ``ba_edge_terms_plain``."""
    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam import ba

    dev = "cuda"
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    calib = ba.CalibArgs(0.8 * w, 0.8 * w, w / 2.0, h / 2.0, w, h)

    def problem(n_kf, ii, jj):
        E = len(ii)
        v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        Xs = []
        for k in range(n_kf):
            z = 3.0 + 0.5 * np.sin(u / 40.0 + k) + 0.01 * rng.standard_normal(
                u.shape)
            Xs.append(np.stack([(u - w / 2) / (0.8 * w) * z,
                                (v - h / 2) / (0.8 * w) * z, z],
                               -1).reshape(n, 3))
        idx = i32(np.clip(np.arange(n)[None] + rng.integers(-3, 4, (E, n)),
                          0, n - 1))
        valid = torch.from_numpy(rng.random((E, n)) > 0.1).to(dev)
        mask = torch.ones(E, device=dev)
        mask[5] = 0.0
        return (sim3.exp(f32(0.02 * rng.standard_normal((n_kf, 7)))),
                f32(np.stack(Xs)), f32(rng.uniform(-0.3, 5.0, (n_kf, n))),
                i32(ii), i32(jj), idx, valid,
                f32(rng.uniform(1.0, 4.5, (E, n))), mask)

    sq = [0, 1, 1, 2, 2, 3, 0, 3], [1, 0, 2, 1, 3, 2, 3, 0]
    pairs = [(a, a + 1) for a in range(8)] + [
        (a, b) for a in range(9) for b in range(a + 2, 9)][:13]
    loop = ([a for p in pairs for a in p], [a for p in pairs for a in p[::-1]])
    cells = [(m, s, 4, sq) for s in (4, 1) for m in ba.MODES] + [
        ("rays", 4, 9, loop)]
    made = {}
    for mode, stride, n_kf, (ii, jj) in cells:
        if n_kf not in made:
            made[n_kf] = problem(n_kf, ii, jj)
        T, Xs, Cs, ii_t, jj_t, idx, valid, Q, mask = made[n_kf]
        E = ii_t.shape[0]
        cfg = ba.BAConfig(point_stride=stride)
        cal = calib if mode == "calib" else None
        pre = ba._edge_prep(Xs, Cs, ii_t, jj_t, idx, valid, stride)
        wq = ba._edge_weights(pre, valid, Q, cfg, stride)
        Pp = pre.safe_idx.shape[1]
        n_kf_act, pin = n_kf - 1, 1          # the last slot inactive
        plan = ba._assembly_plan(ii_t, jj_t, n_kf_act, n_kf, pin)
        args = (mode, T, Xs, Cs, ii_t, jj_t, idx, valid, Q, mask, n_kf_act,
                n_kf, pin, cfg, pre, cal, wq, plan)
        got = ba._edge_system(*args)
        again = ba._edge_system(*args)
        ref = ba.edge_system_plain(mode, T, Xs, Cs, ii_t, jj_t, idx, valid,
                                   Q, mask, n_kf_act, n_kf, pin, cfg, pre,
                                   cal)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = [rel_err(a, r) for a, r in zip(got, ref)]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        if not (same and finite and max(errs) <= 1e-5
                and float(got[0][5].abs().max()) == 0.0):
            raise AssertionError(
                f"ba_edge_terms system {mode} stride {stride} E={E}: rel err "
                f"H/g/Hd/gd {errs}, two calls equal: {same}, finite {finite}")
        if E == 8:
            # the per-edge sums alone, for given Tij
            Tij = sim3.rel(T[ii_t.long()], T[jj_t.long()]).contiguous()
            raw = (mode, Tij, pre, valid, Q, mask, stride, cfg, cal)
            S, g0 = ba.ba_edge_terms(*raw)
            Sp, gp = ba.ba_edge_terms_plain(*raw)
            e_raw = max(rel_err(S, Sp), rel_err(g0, gp))
            if not e_raw <= 1e-5:
                raise AssertionError(f"ba_edge_terms sums {mode} stride "
                                     f"{stride}: rel err {e_raw}")
        nr = 4 if mode == "rays" else 3
        plain = (lambda: ba.edge_system_plain(
            mode, T, Xs, Cs, ii_t, jj_t, idx, valid, Q, mask, n_kf_act, n_kf,
            pin, cfg, pre, cal))
        rec("ba_edge_terms", f"{mode} E={E} P={Pp} (stride {stride}), terms "
            f"+ conjugation + assembly, K={n_kf}",
            float(max((a - r).abs().max() for a, r in zip(got, ref))),
            lambda: ba._edge_system(*args), plain, None,
            E * Pp * (36 + (4 if mode == "calib" else 0))
            + n_kf * 32 + E * (12 + 210 * 4) + (49 * n_kf * n_kf + 7 * n_kf)
            * 4,
            E * Pp * (60 + nr * 105), "fp32", BA_REPLACES,
            "mast3r_slam_tpu_torch/csrc/ba_edge_terms.cu", plain_reps=3,
            tolerance="1e-5 of the largest entry of each of the edge blocks, "
            "edge gradients, Hd and gd; two calls bit-equal; the masked edge "
            "zero",
            ref_max_abs=float(ref[2].abs().max()), max_rel_err=max(errs),
            two_calls_bit_equal=True, edges=E,
            bound_ms_fp32_nofma=E * Pp * (60 + nr * 105) / FP32_NOFMA * 1e3)


def graph_args(system):
    """The BA problem of a run's final factor graph as its global solve
    hands it to the kernel, at the solve's keyframe and edge buckets:
    (T_WC, Xs, Cs, ii, jj, idx, valid, Q, mask, n_kf, K, cfg)."""
    fg, kfs = system.factor_graph, system.keyframes
    Kb, (ii, jj, idx, vm, Q, mask, n_kf) = fg._solve_args()
    return (kfs.T_WC[:Kb].contiguous(), kfs.X[:Kb], kfs.average_confs(Kb),
            ii, jj, idx, vm, Q, mask, n_kf, Kb, fg.ba_cfg)


def check_graph(graph, rec=None, variant=None):
    """The fused BA system on a BA problem (``graph_args``: a run's final
    factor graph with its real edges, matches and confidences, or a
    synthetic graph) against ``edge_system_plain``, at the poses given
    (for a run's graph those BA converged to) and with the free poses moved
    off them, and both against ``edge_system_plain`` on float64 copies of
    the same inputs. At an optimum the gradients are sums of terms that
    cancel, so at the given poses only the Hessians are held to 1e-5 of
    their largest entry; off them all four outputs are. In both, each of
    the kernel's four outputs must be as close to the float64 system as 4x
    the plain fp32 version's distance to it, or within 1e-6 of its largest
    entry. With ``rec``, the moved system's kernel and plain version are
    timed into a kernel record of ``variant``, its bound counted from the
    live edges and their points of nonzero weight."""
    import torch

    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam import ba

    T0, Xs, Cs, ii, jj, idx, vm, Q, mask, n_kf, Kb, cfg = graph
    T0 = T0.contiguous()
    pre = ba._edge_prep(Xs, Cs, ii, jj, idx, vm, cfg.point_stride)
    wq = ba._edge_weights(pre, vm, Q, cfg, cfg.point_stride)
    plan = ba._assembly_plan(ii, jj, n_kf, Kb, cfg.pin)
    pre64 = ba.EdgePre(pre.XCi.double(), pre.XCj.double(), pre.safe_idx)
    g = torch.Generator(device="cuda").manual_seed(3)
    xi = 0.01 * torch.randn((Kb, 7), generator=g, device="cuda")
    xi[:cfg.pin] = 0.0
    out = {"edges": int(ii.shape[0]), "keyframes": Kb}
    dist = lambda a, r: float((a.double() - r.double()).abs().max())
    for label, T in (("given", T0),
                     ("moved", sim3.retr(T0, xi).contiguous())):
        args = ("rays", T, Xs, Cs, ii, jj, idx, vm, Q, mask, n_kf, Kb,
                cfg.pin, cfg, pre, None, wq, plan)
        got, again = ba._edge_system(*args), ba._edge_system(*args)
        ref = ba.edge_system_plain("rays", T, Xs, Cs, ii, jj, idx, vm, Q,
                                   mask, n_kf, Kb, cfg.pin, cfg, pre)
        ref64 = ba.edge_system_plain("rays", T.double(), Xs, Cs, ii, jj, idx,
                                     vm, Q.double(), mask.double(), n_kf, Kb,
                                     cfg.pin, cfg, pre64)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        diff = [dist(a, r) for a, r in zip(got, ref)]
        scale = [float(r.abs().max()) for r in ref]
        rel = [d / max(s, 1e-30) for d, s in zip(diff, scale)]
        held = rel if label == "moved" else rel[0::2]
        d_kernel = [dist(a, r) for a, r in zip(got, ref64)]
        d_plain = [dist(a, r) for a, r in zip(ref, ref64)]
        scale64 = [float(r.abs().max()) for r in ref64]
        near64 = all(dk <= max(4.0 * dp, 1e-6 * s) for dk, dp, s in
                     zip(d_kernel, d_plain, scale64))
        if not (same and max(held) <= 1e-5 and near64):
            raise AssertionError(
                f"ba_edge_terms on the graph ({label}, E={ii.shape[0]}, "
                f"K={Kb}): rel err H/g/Hd/gd {rel}, distance to the "
                f"float64 system {d_kernel} (plain fp32 {d_plain}, largest "
                f"entry {scale64}), two calls equal {same}")
        out[label] = {"max_abs_diff": diff, "max_abs_ref": scale,
                      "rel_err": rel, "two_calls_bit_equal": same,
                      "fp64_dist_kernel": d_kernel,
                      "fp64_dist_plain": d_plain, "fp64_max_abs": scale64}
    if rec is not None:
        live = mask > 0
        E_live = int(live.sum())
        Pp = pre.safe_idx.shape[1]
        n_valid = int((wq[live] > 0).sum())     # the points that weigh
        ops = n_valid * (60 + 4 * 105)
        rec("ba_edge_terms", f"{variant}: rays E={ii.shape[0]} ({E_live} "
            f"live) P={Pp} (stride {cfg.point_stride}), terms + conjugation "
            f"+ assembly, K={Kb} ({n_kf} keyframes)",
            max(max(out[k]["max_abs_diff"]) for k in ("given", "moved")),
            lambda: ba._edge_system(*args),
            lambda: ba.edge_system_plain(
                "rays", T, Xs, Cs, ii, jj, idx, vm, Q, mask, n_kf, Kb,
                cfg.pin, cfg, pre), None,
            E_live * Pp * 36 + Kb * 32 + E_live * (12 + 210 * 4)
            + (49 * Kb * Kb + 7 * Kb) * 4, ops, "fp32", BA_REPLACES,
            "mast3r_slam_tpu_torch/csrc/ba_edge_terms.cu", plain_reps=3,
            tolerance="the Hessians at the given poses, all four outputs "
            "moved off them, within 1e-5 of their largest entry; within "
            "max(4x the plain fp32 distance, 1e-6 of the largest entry) of "
            "the float64 system; two calls bit-equal",
            edges=int(ii.shape[0]), live_edges=E_live, weighted_points=n_valid,
            two_calls_bit_equal=True,
            bound_ms_fp32_nofma=ops / FP32_NOFMA * 1e3)
    return out


def solver_scaling(rec_log):
    """Where the two fused solver kernels spend their device time, and how
    the BA kernel scales with the graph. ``gn_step``: device time per
    iteration of 8 (both thresholds 0) and of one linearization at N = 256
    (the fixed per-iteration cost: barriers, block 0's slot sums, the
    one-thread solve and retraction) and N = 196,608. ``ba_edge_terms`` at
    4, 9, 64, 128 and 256 keyframes with two-way edges (consecutive ones,
    then random loop closures; from 64 keyframes on about 4.7 edges a
    keyframe, the loop run's ratio, so 256 keyframes give 1,204 edges):
    held against ``edge_system_plain`` on every 64th point (1e-5 of the
    largest entry, bit-equal across calls), then timed on every 1,024th
    point (the serial tail) and on every 4th (the loop run's stride),
    against the terms-then-assemble path that it replaced (the per-edge
    sums, the conjugation in PyTorch and ``ba._assemble``'s
    ``index_put_``). Seeded synthetic scenes."""
    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.slam import ba, tracker

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    n_max = 196608
    Xk = torch.randn((n_max, 3), generator=g, device=dev) * torch.tensor(
        [1.0, 0.7, 0.3], device=dev) + torch.tensor([0.0, 0.0, 4.0],
                                                    device=dev)
    T_true = sim3.exp(torch.tensor([0.02, -0.01, 0.015, 0.006, -0.004, 0.003,
                                    0.008], device=dev))
    Xf = (sim3.act(sim3.inv(T_true), Xk)
          + 0.002 * torch.randn(Xk.shape, generator=g, device=dev))
    Qn = 1.0 + 3.0 * torch.rand(n_max, generator=g, device=dev)
    tcfg = tracker.TrackerConfig()
    si_all = torch.stack([Qn / tcfg.sigma_ray] * 3 + [Qn / tcfg.sigma_dist])
    tgt_all = tracker._ray_dist_t(Xk.T)[0]
    T0 = sim3.identity(device=dev)
    fixed = tcfg._replace(max_iters=8, rel_error=0.0, delta_norm=0.0)
    for n in (256, n_max):
        Xn = Xf[:n].contiguous()
        tgt = tgt_all[:, :n].contiguous()
        si = si_all[:, :n].contiguous()
        it8 = device_ms(lambda: tracker.gn_solve(T0, Xn, tgt, si, fixed))
        it1 = device_ms(lambda: tracker.gn_step(T0, Xn, tgt, si, tcfg.huber))
        rec_log({"kernel": "gn_step", "N": n, "ms_per_iteration_of_8": it8 / 8,
                 "ms_one_linearization": it1})
    del Xk, Xf, Qn, si_all, tgt_all

    rng = np.random.default_rng(5)
    P = n_max
    for n_kf, E in ((4, 8), (9, 42), (64, 300), (128, 602), (256, 1204)):
        pairs = [(k, k + 1) for k in range(n_kf - 1)][:E // 2]
        while len(pairs) < E // 2:
            a, b = (int(v) for v in rng.integers(0, n_kf, 2))
            if abs(a - b) >= 2:
                pairs.append((a, b))
        ii = torch.tensor([a for p in pairs for a in p], dtype=torch.int32,
                          device=dev)
        jj = torch.tensor([a for p in pairs for a in p[::-1]],
                          dtype=torch.int32, device=dev)
        Ts = sim3.exp(0.02 * torch.randn((n_kf, 7), generator=g, device=dev))
        Xs = (torch.randn((n_kf, P, 3), generator=g, device=dev) * 0.5
              + torch.tensor([0.0, 0.0, 3.0], device=dev))
        Cs = 5.0 * torch.rand((n_kf, P), generator=g, device=dev)
        idx = torch.randint(0, P, (E, P), generator=g, device=dev,
                            dtype=torch.int32)
        valid = torch.rand((E, P), generator=g, device=dev) > 0.1
        Qe = 1.0 + 3.0 * torch.rand((E, P), generator=g, device=dev)
        mask = torch.ones(E, device=dev)
        pin = 1
        out = {"kernel": "ba_edge_terms", "K": n_kf, "E": E}
        for stride in (64, 1024, 4):
            bcfg = ba.BAConfig(point_stride=stride)
            pre = ba._edge_prep(Xs, Cs, ii, jj, idx, valid, stride)
            wq = ba._edge_weights(pre, valid, Qe, bcfg, stride)
            plan = ba._assembly_plan(ii, jj, n_kf, n_kf, pin)
            fused = lambda: ba.edge_system("rays", Ts, pre, wq, ii, jj, mask,
                                           n_kf, n_kf, pin, bcfg, None, plan)
            Pp = pre.safe_idx.shape[1]
            if stride == 64:
                got, again = fused(), fused()
                ref = ba.edge_system_plain("rays", Ts, Xs, Cs, ii, jj, idx,
                                           valid, Qe, mask, n_kf, n_kf, pin,
                                           bcfg, pre)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                errs = [float((a - r).abs().max() / r.abs().max())
                        for a, r in zip(got, ref)]
                if not (same and max(errs) <= 1e-5):
                    raise AssertionError(
                        f"ba_edge_terms K={n_kf} E={E}: rel err H/g/Hd/gd "
                        f"{errs}, two calls equal {same}")
                out["rel_err_vs_plain"] = errs
                continue

            def terms(mode, Tij, pre_, *_):
                return ba._launch(mode, Tij, None, None, pre_, wq, mask, bcfg,
                                  None)

            replaced = lambda: ba._assemble(*ba._edge_terms(
                "rays", Ts, Xs, Cs, ii, jj, idx, valid, Qe, mask, bcfg, pre,
                None, terms), ii, jj, n_kf, n_kf, pin)
            out[f"P={Pp}"] = {
                "fused_device_ms": device_ms(fused, reps=10),
                "fused_call_ms": time_ms(fused, reps=10),
                "replaced_device_ms": device_ms(replaced, reps=10),
                "replaced_call_ms": time_ms(replaced, reps=10)}
        rec_log(out)
        del Xs, Cs, idx, valid, Qe, pre, wq, plan


# -- phase 3: main path --------------------------------------------------------


def run_slam(preset_cfg, params, model_cfg, n_frames, kf_every, K=None,
             retrieval_params=None, edge_capacity=EDGE_CAPACITY,
             reinit_after=0, fused=True, runtime=None, parallel=None,
             **system_kw):
    """Drive ``n_frames`` through make_frame / process_frame and drain the
    backend after every frame, as ``SLAMSystem.run`` of the JAX package
    does; with retrieval, ``backend_prefetch()`` comes before every frame.
    Returns the system, the per-frame frontend wall times and one (wall ms,
    GN iterations, keyframes, edges on the device) per backend step (each
    time ends in a sync). ``fused=False``: the step-by-step tracker.
    ``runtime`` / ``parallel``: keys set in those config sections;
    ``system_kw``: ``SLAMSystem``'s ``mesh`` and ``local_devices``."""
    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.models import oracle_timing
    from mast3r_slam_tpu_torch.slam.system import SLAMSystem
    from mast3r_slam_tpu_torch.utils.metrics import Metrics
    from mast3r_slam_tpu_torch.utils import timing

    cfg = preset_cfg
    cfg["tracking"] = dict(cfg["tracking"], kf_every=kf_every)
    cfg["reloc"] = dict(cfg["reloc"], reinit_after=reinit_after)
    cfg["use_calib"] = K is not None
    cfg["runtime"] = dict(cfg["runtime"], **(runtime or {}))
    cfg["parallel"] = dict(cfg.get("parallel", {}), **(parallel or {}))
    h, w = model_cfg.img_size
    system = SLAMSystem(params, model_cfg, cfg, (h, w), K=K,
                        retrieval_params=retrieval_params,
                        keyframe_capacity=16, edge_capacity=edge_capacity,
                        model_module=oracle_timing, device="cuda",
                        metrics=Metrics(), **system_kw)
    system.tracker.fused = fused
    rng = np.random.default_rng(1234)
    frames = [oracle_timing.make_frame_image(i, h, w, rng)
              for i in range(n_frames)]
    times, backend = [], []
    iters = 0           # GN iterations of the newest solve
    for i in range(n_frames):
        t0 = time.perf_counter()
        system.backend_prefetch()
        system.process_frame(system.make_frame(i, frames[i]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times.append((t1 - t0) * 1e3)
        while True:
            with timing.recording() as rec:
                if not system.backend_step():
                    break
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            iters = last_solve(rec).get("iters", iters)
            backend.append(((t2 - t1) * 1e3, iters, len(system.keyframes),
                            int(system.factor_graph.n_edges_dev)))
            t1 = t2
    return system, times, backend


def last_solve(rec):
    """The attributes of the last BA solve recorded by ``rec`` (a
    ``timing.recording``), or {}."""
    solves = [s for s in rec.spans if s.name == "ba.solve"]
    return solves[-1].attrs if solves else {}


def assert_healthy(system, n_frames, kf_every, traj, label,
                   end_mode="TRACKING"):
    """Health of a run that must track every frame. Without retrieval the
    graph holds exactly the consecutive edges; with it, loop closures must
    have been found and kept as edges on top of those. ``run()`` ends in
    ``TERMINATED``."""
    from mast3r_slam_tpu_torch.eval.ate import aligned_rmse
    from mast3r_slam_tpu_torch.slam.frame import Mode

    st = system.stats
    fg = system.factor_graph
    problems = []
    system.check_invariants()      # flushes the deferred edge gates
    expect_kf = len(range(0, n_frames, kf_every))
    consec = 2 * (expect_kf - 1)
    if st["keyframes"] != expect_kf:
        problems.append(f"keyframes {st['keyframes']} != {expect_kf}")
    if int(fg.n_edges_dev) != fg.n_edges:
        problems.append(f"edges {fg.n_edges} != device {int(fg.n_edges_dev)}")
    if system.retrieval is None and fg.n_edges != consec:
        problems.append(f"edges {fg.n_edges} != {consec}")
    if system.retrieval is not None:
        if st["loop_closures"] <= 0 or fg.n_edges <= consec:
            problems.append(f"no loop closure kept: {st['loop_closures']} "
                            f"found, edges {fg.n_edges} vs {consec} "
                            "consecutive")
        if system.retrieval.native is None or system._retrieval_prefetch:
            problems.append("retrieval did not run on the native IVF with "
                            "every prefetch consumed")
    if fg.edges_dropped:
        problems.append(f"{fg.edges_dropped} edges dropped")
    if system.backend_queue:
        problems.append(f"backend queue not drained: {system.backend_queue}")
    if st["skipped"] or st["frames_reloc"]:
        problems.append(f"skipped/reloc: {st}")
    if system.mode != Mode[end_mode]:
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


def assert_teleport(system, label, expect):
    """``expect``: stat -> (comparison, value) and the end mode."""
    import operator

    from mast3r_slam_tpu_torch.slam.frame import Mode

    system.check_invariants()
    st, problems = system.stats, []
    ops = {"==": operator.eq, ">=": operator.ge}
    for key, (op, val) in expect["stats"].items():
        if not ops[op](st[key], val):
            problems.append(f"{key} {st[key]} not {op} {val}")
    if system.mode != Mode[expect["mode"]]:
        problems.append(f"end mode {system.mode}, expected {expect['mode']}")
    if system.factor_graph.edges_dropped or system.backend_queue:
        problems.append("dropped edges or an undrained backend queue")
    events = [r["event"] for r in system.metrics.rows]
    for ev, key in (("reloc_failed", "reloc_failed"), ("reinit", "reinits")):
        if events.count(ev) != st[key]:
            problems.append(f"{events.count(ev)} {ev} events for "
                            f"{st[key]} counted")
    if problems:
        raise AssertionError(f"unhealthy {label} run: " + "; ".join(problems)
                             + f"; stats {st}")


def check_oracle_gn(params, model_cfg, mcfg, tcfg):
    """The tracker's solve on one oracle frame (frame 1 against keyframe
    0, through the network, the matcher and the gate as the path runs
    them) held to ``tracker.gn_solve_plain``: equal iterations and failed
    flags, pose within 2e-5; and where that solve waits for the device."""
    import torch

    from mast3r_slam_tpu_torch.lie import sim3
    from mast3r_slam_tpu_torch.models import oracle_timing
    from mast3r_slam_tpu_torch.ops import matching
    from mast3r_slam_tpu_torch.slam import system as sysmod
    from mast3r_slam_tpu_torch.slam import tracker

    h, w = model_cfg.img_size
    imgs = [torch.from_numpy(oracle_timing.make_frame_image(i, h, w))
            .cuda()[None] for i in (0, 1)]
    fk, pk = oracle_timing.encode(params, imgs[0], model_cfg)
    ff, pf = oracle_timing.encode(params, imgs[1], model_cfg)
    fk = fk.to(torch.bfloat16)           # as the keyframe store keeps it
    X, C, D, Q = oracle_timing.inference_asymmetric(params, ff, pf, fk, pk,
                                                    model_cfg)
    idx, valid = matching.match(X[0:1], X[1:2], D[0:1], D[1:2],
                                **mcfg._asdict())
    idx, valid = idx[0], valid[0]
    n = h * w
    Xf, Qf, Cf = X[0].reshape(n, 3), Q[0].reshape(n, 1), C[0].reshape(n, 1)
    Xk = X[1].reshape(n, 3)          # keyframe map, here in the frame's coords
    Qk, valid_opt, _ = sysmod._track_gate_pre(
        idx, valid, Qf[idx], Q[1].reshape(n, 1), Cf[idx], Cf, tcfg.C_conf,
        tcfg.Q_conf)
    T0 = sim3.identity(device="cuda")
    res = tracker.opt_pose_ray_dist_sim3(Xf[idx], Xk, T0, Qk, valid_opt, tcfg)
    # the same frame through the plain loop: equal iterations and flags
    sQ = (torch.sqrt(Qk) * valid_opt)[:, 0]
    si = torch.stack([sQ / tcfg.sigma_ray] * 3 + [sQ / tcfg.sigma_dist])
    ref = tracker.gn_solve_plain(
        T0, Xf[idx].contiguous(), tracker._ray_dist_t(Xk.T)[0].contiguous(),
        si, tcfg)
    err = float((res.T_CkCf - ref.T_CkCf).abs().max())
    if (int(ref.iters) != int(res.iters) or bool(ref.failed) != bool(
            res.failed) or not err <= 2e-5):
        raise AssertionError(f"gn_step on the oracle frame: {int(res.iters)} "
                             f"iterations / plain {int(ref.iters)}, failed "
                             f"{bool(res.failed)} / {bool(ref.failed)}, pose "
                             f"err {err}")
    return {"gn_iters": int(res.iters), "gn_pose_err_vs_plain": err,
            "gn_host_syncs_at": host_syncs_of(
                lambda: tracker.opt_pose_ray_dist_sim3(Xf[idx], Xk, T0, Qk,
                                                       valid_opt, tcfg))}


def host_syncs_of(fn):
    """Where one ``fn()`` call waited for the device: "file:line" of each
    synchronizing call (``.item()``, ``.cpu()``, ``bool()`` of a CUDA
    tensor, ...), as PyTorch's sync debug mode reports them; a sync inside
    a library also names the innermost line of this repository that led to
    it ("library:line via repo:line")."""
    import pathlib
    import traceback
    import warnings

    import torch

    repo = pathlib.Path(__file__).resolve().parent
    found = []

    def where(message, category, filename, lineno, *rest):
        if "synchroniz" not in str(message):
            return
        at = f"{pathlib.Path(filename).name}:{lineno}"
        ours = [f for f in traceback.extract_stack()
                if pathlib.Path(f.filename).resolve().is_relative_to(repo)
                and pathlib.Path(f.filename).name != "chip_smoke.py"]
        if ours and not pathlib.Path(filename).resolve().is_relative_to(repo):
            at += f" via {pathlib.Path(ours[-1].filename).name}:{ours[-1].lineno}"
        found.append(at)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # the first switch to "warn" in a process reports the switch itself
        # as a sync: not one of fn's
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.simplefilter("always")
        warnings.showwarning = where
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def host_syncs(system, frame_id, image):
    """Host syncs of one more tracked frame, in ``make_frame`` and in
    ``process_frame``."""
    box = {}
    made = host_syncs_of(
        lambda: box.setdefault("frame", system.make_frame(frame_id, image)))
    done = host_syncs_of(lambda: system.process_frame(box["frame"]))
    return {"make_frame": len(made), "make_frame_at": made,
            "process_frame": len(done), "process_frame_at": done}


def write_frames(directory, n_frames, h, w):
    """``run_slam``'s frames as PNG files (lossless: the frame id in two
    pixels survives, and ``resize_img`` at the working size keeps every
    pixel)."""
    import numpy as np
    import PIL.Image

    from mast3r_slam_tpu_torch.models import oracle_timing

    rng = np.random.default_rng(1234)
    for i in range(n_frames):
        PIL.Image.fromarray(oracle_timing.make_frame_image(i, h, w, rng)).save(
            directory / f"{i:04d}.png")


def check_exports(out_dir, name, k):
    """For ``k`` keyframes: the TUM file has one line of 8 finite numbers
    per keyframe, the PLY header parses and gives the file's size, one PNG
    per keyframe."""
    import numpy as np

    lines = (out_dir / f"{name}.txt").read_text().splitlines()
    rows = [[float(v) for v in ln.split()] for ln in lines]
    if len(rows) != k or any(len(r) != 8 for r in rows):
        raise AssertionError(f"{name}.txt: {len(rows)} lines for {k} "
                             f"keyframes: {lines}")
    if not all(np.isfinite(r).all() for r in rows):
        raise AssertionError(f"{name}.txt has non-finite poses: {lines}")
    raw = (out_dir / f"{name}.ply").read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").splitlines()
    nv = int(next(h for h in header if h.startswith("element vertex"))
             .split()[-1])
    if (header[:2] != ["ply", "format binary_little_endian 1.0"]
            or len(raw) - end != nv * 15):
        raise AssertionError(f"{name}.ply: header {header}, {nv} vertices, "
                             f"{len(raw) - end} bytes of data")
    pngs = sorted((out_dir / "keyframes" / name).glob("*.png"))
    if len(pngs) != k:
        raise AssertionError(f"{len(pngs)} keyframe images for {k}")
    return {"keyframes": k, "ply_vertices": nv}


def run_loop_phase(params, model_cfg, traj, ref, run_launches, every):
    """``SLAMSystem.run`` over ``io.datasets.RGBFiles`` on PNG files of the
    base run's frames: single-thread (held to the frame-by-frame base
    run's counts and RMSE gate), then with the backend in a host thread
    (held to the graph invariants and finite poses); then the exports and
    ``ate_rmse`` of the saved TUM file against the oracle trajectory."""
    import pathlib
    import tempfile

    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.config import base_config
    from mast3r_slam_tpu_torch.eval.ate import ate_rmse
    from mast3r_slam_tpu_torch.io import datasets, export
    from mast3r_slam_tpu_torch.models import oracle_timing
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.slam.frame import Mode
    from mast3r_slam_tpu_torch.slam.system import SLAMSystem
    from mast3r_slam_tpu_torch.utils.metrics import Metrics

    h, w = model_cfg.img_size
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "frames").mkdir()
        write_frames(tmp / "frames", N_BASE, h, w)
        systems, walls = {}, {}
        for label, single in (("run_loop", True),
                              ("run_loop_threaded", False)):
            cfg = base_config()
            cfg["tracking"] = dict(cfg["tracking"], kf_every=KF_BASE)
            cfg["single_thread"] = single
            system = SLAMSystem(params, model_cfg, cfg, (h, w),
                                keyframe_capacity=16,
                                edge_capacity=EDGE_CAPACITY,
                                model_module=oracle_timing, device="cuda",
                                metrics=Metrics())
            dataset = datasets.RGBFiles(tmp / "frames")
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            stats = system.run(dataset)
            torch.cuda.synchronize()
            wall = walls[label] = (time.perf_counter() - t0) * 1e3
            launches = run_launches[label] = dict(_kernels.LAUNCHES)
            missing = sorted(k for k in every if launches[k] <= 0)
            if missing:
                raise AssertionError(f"{label} run never launched {missing}: "
                                     f"{launches}")
            k = len(system.keyframes)
            T = system.keyframes.T_WC[:k].cpu().numpy()
            if (system.mode != Mode.TERMINATED or system.backend_queue
                    or not np.isfinite(T).all()):
                raise AssertionError(f"{label}: mode {system.mode}, queue "
                                     f"{system.backend_queue}, poses {T}")
            system.check_invariants()
            extra = ""
            if single:
                rmse, extent = assert_healthy(system, N_BASE, KF_BASE, traj,
                                              label, end_mode="TERMINATED")
                fg, fr = system.factor_graph, ref.factor_graph
                if stats != ref.stats or fg.n_edges != fr.n_edges:
                    raise AssertionError(
                        f"{label}: stats {stats}, edges {fg.n_edges} vs the "
                        f"frame-by-frame base run's {ref.stats}, "
                        f"{fr.n_edges}")
                dT = float(np.abs(T - ref.keyframes.T_WC[:k].cpu().numpy())
                           .max())
                extra = (f", keyframe RMSE after BA {rmse:.6f} of extent "
                         f"{extent:.6f}, keyframe poses vs the base run: "
                         f"max abs diff {dT}")
            log(f"{label}: {N_BASE} frames in {wall:.3f} ms "
                f"({wall / N_BASE:.3f} ms a frame, backend included), stats "
                f"{stats}, edges {system.factor_graph.n_edges}, launches "
                f"{launches}{extra}")
            systems[label] = (system, dataset)

        system, dataset = systems["run_loop"]
        out = tmp / "out"
        export.save_traj(out, "run_loop.txt", dataset.timestamps,
                         system.keyframes)
        export.save_reconstruction(out, "run_loop.ply", system.keyframes,
                                   1.5)
        export.save_keyframes(out / "keyframes" / "run_loop",
                              dataset.timestamps, system.keyframes)
        files = check_exports(out, "run_loop", len(system.keyframes))
        gt = traj[:N_BASE].cpu().numpy()
        with open(tmp / "gt.txt", "w") as f:
            for i in range(N_BASE):
                f.write(" ".join(str(v) for v in (dataset.timestamps[i],
                                                  *gt[i, :7])) + "\n")
        res = ate_rmse(tmp / "gt.txt", out / "run_loop.txt")
        ids = system.keyframes.dataset_idx[:len(system.keyframes)].cpu()
        kf_gt = gt[ids.numpy(), :3]
        extent = float(np.linalg.norm(kf_gt.max(0) - kf_gt.min(0)))
        if not (res["n_pairs"] == files["keyframes"]
                and res["rmse"] < 0.06 * max(extent, 1e-6)):
            raise AssertionError(f"ATE of the saved trajectory: {res}, "
                                 f"extent {extent}")
        log(f"run_loop exports: {files}; ate_rmse of the TUM file vs the "
            f"oracle trajectory {res} (gate 0.06 x extent {extent:.6f})")
    return system, walls["run_loop"]


def cli_phase(run_launches):
    """``cli.main`` with random weights (no tracking gate applies) on the
    dataset of ``scripts/make_synth_dataset.py`` (16 frames of 480x640,
    resized to 384x512) with ``configs/eval_no_calib.yaml``, ``--no-viz
    --max-frames 8``, in a scratch working directory: it returns, prints
    its frames/s, and writes a TUM line per keyframe and a PLY that
    parses."""
    import contextlib
    import importlib.util
    import io
    import os
    import pathlib
    import re
    import tempfile

    import torch

    from mast3r_slam_tpu_torch import cli
    from mast3r_slam_tpu_torch.ops import _kernels

    repo = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset", repo / "scripts" / "make_synth_dataset.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        seq = synth.make(tmp / "synth_seq", n_frames=16)
        cwd = os.getcwd()
        buf = io.StringIO()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(buf):
                stats = cli.main([
                    "--dataset", str(seq), "--config",
                    str(repo / "configs" / "eval_no_calib.yaml"), "--no-viz",
                    "--max-frames", "8", "--save-as", "smoke"])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = run_launches["cli"] = dict(_kernels.LAUNCHES)
        printed = buf.getvalue()
        for ln in printed.splitlines():
            log(f"cli | {ln}")
        fps = re.search(r"done: 8 frames in \S+s = (\S+) FPS", printed)
        if fps is None or launches["rope_qk"] <= 0:
            raise AssertionError(f"cli: no frames/s line, or the network "
                                 f"never ran: launches {launches}")
        files = check_exports(tmp / "logs" / "smoke", "synth_seq",
                              stats["keyframes"])
        log(f"cli phase: {wall:.3f} s with the model's build, stats {stats}, "
            f"outputs {files}, launches {launches}")


def window_phase(params, model_cfg, traj, fast_ref, loop_ref, rparams,
                 run_launches):
    """The windowed frontend through ``SLAMSystem.run`` on PNG files of
    ``run_slam``'s frames, ``tpu_fast`` with ``tracking_window: 8`` as the
    YAML ships it. **window_tpu_fast**: 17 frames at ``kf_every=4`` (frame 0
    alone, then two windows), held to the frame-by-frame tpu_fast run's
    keyframe ids and stats, the health gates and keyframe poses within
    ``POSE_TOL_WINDOW``; beside it the same ``run()`` at W = 1, timed in
    this call, and a third W = 8 run whose windows count their host syncs.
    **window_loop**: the loop run's 33 frames with retrieval at W = 8, held
    to the loop run's gates. **resume**: the window run checkpointed every
    8 frames, killed after the first window, resumed in a fresh system;
    the keyframe ids, edge count and RMSE gate of the uninterrupted run,
    its keyframe positions within ``RESUME_TOL`` of it (Sim(3)-aligned)."""
    import pathlib
    import tempfile

    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.config import tpu_fast_config
    from mast3r_slam_tpu_torch.eval.ate import aligned_rmse
    from mast3r_slam_tpu_torch.io import datasets
    from mast3r_slam_tpu_torch.models import oracle_timing
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.slam import checkpoint
    from mast3r_slam_tpu_torch.slam.system import SLAMSystem
    from mast3r_slam_tpu_torch.utils.metrics import Metrics

    h, w = model_cfg.img_size

    def make(window, kf_every, **kw):
        cfg = tpu_fast_config()
        assert cfg["runtime"]["tracking_window"] == WINDOW
        cfg["tracking"] = dict(cfg["tracking"], kf_every=kf_every)
        cfg["runtime"] = dict(cfg["runtime"], tracking_window=window)
        return SLAMSystem(params, model_cfg, cfg, (h, w),
                          keyframe_capacity=16, model_module=oracle_timing,
                          device="cuda", metrics=Metrics(), **kw)

    def drive(label, system, dataset, must_launch, **kw):
        windows = []
        dispatch = system.dispatch_window
        system.dispatch_window = lambda ids, imgs: (
            windows.append(ids) or dispatch(ids, imgs))
        _kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = system.run(dataset, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = run_launches[label] = dict(_kernels.LAUNCHES)
        missing = sorted(k for k in must_launch if launches[k] <= 0)
        if missing:
            raise AssertionError(f"{label} run never launched {missing}: "
                                 f"{launches}")
        return stats, wall, windows, launches

    def keyframes(system):
        k = len(system.keyframes)
        return (system.keyframes.dataset_idx[:k].cpu().numpy(),
                system.keyframes.T_WC[:k].cpu().numpy())

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "frames").mkdir()
        write_frames(tmp / "frames", N_LOOP, h, w)
        ds = lambda: datasets.RGBFiles(tmp / "frames")

        # W = 1 and W = 8 over the same frames in this call
        sys1 = make(1, KF_FAST, edge_capacity=EDGE_CAPACITY)
        _, wall1, win1, _ = drive("window_tpu_fast_w1", sys1, ds(),
                                  FRONTEND | BA_KERNELS, max_frames=N_FAST)
        torch.cuda.reset_peak_memory_stats()
        sys8 = make(WINDOW, KF_FAST, edge_capacity=EDGE_CAPACITY)
        stats8, wall8, win8, launches8 = drive(
            "window_tpu_fast", sys8, ds(), FRONTEND | BA_KERNELS,
            max_frames=N_FAST)
        peak = torch.cuda.max_memory_allocated() / 2**30
        expect_windows = [list(range(1 + WINDOW * j, 1 + WINDOW * (j + 1)))
                          for j in range(2)]
        if win8 != expect_windows or win1:
            raise AssertionError(f"window branch: W=8 dispatched {win8}, "
                                 f"W=1 dispatched {win1}")
        rmse, extent = assert_healthy(sys8, N_FAST, KF_FAST, traj,
                                      "window_tpu_fast", end_mode="TERMINATED")
        ids8, T8 = keyframes(sys8)
        dT = float(np.abs(T8 - fast_ref["T"]).max())
        if (not np.array_equal(ids8, fast_ref["ids"])
                or stats8 != fast_ref["stats"] or not dT <= POSE_TOL_WINDOW):
            raise AssertionError(
                f"window_tpu_fast vs the frame-by-frame tpu_fast run: ids "
                f"{ids8} / {fast_ref['ids']}, stats {stats8} / "
                f"{fast_ref['stats']}, "
                f"keyframe poses max abs diff {dT} (tolerance "
                f"{POSE_TOL_WINDOW})")
        log(f"window_tpu_fast: {N_FAST} frames through run() at W={WINDOW}, "
            f"windows {win8}, stats {stats8}, edges "
            f"{sys8.factor_graph.n_edges}, keyframe RMSE after BA {rmse:.6f} "
            f"of extent {extent:.6f}, keyframe poses vs the frame-by-frame "
            f"run: max abs diff {dT} (tolerance {POSE_TOL_WINDOW}), launches "
            f"{launches8}")
        log(f"window_tpu_fast per frame (run() wall / {N_FAST} frames, PNG "
            f"read and backend included, same call): W={WINDOW} "
            f"{wall8 / N_FAST:.3f} ms, W=1 {wall1 / N_FAST:.3f} ms; peak "
            f"device memory of the W={WINDOW} run {peak:.3f} GiB")

        # host syncs of each window: dispatch and consume (the backend's
        # drain between them is not the window's)
        sys_s = make(WINDOW, KF_FAST, edge_capacity=EDGE_CAPACITY)
        per_window = []
        dispatch, consume = sys_s.dispatch_window, sys_s.consume_window

        def counted_dispatch(ids, imgs):
            box = {}
            at = host_syncs_of(lambda: box.setdefault("p", dispatch(ids,
                                                                    imgs)))
            per_window.append({"frames": [ids[0], ids[-1]], "dispatch": at})
            return box["p"]

        def counted_consume(pending):
            box = {}
            at = host_syncs_of(lambda: box.setdefault("k", consume(pending)))
            per_window[-1]["consume"] = at
            return box["k"]

        sys_s.dispatch_window = counted_dispatch
        sys_s.consume_window = counted_consume
        drive("window_syncs", sys_s, ds(), FRONTEND, max_frames=N_FAST)
        log("host syncs per window (file:line): " + json.dumps(per_window))
        if any(len(r["dispatch"]) + len(r["consume"]) > 1
               for r in per_window):
            raise AssertionError("a window waited for the device more than "
                                 f"once: {per_window}")
        del sys_s, sys1

        # resume: checkpoint every 8 frames, killed after the first window
        ck = tmp / "state.npz"
        sys_b = make(WINDOW, KF_FAST, edge_capacity=EDGE_CAPACITY)
        drive("resume_killed", sys_b, ds(), FRONTEND, max_frames=1 + WINDOW,
              checkpoint_path=ck, checkpoint_every=WINDOW)
        del sys_b
        sys_c = make(WINDOW, KF_FAST, edge_capacity=EDGE_CAPACITY)
        checkpoint.load_state(ck, sys_c)
        queued = list(sys_c.backend_queue)
        if sys_c.resume_frame != 1 + WINDOW or not queued:
            raise AssertionError(f"resume: next frame {sys_c.resume_frame}, "
                                 f"queue {queued}")
        # the queued keyframes' edges by decode + the dense matcher
        stats_c, _, win_c, launches_c = drive(
            "resume", sys_c, ds(), LOOP_KERNELS, max_frames=N_FAST,
            start_frame=sys_c.resume_frame)
        sys_c.check_invariants()
        ids_c, T_c = keyframes(sys_c)
        rmse_c, extent_c = aligned_rmse(
            T_c[:, :3].astype("float64"),
            traj[ids_c, :3].cpu().numpy().astype("float64"))
        same = np.array_equal(ids_c, ids8)
        dT_c = float(np.abs(T_c - T8).max()) if same else None
        d_c, ext8 = (aligned_rmse(T_c[:, :3].astype("float64"),
                                  T8[:, :3].astype("float64"))
                     if same else (None, None))
        if (not same
                or sys_c.factor_graph.n_edges != sys8.factor_graph.n_edges
                or not d_c < RESUME_TOL * ext8
                or not rmse_c < 0.06 * extent_c):
            raise AssertionError(
                f"resume vs the uninterrupted window run: ids {ids_c} / "
                f"{ids8}, edges {sys_c.factor_graph.n_edges} / "
                f"{sys8.factor_graph.n_edges}, aligned keyframe positions "
                f"{d_c} of extent {ext8} (tolerance {RESUME_TOL} x extent), "
                f"RMSE {rmse_c} of {extent_c}")
        log(f"resume: checkpoint after frame {WINDOW} ({ck.stat().st_size} "
            f"bytes, queue {queued}), resumed windows {win_c}, stats after "
            f"the resume {stats_c}, keyframes {ids_c.tolist()}, edges "
            f"{sys_c.factor_graph.n_edges}, RMSE {rmse_c:.6f} of "
            f"{extent_c:.6f}; against the uninterrupted run: aligned "
            f"keyframe positions {d_c:.6f} of extent {ext8:.6f} (tolerance "
            f"{RESUME_TOL} x extent), poses max abs diff {dT_c}, launches "
            f"{launches_c}")
        del sys_c, sys8

        # the loop run at W = 8 with retrieval
        torch.cuda.reset_peak_memory_stats()
        sys_l = make(WINDOW, KF_LOOP, retrieval_params=rparams,
                     edge_capacity=EDGE_CAPACITY_LOOP)
        stats_l, wall_l, win_l, launches_l = drive(
            "window_loop", sys_l, ds(), LOOP_KERNELS)
        rmse_l, extent_l = assert_healthy(sys_l, N_LOOP, KF_LOOP, traj,
                                          "window_loop",
                                          end_mode="TERMINATED")
        if len(win_l) != (N_LOOP - 1) // WINDOW:
            raise AssertionError(f"window_loop dispatched {win_l}")
        log(f"window_loop: {N_LOOP} frames at W={WINDOW}, windows "
            f"{[[w_[0], w_[-1]] for w_ in win_l]}, stats {stats_l} (the "
            f"frame-by-frame loop run: {loop_ref['stats']}), edges "
            f"{sys_l.factor_graph.n_edges} ({loop_ref['edges']}), keyframe "
            f"RMSE after BA {rmse_l:.6f} of extent {extent_l:.6f}, "
            f"{wall_l / N_LOOP:.3f} ms a frame with the backend, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
            f"launches {launches_l}")


def cli_tpu_fast_phase(net, model_cfg, run_launches):
    """``cli.main`` with ``configs/tpu_fast.yaml`` as shipped (W = 8) and
    ``--checkpoint`` on a released-format ``.pth`` written here from the
    smoke's random weights (``convert.save_released_checkpoint``; loaded
    back once and held bit-equal to the weights), on the 16 frames of
    ``scripts/make_synth_dataset.py``: 9 frames with ``--save-state``
    every 8, then ``--resume`` for the rest. With random weights tracking
    fails at frame 1, inside the first window, so this run goes through
    the window's halt and the per-frame relocalization path."""
    import contextlib
    import importlib.util
    import io
    import os
    import pathlib
    import re
    import tempfile

    import numpy as np
    import torch

    from mast3r_slam_tpu_torch import cli
    from mast3r_slam_tpu_torch.models import convert
    from mast3r_slam_tpu_torch.ops import _kernels

    repo = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset", repo / "scripts" / "make_synth_dataset.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        seq = synth.make(tmp / "synth_seq", n_frames=16)
        pth = tmp / "mast3r_random.pth"
        t0 = time.perf_counter()
        convert.save_released_checkpoint(net, model_cfg, pth)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg2, net2 = convert.load_released_checkpoint(
            pth, img_size=model_cfg.img_size, device="cuda",
            dtype=model_cfg.dtype, head_dtype=model_cfg.head_dtype)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        sd, sd2 = net.state_dict(), net2.state_dict()
        unequal = [k for k in sd if not torch.equal(sd[k], sd2[k])]
        if cfg2 != model_cfg or sorted(sd) != sorted(sd2) or unequal:
            raise AssertionError(f"released checkpoint round trip: config "
                                 f"{cfg2} vs {model_cfg}, {len(unequal)} "
                                 f"tensors differ: {unequal[:5]}")
        del net2, sd2
        log(f"released checkpoint: {pth.stat().st_size / 2**30:.3f} GiB "
            f"written in {t_save:.2f} s, loaded to the GPU in {t_load:.2f} s, "
            f"{len(sd)} tensors bit-equal to the smoke's weights")
        base = ["--dataset", str(seq), "--config",
                str(repo / "configs" / "tpu_fast.yaml"), "--no-viz",
                "--checkpoint", str(pth), "--save-as", "smoke"]
        state = tmp / "state.npz"
        runs = (("cli_tpu_fast", ["--max-frames", "9", "--save-state",
                                  str(state), "--save-state-every", "8"]),
                ("cli_tpu_fast_resume", ["--resume", str(state),
                                         "--save-state", str(state)]))
        cwd = os.getcwd()
        for label, extra in runs:
            # keyframes already in the state a run resumes from
            kf0 = (int(np.load(state)["kf_n_size"]) if "--resume" in extra
                   else 0)
            buf = io.StringIO()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            os.chdir(tmp)
            try:
                with contextlib.redirect_stdout(buf):
                    stats = cli.main(base + extra)
            finally:
                os.chdir(cwd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = run_launches[label] = dict(_kernels.LAUNCHES)
            printed = buf.getvalue()
            for ln in printed.splitlines():
                log(f"{label} | {ln}")
            n_run = 9 if label == "cli_tpu_fast" else 16
            resumed = re.search(r"resumed SLAM state from .* next frame (\d+)",
                                printed)
            if ("loading checkpoint" not in printed
                    or not re.search(rf"done: {n_run} frames in", printed)
                    or launches["rope_qk"] <= 0 or not state.exists()
                    or (label != "cli_tpu_fast"
                        and (resumed is None or resumed.group(1) != "9"))):
                raise AssertionError(f"{label}: unexpected output or launches "
                                     f"{launches}")
            files = check_exports(tmp / "logs" / "smoke", "synth_seq",
                                  kf0 + stats["keyframes"])
            log(f"{label}: {wall:.3f} s with the model's load, stats {stats}, "
                f"outputs {files}, launches {launches}")


def _ctrl(base, query, token):
    """POST ``/ctrl?query`` to a live viewer with ``token``; returns the
    HTTP status."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{base}/ctrl?{query}&t={token}",
                                 method="POST")
    try:
        return urllib.request.urlopen(req, timeout=10).status
    except urllib.error.HTTPError as e:
        return e.code


def _cpu_copy(keyframes, factor_graph):
    """CPU copies of a store's rows and a graph's edges, for the plain
    scene of ``viz.build_scene`` on the CPU."""
    import types

    from mast3r_slam_tpu_torch.slam.frame import KeyframeStore

    n = len(keyframes)
    kc = KeyframeStore(max(n, 1), keyframes.X.shape[1], 1, 1,
                       (keyframes.h, keyframes.w), device="cpu")
    kc.n_size = n
    for name in ("T_WC", "X", "C", "N"):
        getattr(kc, name)[:n] = getattr(keyframes, name)[:n].cpu()
    kc.uimg[:n] = keyframes.uimg[:n]
    e = factor_graph.n_edges
    return kc, types.SimpleNamespace(n_edges=e, ii=factor_graph.ii[:e].cpu(),
                                     jj=factor_graph.jj[:e].cpu())


def viewer_phase(params, model_cfg, ref, ref_wall, run_launches, every):
    """**viewer**: ``SLAMSystem.run`` over PNG files of the base frames (the
    run_loop run's setting) with ``LiveViewer(port=0, refresh_s=0)``, in a
    host thread, paused from the start: a ``/ctrl`` without the token is
    refused; one step through ``/ctrl`` advances exactly one frame; then it
    is resumed. Its stats and keyframe poses must equal the run_loop run's
    (the viewer changes nothing), and ``GET /scene`` at the end, unpacked,
    must equal ``viz.build_scene`` on CPU copies of the final store (the
    count and colours equal, points within 1e-5). A second run with the
    viewer is timed beside the run_loop run of this call."""
    import pathlib
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from mast3r_slam_tpu_torch import viz, viz_server
    from mast3r_slam_tpu_torch.config import base_config
    from mast3r_slam_tpu_torch.io import datasets
    from mast3r_slam_tpu_torch.models import oracle_timing
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.slam.system import SLAMSystem
    from mast3r_slam_tpu_torch.utils.metrics import Metrics

    h, w = model_cfg.img_size

    def make():
        cfg = base_config()
        cfg["tracking"] = dict(cfg["tracking"], kf_every=KF_BASE)
        cfg["single_thread"] = True
        return SLAMSystem(params, model_cfg, cfg, (h, w),
                          keyframe_capacity=16, edge_capacity=EDGE_CAPACITY,
                          model_module=oracle_timing, device="cuda",
                          metrics=Metrics())

    ref_T = ref.keyframes.T_WC[:len(ref.keyframes)].cpu().numpy()

    def same_as_ref(label, system, stats):
        T = system.keyframes.T_WC[:len(system.keyframes)].cpu().numpy()
        if (stats != ref.stats or T.shape != ref_T.shape
                or not np.array_equal(T, ref_T)):
            raise AssertionError(f"{label}: stats {stats}, keyframe poses "
                                 f"{T} vs run_loop's {ref.stats}, {ref_T}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_frames(tmp, N_BASE, h, w)
        system = make()
        viewer = viz_server.LiveViewer(port=0, refresh_s=0.0).start()
        base = f"http://127.0.0.1:{viewer.port}"
        try:
            refused = _ctrl(base, "pause=1", "no-token")
            if refused != 403 or viewer.paused:
                raise AssertionError(f"/ctrl without the token: {refused}")
            if _ctrl(base, "pause=1", viewer.token) != 200:
                raise AssertionError("/ctrl pause refused")
            _kernels.reset_launch_counts()
            box = {}

            def body():
                try:
                    box["stats"] = system.run(datasets.RGBFiles(tmp),
                                              viewer=viewer)
                except BaseException as e:     # re-raised below
                    box["error"] = e

            thread = threading.Thread(target=body)
            thread.start()
            time.sleep(1.0)
            held = system.last_frame_idx
            _ctrl(base, "step=1", viewer.token)
            t0 = time.perf_counter()
            while system.last_frame_idx < 1 and time.perf_counter() - t0 < 60:
                time.sleep(0.01)
            time.sleep(1.0)
            stepped = system.last_frame_idx
            _ctrl(base, "toggle=1", viewer.token)
            thread.join(timeout=300)
            if thread.is_alive():
                raise AssertionError("viewer run did not finish")
            if "error" in box:
                raise box["error"]
            if (held, stepped) != (0, 1):
                raise AssertionError(f"pause held at frame {held}, one step "
                                     f"went to frame {stepped}")
            launches = run_launches["viewer"] = dict(_kernels.LAUNCHES)
            missing = sorted(k for k in every if launches[k] <= 0)
            if missing:
                raise AssertionError(f"viewer run never launched {missing}")
            same_as_ref("viewer", system, box["stats"])
            blob = urllib.request.urlopen(f"{base}/scene", timeout=10).read()
        finally:
            viewer.stop()
        served = viz_server.unpack_scene(blob)
        kc, fc = _cpu_copy(system.keyframes, system.factor_graph)
        plain = viz.build_scene(kc, 1.5, viewer.max_points, fc)
        err = (float(np.abs(served["pts"] - plain["pts"]).max())
               if len(served["pts"]) == len(plain["pts"]) > 0 else None)
        if (served["n_kf"] != len(system.keyframes) or err is None
                or not err <= 1e-5
                or not np.array_equal(served["cols"], plain["cols"])
                or not np.array_equal(served["lcols"], plain["lcols"])):
            raise AssertionError(f"/scene vs viz.build_scene on the CPU: "
                                 f"{len(served['pts'])} / {len(plain['pts'])}"
                                 f" points, max err {err}")
        log(f"viewer: paused at frame {held}, one step to frame {stepped}, "
            f"/ctrl without the token {refused}; stats and keyframe poses "
            f"equal to run_loop's; /scene: {len(served['pts'])} points, "
            f"{len(served['lpts'])} line ends, max abs err vs the CPU build "
            f"{err}; launches {launches}")

        # the same run() with a viewer refreshing after every frame, timed
        system = make()
        viewer = viz_server.LiveViewer(port=0, refresh_s=0.0).start()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = system.run(datasets.RGBFiles(tmp), viewer=viewer)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            viewer.stop()
        same_as_ref("viewer (timed)", system, stats)
        log(f"run() per frame over the {N_BASE} base frames: "
            f"{wall / N_BASE:.3f} ms with the viewer refreshing after every "
            f"frame, {ref_wall / N_BASE:.3f} ms without (run_loop, this "
            f"call); last refresh {viewer.last_render}")


def scene_cost(label, system, factor_graph=None):
    """The live viewer's refresh on ``system``'s store: ms and bytes read
    back, the first refresh (the colour cache filled) and a second one;
    the host syncs of a refresh and of an update with no refresh due (gate:
    none)."""
    from mast3r_slam_tpu_torch import viz_server

    viewer = viz_server.LiveViewer(port=0, refresh_s=0.0).start()
    try:
        out = {}
        for run in ("first", "second"):
            t0 = time.perf_counter()
            viewer.update(system, force=True)
            out[f"update_{run}_ms"] = (time.perf_counter() - t0) * 1e3
            out[f"render_{run}"] = dict(viewer.last_render)
        out["refresh_syncs_at"] = host_syncs_of(
            lambda: viewer.update(system, force=True))
        viewer.refresh_s = 3600.0
        idle = host_syncs_of(lambda: viewer.update(system))
        if idle:
            raise AssertionError(f"{label}: an update with no refresh due "
                                 f"waited for the device at {idle}")
        out["not_due_syncs"] = 0
    finally:
        viewer.stop()
    log(f"scene refresh at {len(system.keyframes)} keyframes ({label}): "
        + json.dumps(out))


def big_store_scene_cost(model_cfg, src):
    """``scene_cost`` on a store of 256 keyframes filled from ``src``'s
    rows (each copy moved along x), with a chain of 510 edges."""
    import types

    import torch

    from mast3r_slam_tpu_torch.slam.frame import KeyframeStore

    n, k = 256, len(src)
    h, w = model_cfg.img_size
    kfs = KeyframeStore(n, h * w, model_cfg.num_patches, 1, (h, w),
                        device="cuda")
    rows = torch.arange(n, device="cuda") % k
    kfs.X.copy_(src.X[rows])
    kfs.C.copy_(src.C[rows])
    kfs.N.copy_(src.N[rows])
    kfs.T_WC.copy_(src.T_WC[rows])
    kfs.T_WC[:, 0] += torch.arange(n, device="cuda") * 0.05
    for i in range(n):
        kfs.set_uimg(i, src.uimg[i % k])
    kfs.n_size = n
    ii = torch.arange(n - 1, device="cuda", dtype=torch.int32)
    fg = types.SimpleNamespace(n_edges=2 * (n - 1), ii=torch.cat([ii, ii + 1]),
                               jj=torch.cat([ii + 1, ii]))
    system = types.SimpleNamespace(keyframes=kfs, factor_graph=fg,
                                   last_frame_idx=n)
    scene_cost("a store filled from base's rows", system)


def cli_viz_phase(run_launches):
    """``cli.main`` as the cli run (``configs/eval_no_calib.yaml``, random
    weights, 8 of ``scripts/make_synth_dataset.py``'s frames) without
    ``--no-viz`` and with ``--serve-viz 0``: the live viewer is served
    during the run and stopped after it, and the renders are written. The
    HTML viewer needs only numpy and comes first; the three PNGs need
    matplotlib. Where matplotlib is installed all four files must be
    written; where it is not, ``cli.main`` must raise the ``ImportError``
    naming matplotlib (as the JAX CLI would) after writing the HTML."""
    import ast
    import contextlib
    import importlib.util
    import io
    import os
    import pathlib
    import re
    import tempfile

    import torch

    from mast3r_slam_tpu_torch import cli
    from mast3r_slam_tpu_torch.ops import _kernels

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    repo = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset", repo / "scripts" / "make_synth_dataset.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        seq = synth.make(tmp / "synth_seq", n_frames=16)
        cwd = os.getcwd()
        buf = io.StringIO()
        _kernels.reset_launch_counts()
        raised = None
        t0 = time.perf_counter()
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(["--dataset", str(seq), "--config",
                          str(repo / "configs" / "eval_no_calib.yaml"),
                          "--max-frames", "8", "--save-as", "smoke",
                          "--serve-viz", "0"])
        except ImportError as e:
            raised = e
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = run_launches["cli_viz"] = dict(_kernels.LAUNCHES)
        printed = buf.getvalue()
        for ln in printed.splitlines():
            log(f"cli_viz | {ln}")
        if has_mpl and raised is not None:
            raise raised
        if not has_mpl and (raised is None or raised.name != "matplotlib"):
            raise AssertionError(f"cli_viz without matplotlib: {raised!r}")
        out = tmp / "logs" / "smoke"
        stats = ast.literal_eval(re.search(r"stats: (\{.*\})",
                                           printed).group(1))
        files = check_exports(out, "synth_seq", stats["keyframes"])
        html = (out / "synth_seq_viewer.html").read_text()
        pts = int(re.search(r"points: (\d+)", html).group(1))
        pngs = [f"synth_seq{s}.png" for s in ("_traj", "_cloud",
                                              "_keyframes")]
        written = sorted(p.name for p in out.glob("synth_seq_*"))
        expect = sorted(["synth_seq_viewer.html"] + (pngs if has_mpl else []))
        if (written != expect or launches["rope_qk"] <= 0
                or "live viewer: http://localhost:" not in printed
                or not re.search(r"done: 8 frames in", printed)):
            raise AssertionError(f"cli_viz: wrote {written}, expected "
                                 f"{expect}; launches {launches}")
        log(f"cli_viz phase: {wall:.3f} s, stats {stats}, outputs {files}, "
            f"renders {written} (HTML viewer with {pts} points; matplotlib "
            f"{'present' if has_mpl else f'absent: {raised}'}), launches "
            f"{launches}")


# -- phase 8: the backend across devices --------------------------------------

# the second device of every phase-8 run is cuda:0 again: the card's machine
# has one GPU, so cross-GPU copies are not measured
MIRROR_TOL = 1e-5        # the mirrored loop run against the dense loop run
SHARD_TOL = 1e-4         # a sharded solve's poses against the dense solve's
CHAIN_KF = 24            # the synthetic chain where Schur eliminates
CHAIN_LOOPS = [(0, 23), (6, 17)]


def loop_graph_of(system):
    """A copy of what a global solve of the run's final graph reads: poses,
    maps, average confidences, the active edges, the active keyframe count
    and the BA settings."""
    fg, kfs = system.factor_graph, system.keyframes
    Kb, (*edges, n_kf) = fg._solve_args()
    return {"T": kfs.T_WC[:Kb].clone(), "Xs": kfs.X[:Kb].clone(),
            "Cs": kfs.average_confs(Kb).clone(),
            "edges": [a.clone() for a in edges], "n_kf": n_kf,
            "cfg": fg.ba_cfg}


def mirror_phase(params, model_cfg, traj, loop_ref, rparams, net,
                 return_expect, run_launches):
    """**mirror**: the loop run and the teleport (return) run with
    ``runtime.backend_device: 1`` over the local devices (cuda:0, cuda:0):
    the factor graph reads a ``BackendMirror``. The loop run must give the
    dense loop run's counts and its keyframe poses within ``MIRROR_TOL``;
    the teleport run must relocalize through ``seed_pose``. Counts the
    syncs and their rows, times one sync, and lists the host syncs of one
    backend step with the mirror."""
    import torch

    from mast3r_slam_tpu_torch.config import tpu_fast_config
    from mast3r_slam_tpu_torch.models import oracle, oracle_timing
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import backend_device as bdev

    local = [torch.device("cuda", 0)] * 2
    seen = {"syncs": 0, "rows": 0, "seeds": 0}
    sync0, seed0 = bdev.BackendMirror.sync, bdev.BackendMirror.seed_pose

    def sync(self):
        n = self.main.n_size
        seen["syncs"] += 1
        seen["rows"] += n - max(0, min(self._mirror_n - 1, n - 1))
        sync0(self)

    def seed_pose(self, idx, T):
        seen["seeds"] += 1
        seed0(self, idx, T)

    bdev.BackendMirror.sync, bdev.BackendMirror.seed_pose = sync, seed_pose
    try:
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        system, _, _ = run_slam(
            tpu_fast_config(), params, model_cfg, N_LOOP, KF_LOOP,
            retrieval_params=rparams, edge_capacity=EDGE_CAPACITY_LOOP,
            runtime={"backend_device": 1}, local_devices=local)
        wall = time.perf_counter() - t0
        launches = run_launches["mirror_loop"] = dict(_kernels.LAUNCHES)
        loop_syncs, stats = dict(seen), dict(system.stats)
        bm, fg = system._backend_mirror, system.factor_graph
        rmse, extent = assert_healthy(system, N_LOOP, KF_LOOP, traj,
                                      "mirror_loop")
        k = len(system.keyframes)
        counts = (k, system.stats["loop_closures"], fg.n_edges,
                  fg.edges_dropped)
        dT = (float((system.keyframes.T_WC[:k].cpu()
                     - torch.from_numpy(loop_ref["T"])).abs().max())
              if k == len(loop_ref["T"]) else None)
        missing = sorted(n for n in LOOP_KERNELS if launches[n] <= 0)
        if (bm is None or fg.frames is not bm or counts != (9, 13, 42, 0)
                or system.stats != loop_ref["stats"]
                or fg.n_edges != loop_ref["edges"] or dT is None
                or not dT <= MIRROR_TOL or missing):
            raise AssertionError(
                f"mirror_loop run: mirror {bm is not None}, counts "
                f"(keyframes, loop closures, edges, dropped) {counts}, stats "
                f"{system.stats} vs {loop_ref['stats']}, pose diff {dT}, "
                f"never launched {missing}")
        # one sync of the latest row and the poses, timed alone
        n = bm.n_size
        row_bytes = sum(getattr(bm, f)[0].numel()
                        * getattr(bm, f).element_size()
                        for f in ("X", "C", "N", "feat", "pos"))
        pose_bytes = bm.T_WC.numel() * bm.T_WC.element_size()

        def one_row():
            bm._mirror_n = n
            sync0(bm)

        sync_ms = time_ms(one_row, reps=10)
        sync_device_ms = device_ms(one_row, reps=10)
        sync_syncs = host_syncs_of(one_row)
        # one more backend step with work: the last keyframe queued again
        system.backend_queue.append(n - 1)
        step_syncs = host_syncs_of(system.backend_step)
        log(f"mirror_loop: {N_LOOP} frames in {wall:.3f} s, stats "
            f"{stats}, edges {counts[2]} (dropped {counts[3]}), keyframe "
            f"poses within {dT} of the dense "
            f"loop run (gate {MIRROR_TOL}), RMSE after BA {rmse:.6f} of "
            f"{extent:.6f}, launches {launches}")
        log("mirror syncs: " + json.dumps({
            "syncs": loop_syncs["syncs"], "rows_copied": loop_syncs["rows"],
            "bytes_per_row": row_bytes, "pose_bytes": pose_bytes,
            "bytes_per_one_row_sync": row_bytes + pose_bytes,
            "ms_per_one_row_sync": sync_ms,
            "device_ms_per_one_row_sync": sync_device_ms,
            "host_syncs_of_one_sync": sync_syncs,
            "host_syncs_of_one_backend_step": len(step_syncs),
            "host_syncs_at": step_syncs}))
        del system

        traj_t = teleport_traj(4, 2, 3)
        orc_t = oracle.make_params(traj_t.cuda(), desc_dim=model_cfg.desc_dim,
                                   seed=0, device="cuda")
        seen.update(syncs=0, rows=0, seeds=0)
        _kernels.reset_launch_counts()
        system, _, _ = run_slam(
            tpu_fast_config(), oracle_timing.make_params(net, orc_t),
            model_cfg, len(traj_t), KF_TELEPORT, retrieval_params=rparams,
            edge_capacity=EDGE_CAPACITY_LOOP, runtime={"backend_device": 1},
            local_devices=local)
        launches = run_launches["mirror_teleport_return"] = dict(
            _kernels.LAUNCHES)
    finally:
        bdev.BackendMirror.sync, bdev.BackendMirror.seed_pose = sync0, seed0
    assert_teleport(system, "mirror_teleport_return", return_expect)
    if system._backend_mirror is None or seen["seeds"] < 1:
        raise AssertionError(f"mirror_teleport_return: seed_pose called "
                             f"{seen['seeds']} times")
    log(f"mirror_teleport_return: end mode {system.mode.name}, stats "
        f"{system.stats}, edges {system.factor_graph.n_edges}, syncs "
        f"{seen['syncs']}, seed_pose calls {seen['seeds']}, launches "
        f"{launches}")


def _padded(edges, n):
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod

    fills = (0, 0, 0, False, 0, 0)
    return [mesh_mod.pad_to_multiple(a, n, 0, f) for a, f in zip(edges, fills)]


def _kf_sharded(T, Xs, Cs, edges, n_kf, m, cfg):
    from mast3r_slam_tpu_torch.parallel import dist_ba
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod

    ii, jj, idx, vm, Q, mask = _padded(edges, m.size)
    Xs_b, Cs_b = dist_ba.shard_keyframe_store(
        m, mesh_mod.pad_to_multiple(Xs, m.size),
        mesh_mod.pad_to_multiple(Cs, m.size))
    pre = dist_ba.prep_edges_kf_sharded(m, Xs_b, Cs_b, ii, jj, idx, vm,
                                        stride=cfg.point_stride)
    return dist_ba.gauss_newton_rays_dist_pre(T, pre, ii, jj, vm, Q, mask,
                                              n_kf, m, cfg)


def _schur_or_fallback(T, Xs, Cs, K, edges, n_kf, m, cfg, residual,
                       img_size):
    """The factor graph's rule (``slam/factor_graph.py``): Schur unless the
    separator dominates, then edge-sharded. Returns (result, separator
    count, fell back)."""
    from mast3r_slam_tpu_torch.parallel import dist_ba, schur

    ii, jj, *_ = edges
    mask = edges[5]
    part, order, keep = schur.schur_partition(
        ii.cpu().numpy(), jj.cpu().numpy(), mask.cpu().numpy() > 0,
        K_cap=T.shape[0], n_shards=m.size)
    n_sep = int((part.sep_slot[:n_kf] >= 0).sum())
    if schur.separator_dominated(part, n_kf):
        return dist_ba.gauss_newton_dist(
            T, Xs, Cs, K, *_padded(edges, m.size), n_kf, m, cfg,
            residual=residual, img_size=img_size), n_sep, True
    return schur.gauss_newton_schur(
        T, Xs, Cs, K, part.owner, part.int_slot, part.sep_slot,
        *schur.reorder_edges(order, keep, *edges), n_kf, part.I_cap,
        part.S_cap, m, cfg, residual=residual, img_size=img_size), n_sep, False


def run_solves(label, solves, ref, run_launches, reps=3):
    """Each solve once with the launch counts from zero (its result held to
    ``ref``'s poses within ``SHARD_TOL``), then timed: wall ms of a whole
    solve, host syncs included, median of ``reps``."""
    import torch

    from mast3r_slam_tpu_torch.ops import _kernels

    out = {}
    for name, fn in solves.items():
        _kernels.reset_launch_counts()
        got = fn()
        # a BAResult, or (BAResult, separators, fell back) from a Schur solve
        res = got if hasattr(got, "T_WC") else got[0]
        torch.cuda.synchronize()
        run_launches[f"{label}_{name}"] = dict(_kernels.LAUNCHES)
        T = res.T_WC
        d = float((T - ref).abs().max())
        if not (torch.isfinite(T).all() and d <= SHARD_TOL):
            raise AssertionError(f"{label} {name}: poses {d} from the dense "
                                 f"solve (gate {SHARD_TOL})")
        rec = {"iters": res.iters, "step_norms": list(res.deltas),
               "max_pose_diff": d,
               "ms": time_ms(fn, reps=reps, warmup=0),
               "launches": {k: v for k, v in
                            run_launches[f"{label}_{name}"].items() if v}}
        if res is not got:
            rec.update(separators=got[1], fell_back=got[2])
        out[name] = rec
    return out


def moved_poses(g):
    """The loop graph's poses moved off its converged ones (seeded)."""
    import torch

    from mast3r_slam_tpu_torch.lie import sim3

    T0, pin = g["T"], g["cfg"].pin
    gen = torch.Generator(device="cuda").manual_seed(3)
    xi = 0.01 * torch.randn((T0.shape[0], 7), generator=gen, device="cuda")
    xi[:pin] = 0.0
    return sim3.retr(T0, xi).contiguous()


def sharded_graph_phase(g, run_launches):
    """**sharded BA on the loop graph**: the loop run's final graph solved
    from poses moved off its converged ones, dense, edge-sharded over 2 and
    4 shards of cuda:0, keyframe-sharded over 2, and by Schur over 2 (which
    falls back to edge-sharded when the separator dominates), each with
    its iterations' step norms; then the host syncs of one sharded
    solve."""
    import torch

    from mast3r_slam_tpu_torch.parallel import dist_ba
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod
    from mast3r_slam_tpu_torch.slam import ba

    Xs, Cs, edges = g["Xs"], g["Cs"], g["edges"]
    n_kf, cfg = g["n_kf"], g["cfg"]
    cuda0 = torch.device("cuda", 0)
    mesh = lambda n: mesh_mod.make_mesh([cuda0] * n)
    T = moved_poses(g)
    dense = ba.gauss_newton_rays(T, Xs, Cs, *edges, n_kf, cfg)
    solves = {
        "dense": lambda: ba.gauss_newton_rays(T, Xs, Cs, *edges, n_kf, cfg),
        **{f"edge_sharded_{n}": (lambda n=n: dist_ba.gauss_newton_rays_dist(
            T, Xs, Cs, *_padded(edges, n), n_kf, mesh(n), cfg))
           for n in (2, 4)},
        "kf_sharded_2": lambda: _kf_sharded(T, Xs, Cs, edges, n_kf, mesh(2),
                                            cfg),
        "schur_2": lambda: _schur_or_fallback(T, Xs, Cs, None, edges, n_kf,
                                              mesh(2), cfg, "rays", None),
    }
    out = {"keyframes": n_kf, "edges": int(edges[5].sum()),
           "points_per_edge": len(range(0, edges[2].shape[1],
                                        cfg.point_stride)),
           "solves_from_moved_poses": run_solves(
               "loop_graph", solves, dense.T_WC, run_launches)}
    syncs = host_syncs_of(solves["edge_sharded_2"])
    # the edge lists' read, one plan upload a shard, the step norms' read
    out["host_syncs_edge_sharded_2"] = {
        "count": len(syncs), "expected": 4, "at": syncs}
    log("sharded BA on the loop graph: " + json.dumps(out))
    return out


def chain_graph(model_cfg):
    """The synthetic chain of ``CHAIN_KF`` keyframes at the model's
    resolution, from a seeded generator on cuda:0 (every keyframe sees the
    same random world points, matched by pixel index, as
    ``tests/test_schur.py`` builds its world), with the loop edges
    ``CHAIN_LOOPS`` and noised poses: (T, Xs, Cs, edges, K)."""
    import torch

    from mast3r_slam_tpu_torch.lie import sim3

    h, w = model_cfg.img_size
    P, n_kf, dev = h * w, CHAIN_KF, "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    pts = randn(P, 3) * torch.tensor([1.0, 1.0, 0.5], device=dev)
    pts = pts + torch.tensor([0.0, 0.0, 4.0], device=dev)
    T_true = [sim3.identity(device=dev)]
    for _ in range(1, n_kf):
        T_true.append(sim3.mul(T_true[-1], sim3.exp(0.05 * randn(7))))
    T_true = torch.stack(T_true)
    Xs = sim3.act(sim3.inv(T_true)[:, None], pts[None])
    noise = 0.05 * randn(n_kf, 7)
    noise[0] = 0.0
    T = sim3.retr(T_true, noise).contiguous()
    pairs = [(i, i + 1) for i in range(n_kf - 1)] + CHAIN_LOOPS
    ii = torch.tensor([a for p in pairs for a in p], dtype=torch.int32,
                      device=dev)
    jj = torch.tensor([a for p in pairs for a in p[::-1]], dtype=torch.int32,
                      device=dev)
    E = ii.shape[0]
    edges = [ii, jj,
             torch.arange(P, dtype=torch.int32, device=dev).repeat(E, 1),
             torch.ones((E, P), dtype=torch.bool, device=dev),
             torch.full((E, P), 4.0, device=dev),
             torch.ones((E,), device=dev)]
    Cs = torch.full((n_kf, P), 5.0, device=dev)
    f = 0.8 * w
    K = torch.tensor([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]],
                     device=dev)
    return T, Xs, Cs, edges, K


def schur_chain_phase(model_cfg, cfg, run_launches):
    """**Schur where it eliminates**: ``chain_graph``, rays and calibrated,
    solved dense, edge-sharded and by Schur over 2 and 4 shards of cuda:0.
    The partition must not be separator-dominated and every solve must give
    the dense poses within ``SHARD_TOL``."""
    import torch

    from mast3r_slam_tpu_torch import geometry
    from mast3r_slam_tpu_torch.parallel import dist_ba
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod
    from mast3r_slam_tpu_torch.parallel import schur
    from mast3r_slam_tpu_torch.slam import ba

    h, w = model_cfg.img_size
    P, n_kf = h * w, CHAIN_KF
    T, Xs, Cs, edges, K = chain_graph(model_cfg)
    ii, jj, E = edges[0], edges[1], edges[0].shape[0]
    cuda0 = torch.device("cuda", 0)
    mesh = lambda n: mesh_mod.make_mesh([cuda0] * n)
    ij = [a.cpu().numpy() for a in (ii, jj)]
    parts = {n: schur.schur_partition(*ij, edges[5].cpu().numpy(), n_kf, n)[0]
             for n in (2, 4)}
    seps = {n: int((p.sep_slot >= 0).sum()) for n, p in parts.items()}
    if any(schur.separator_dominated(p, n_kf) for p in parts.values()):
        raise AssertionError(f"schur chain: separator-dominated, separators "
                             f"{seps} of {n_kf}")
    out = {"keyframes": n_kf, "edges": E, "points_per_edge":
           len(range(0, P, cfg.point_stride)), "separators": seps}
    Xc = geometry.constrain_points_to_ray((h, w), Xs, K)
    dense_solves = {
        "rays": lambda: ba.gauss_newton_rays(T, Xs, Cs, *edges, n_kf, cfg),
        "calib": lambda: ba.gauss_newton_calib(T, Xc, Cs, K, *edges, n_kf,
                                               (h, w), cfg)}
    for residual, Xr in (("rays", Xs), ("calib", Xc)):
        Kr = K if residual == "calib" else None
        size = (h, w) if residual == "calib" else None
        solves = {"dense": dense_solves[residual]}
        for n in (2, 4):
            solves[f"edge_sharded_{n}"] = (
                lambda n=n, Xr=Xr, Kr=Kr, size=size, r=residual:
                dist_ba.gauss_newton_dist(T, Xr, Cs, Kr, *_padded(edges, n),
                                          n_kf, mesh(n), cfg, residual=r,
                                          img_size=size))
            solves[f"schur_{n}"] = (
                lambda n=n, Xr=Xr, Kr=Kr, size=size, r=residual:
                _schur_or_fallback(T, Xr, Cs, Kr, edges, n_kf, mesh(n), cfg,
                                   r, size))
        out[residual] = run_solves(f"schur_chain_{residual}", solves,
                                   solves["dense"]().T_WC, run_launches)
        for n in (2, 4):
            if out[residual][f"schur_{n}"]["fell_back"]:
                raise AssertionError(f"schur chain {residual}: fell back "
                                     f"over {n} shards")
    log("Schur on the chain: " + json.dumps(out))
    return out


def sharded_loop_phase(params, model_cfg, traj, loop_ref, rparams,
                       run_launches):
    """**sharded loop run**: the whole loop run with ``parallel.ba_backend:
    edge_sharded`` over a mesh of 2 x cuda:0: the dense loop run's health
    gates and counts, and its keyframe poses within ``SHARD_TOL``."""
    import torch

    from mast3r_slam_tpu_torch.config import tpu_fast_config
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod
    from mast3r_slam_tpu_torch.utils import timing

    m = mesh_mod.make_mesh([torch.device("cuda", 0)] * 2)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with timing.recording() as rec:
        system, _, backend = run_slam(
            tpu_fast_config(), params, model_cfg, N_LOOP, KF_LOOP,
            retrieval_params=rparams, edge_capacity=EDGE_CAPACITY_LOOP,
            parallel={"ba_backend": "edge_sharded"}, mesh=m)
    wall = time.perf_counter() - t0
    solved_by = last_solve(rec).get("backend")
    launches = run_launches["sharded_loop"] = dict(_kernels.LAUNCHES)
    rmse, extent = assert_healthy(system, N_LOOP, KF_LOOP, traj,
                                  "sharded_loop")
    fg = system.factor_graph
    k = len(system.keyframes)
    missing = sorted(n for n in LOOP_KERNELS if launches[n] <= 0)
    dT = (float((system.keyframes.T_WC[:k].cpu()
                 - torch.from_numpy(loop_ref["T"])).abs().max())
          if k == len(loop_ref["T"]) else None)
    if (system.stats != loop_ref["stats"] or fg.n_edges != loop_ref["edges"]
            or solved_by != "edge_sharded" or missing
            or dT is None or not dT <= SHARD_TOL):
        raise AssertionError(
            f"sharded_loop run: stats {system.stats} vs {loop_ref['stats']}, "
            f"edges {fg.n_edges} vs {loop_ref['edges']}, last solve by "
            f"{solved_by}, never launched {missing}, keyframe "
            f"poses max abs diff {dT} (gate {SHARD_TOL})")
    log(f"sharded_loop: {N_LOOP} frames in {wall:.3f} s, stats "
        f"{system.stats}, edges {fg.n_edges}, RMSE after BA {rmse:.6f} of "
        f"{extent:.6f} (gate 0.06 of it), keyframe poses within {dT} of the "
        f"dense loop run (gate {SHARD_TOL}), backend per step (wall ms, GN iterations, "
        f"keyframes, edges): "
        f"{[(round(t, 3), it, kk, e) for t, it, kk, e in backend]}, "
        f"launches {launches}")

# -- phase 9: data-parallel tracking, the sharded decode, multi-host runs ------

DP_FIRST = (0, 16)      # the first frames of phase 9's two streams
DECODE_TOL = 2e-3       # tests/test_parallel.py:63-66
CHILD_TIMEOUT = 300     # seconds for each child process of phase 9
CHILD_TAG = "PHASE9_CHILD "


def window_seq(params, model_cfg, first):
    """A tpu_fast system at ``kf_every=KF_FAST`` after its INIT frame
    ``first``, and the ``SeqInputs`` of its next ``WINDOW`` frames on
    cuda:0."""
    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.config import tpu_fast_config
    from mast3r_slam_tpu_torch.models import oracle_timing
    from mast3r_slam_tpu_torch.parallel import dp_tracking
    from mast3r_slam_tpu_torch.slam.system import SLAMSystem

    h, w = model_cfg.img_size
    cfg = tpu_fast_config()
    cfg["tracking"] = dict(cfg["tracking"], kf_every=KF_FAST)
    system = SLAMSystem(params, model_cfg, cfg, (h, w), keyframe_capacity=16,
                        edge_capacity=EDGE_CAPACITY,
                        model_module=oracle_timing, device="cuda")
    image = lambda i: oracle_timing.make_frame_image(i, h, w)
    system.process_frame(system.make_frame(first, image(first)))
    ids = list(range(first + 1, first + 1 + WINDOW))
    imgs = torch.from_numpy(np.stack([image(i) for i in ids])).cuda()
    seq = dp_tracking.SeqInputs(
        imgs, ids, system.tracker.idx_f2k, system.current_frame.T_WC,
        torch.eye(3, device="cuda"), len(system.keyframes) - 1,
        system.keyframes)
    return system, seq


def _window_args(system):
    tr = system.tracker
    return dict(ds=system.downsample, fuse_mode=tr.filtering_mode,
                score_fn=tr.filtering_score, use_calib=False,
                capture_matches=system._reuse_consec)


def lone_window(params, model_cfg, system, seq):
    """``seq``'s window alone, as ``SLAMSystem.dispatch_window`` runs it."""
    from mast3r_slam_tpu_torch.models import oracle_timing
    from mast3r_slam_tpu_torch.slam.system import _track_window_body

    tr, kfs, a = system.tracker, seq.kfs, _window_args(system)
    return _track_window_body(
        oracle_timing, params, model_cfg, tr.mcfg, tr.tcfg, seq.imgs,
        seq.frame_ids, seq.idx_init, seq.prev_T_WC, seq.K, seq.last_idx,
        kfs, a["ds"], a["fuse_mode"], a["score_fn"], False, (kfs.h, kfs.w),
        None, a["capture_matches"])


def wall_ms(fn, reps=3):
    """Median host wall ms of ``fn()`` from an idle device to an idle
    device."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ranks_wall_ms(fn, together, reps=3):
    """``wall_ms`` of ``fn()`` on this rank of a process group, under a
    defined condition: ``together``, every rep starts on all ranks at one
    barrier (the ranks run ``fn`` at once); else the ranks take turns, each
    timing its reps while the others wait at a barrier."""
    import torch
    import torch.distributed as dist

    if not together:
        ms = None
        for r in range(dist.get_world_size()):
            if r == dist.get_rank():
                ms = wall_ms(fn, reps)
            dist.barrier()
        return ms
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        times.append(wall_ms(fn, reps=1))
    return statistics.median(times)


def dp_tracking_phase(params, model_cfg, run_launches):
    """**dp_tracking**: two streams (first frames ``DP_FIRST``) through
    ``track_window_dp`` over (cuda:0, cuda:0), the tpu_fast settings, W =
    ``WINDOW``: each stream's stats, poses, warm start and store rows
    bit-equal to the same window run alone; no host sync while both
    windows are enqueued; the wall ms of the two-stream window beside two
    lone windows."""
    import torch

    from mast3r_slam_tpu_torch.models import oracle_timing
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import dp_tracking
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod

    m = mesh_mod.make_mesh([torch.device("cuda", 0)] * 2)
    by_device = dp_tracking.replicate_params(params, m)
    lone = [window_seq(params, model_cfg, f) for f in DP_FIRST]
    ref = [lone_window(params, model_cfg, s, q) for s, q in lone]
    pairs = [window_seq(params, model_cfg, f) for f in DP_FIRST]
    systems, seqs = [p[0] for p in pairs], [p[1] for p in pairs]
    tr = systems[0].tracker
    dp = lambda: dp_tracking.track_window_dp(
        by_device, model_cfg, tr.mcfg, tr.tcfg, seqs, m,
        model_mod=oracle_timing, **_window_args(systems[0]))
    _kernels.reset_launch_counts()
    box = {}
    syncs = host_syncs_of(lambda: box.setdefault("outs", dp()))
    stats = [o.hoststats.cpu() for o in box["outs"]]
    torch.cuda.synchronize()
    launches = run_launches["dp_tracking"] = dict(_kernels.LAUNCHES)
    unequal = []
    fields = ("hoststats", "T_WCf", "idx_last", "prev_T_WC")
    bufs = ("X", "C", "N", "N_updates", "score", "T_WC", "feat", "pos",
            "dataset_idx")
    for s, (out, r, seq, (_, q)) in enumerate(zip(box["outs"], ref, seqs,
                                                  lone)):
        unequal += [f"{s}.{f}" for f in fields
                    if not torch.equal(getattr(out, f), getattr(r, f))]
        unequal += [f"{s}.kfs.{b}" for b in bufs
                    if not torch.equal(getattr(seq.kfs, b),
                                       getattr(q.kfs, b))]
    promoted = [int(st[:, 5].sum()) for st in stats]
    missing = sorted(k for k in FRONTEND if launches[k] <= 0)
    if unequal or syncs or missing or min(promoted) < 1 or any(
            float(st[:, 7].min()) < 1 for st in stats):
        raise AssertionError(
            f"dp_tracking: not bit-equal to the lone windows in {unequal}, "
            f"host syncs while enqueueing {syncs}, never launched {missing}, "
            f"keyframes promoted {promoted}, stats {stats}")
    read = lambda outs: [o.hoststats.cpu() for o in outs]
    out = {"streams": len(seqs), "window": WINDOW,
           "first_frames": list(DP_FIRST), "keyframes_promoted": promoted,
           "bit_equal_to_lone_windows": True,
           "host_syncs_while_enqueueing": len(syncs),
           "two_stream_window_ms": wall_ms(lambda: read(dp())),
           "two_lone_windows_ms": wall_ms(lambda: read(
               [lone_window(params, model_cfg, s, q) for s, q in lone])),
           "launches": {k: v for k, v in launches.items() if v}}
    log("dp_tracking: " + json.dumps(out))
    return out


def sharded_decode_phase(net, model_cfg, batch, run_launches):
    """**sharded decode**: the loop run's edge batch (``batch``: feat_i,
    pos_i, feat_j, pos_j of 3 of its edges) decoded by the ViT-L network
    with ``inference_symmetric_dp`` over (cuda:0, cuda:0) (padded to 4),
    against the one-device ``inference_symmetric``: every output within
    ``DECODE_TOL``; ms of both."""
    import torch

    from mast3r_slam_tpu_torch.models import mast3r
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import dp_tracking
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod

    m = mesh_mod.make_mesh([torch.device("cuda", 0)] * 2)
    by_device = dp_tracking.replicate_params(net, m)
    dp = lambda: dp_tracking.inference_symmetric_dp(by_device, m, *batch,
                                                    model_cfg)
    _kernels.reset_launch_counts()
    got = dp()
    torch.cuda.synchronize()
    launches = run_launches["sharded_decode"] = dict(_kernels.LAUNCHES)
    one = lambda: mast3r.inference_symmetric(net, *batch, model_cfg)
    ref = one()
    diff = {k: float((got[k].float() - ref[k].float()).abs().max())
            for k in ref}
    bad = [k for k in ref if got[k].shape != ref[k].shape
           or not torch.isfinite(got[k].float()).all()
           or not diff[k] <= DECODE_TOL]
    if bad or set(got) != set(ref) or launches["rope_qk"] <= 0:
        raise AssertionError(f"sharded decode: outputs {bad} differ (max abs "
                             f"{diff}, gate {DECODE_TOL}), launches "
                             f"{launches}")
    out = {"edges": int(batch[0].shape[0]), "shards": m.size,
           "max_abs_diff": max(diff.values()), "by_output": diff,
           "ms": time_ms(dp, reps=5, warmup=1),
           "one_device_ms": time_ms(one, reps=5, warmup=1),
           "launches": {k: v for k, v in launches.items() if v}}
    log("sharded decode: " + json.dumps(out))
    return out


def loop_edge_batch(system, n=3):
    """feat_i, pos_i, feat_j, pos_j of ``n`` edges of the run's final graph,
    loop closures first, as the backend decodes a batch."""
    import torch

    fg, kfs = system.factor_graph, system.keyframes
    e = fg.n_edges
    pairs = list(zip(fg.ii[:e].tolist(), fg.jj[:e].tolist()))
    pairs = sorted(pairs, key=lambda p: -abs(p[0] - p[1]))[:n]
    ii = torch.tensor([p[0] for p in pairs], device=kfs.feat.device)
    jj = torch.tensor([p[1] for p in pairs], device=kfs.feat.device)
    return (kfs.feat[ii].clone(), kfs.pos[ii].clone(), kfs.feat[jj].clone(),
            kfs.pos[jj].clone())


def run_children(argvs, envs, cwd):
    """Start ``python3 chip_smoke.py --phase9-child <argv>`` once per argv,
    all at once, each with its env added; wait for each under
    ``CHILD_TIMEOUT``. A nonzero exit or a timeout of any child fails (the
    others are killed). Returns each child's ``CHILD_TAG`` JSON and its
    output."""
    import os

    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase9-child", *argv],
        env=dict(os.environ, **env), cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for argv, env in zip(argvs,
                                                                   envs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError("phase 9 children failed: " + "\n".join(
            f"child {i} (rc {procs[i].returncode}): {outs[i][-4000:]}"
            for i in failed))
    found = []
    for out in outs:
        tagged = [ln for ln in out.splitlines() if ln.startswith(CHILD_TAG)]
        if len(tagged) != 1:
            raise AssertionError(f"phase 9 child printed no result: "
                                 f"{out[-4000:]}")
        found.append(json.loads(tagged[0][len(CHILD_TAG):]))
    return found, outs


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ranks(port):
    return [{"SLAM_COORDINATOR": f"127.0.0.1:{port}",
             "SLAM_NUM_PROCESSES": "2", "SLAM_PROCESS_ID": str(r),
             "SLAM_DIST_BACKEND": "gloo"} for r in range(2)]


def multi_host_ba_phase(g, run_launches):
    """**multi-host BA**: two processes that share cuda:0 meet over gloo
    (``SLAM_*``, ``SLAM_DIST_BACKEND=gloo``) and solve the loop graph from
    moved poses, edge-sharded over the 2 ranks and by the Schur rule (which
    falls back there), and the chain of ``chain_graph`` by Schur over the 2
    ranks (which eliminates). The ranks' poses must be bit-identical and
    within ``SHARD_TOL`` of the dense solve."""
    import pathlib
    import tempfile

    import torch

    from mast3r_slam_tpu_torch.slam import ba

    T = moved_poses(g)
    dense = ba.gauss_newton_rays(T, g["Xs"], g["Cs"], *g["edges"], g["n_kf"],
                                 g["cfg"])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        torch.save({"T": T.cpu(), "Xs": g["Xs"].cpu(), "Cs": g["Cs"].cpu(),
                    "edges": [a.cpu() for a in g["edges"]],
                    "n_kf": g["n_kf"], "cfg": g["cfg"]._asdict(),
                    "dense": dense.T_WC.cpu()}, tmp / "graph.pt")
        t0 = time.perf_counter()
        found, _ = run_children(
            [["ba", str(tmp / "graph.pt"), str(tmp / f"rank{r}.pt")]
             for r in range(2)], _ranks(_free_port()), str(tmp))
        wall = time.perf_counter() - t0
        results = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    unequal = [name for name in results[0]
               if not torch.equal(results[0][name], results[1][name])]
    diffs = found[0]["max_pose_diff"]
    if unequal or any(not d <= SHARD_TOL for d in diffs.values()) or any(
            f["fell_back"]["schur_chain"] for f in found):
        raise AssertionError(f"multi-host BA: ranks differ in {unequal}, "
                             f"poses from dense {diffs} (gate {SHARD_TOL}), "
                             f"{found}")
    for f in found:
        run_launches[f"multi_host_ba_rank{f['rank']}"] = f["launches"]
    out = {"ranks": 2, "backend": "gloo", "wall_s": wall,
           "ranks_bit_identical": True, "max_pose_diff": diffs,
           "iters": found[0]["iters"], "fell_back": found[0]["fell_back"],
           "ms_by_rank": [f["ms"] for f in found],
           "all_reduce_floats": found[0]["all_reduce_floats"],
           "all_reduce_ms_by_rank": [f["all_reduce_ms"] for f in found],
           "child_s": [f["seconds"] for f in found]}
    log("multi-host BA: " + json.dumps(out))
    return out


def multi_host_cli_phase(run_launches):
    """**multi-host CLI**: ``cli.main`` (the ``python -m
    mast3r_slam_tpu_torch`` entry) as two processes sharing cuda:0,
    ``--coordinator 127.0.0.1:<port> --num-hosts 2 --host-id r --ba-backend
    edge_sharded`` with ``SLAM_DIST_BACKEND=gloo``, on the cli run's
    synthetic frames and config, each writing its own ``--save-as``: both
    exit 0, their TUM files are byte-identical and hold the one-process
    run's keyframe count and poses (within ``SHARD_TOL``)."""
    import contextlib
    import importlib.util
    import io
    import os
    import pathlib
    import tempfile

    import numpy as np

    from mast3r_slam_tpu_torch import cli

    repo = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset", repo / "scripts" / "make_synth_dataset.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        seq = synth.make(tmp / "synth_seq", n_frames=16)
        base = ["--dataset", str(seq), "--config",
                str(repo / "configs" / "eval_no_calib.yaml"), "--no-viz",
                "--max-frames", "8", "--ba-backend", "edge_sharded"]
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                one = cli.main(base + ["--save-as", "one"])
        finally:
            os.chdir(cwd)
        port = _free_port()
        t0 = time.perf_counter()
        found, outs = run_children(
            [["cli"] + base + ["--save-as", f"rank{r}", "--coordinator",
                               f"127.0.0.1:{port}", "--num-hosts", "2",
                               "--host-id", str(r)] for r in range(2)],
            [{"SLAM_DIST_BACKEND": "gloo"}] * 2, str(tmp))
        wall = time.perf_counter() - t0
        tum = [(tmp / "logs" / d / "synth_seq.txt").read_bytes()
               for d in ("rank0", "rank1", "one")]
    lines = [ln for o in outs for ln in o.splitlines()
             if ln.startswith("torch.distributed:")
             or ln.startswith("global BA:")]
    T = [np.atleast_2d(np.loadtxt(io.StringIO(t.decode()))) for t in tum]
    d = (float(np.abs(T[0] - T[2]).max()) if T[0].shape == T[2].shape
         else None)
    k = [f["stats"]["keyframes"] for f in found]
    if (tum[0] != tum[1] or k[0] != k[1] or k[0] != one["keyframes"]
            or len(T[0]) != k[0] or d is None or not d <= SHARD_TOL
            or sum("over gloo" in ln for ln in lines) != 2):
        raise AssertionError(
            f"multi-host CLI: TUM files equal {tum[0] == tum[1]}, keyframes "
            f"{k} vs one process {one['keyframes']}, poses from the "
            f"one-process run {d}, lines {lines}")
    for r, f in enumerate(found):
        run_launches[f"multi_host_cli_rank{r}"] = f["launches"]
    out = {"ranks": 2, "wall_s": wall, "tum_identical": True,
           "keyframes": k[0], "max_pose_diff_one_process": d,
           "stats": found[0]["stats"], "printed": lines,
           "child_s": [f["seconds"] for f in found]}
    log("multi-host CLI: " + json.dumps(out))
    return out


def multi_host_loop_phase(loop_ref, run_launches):
    """**multi-host loop**: the loop run (``run_slam``, tpu_fast as its YAML
    states it, retrieval, 33 frames) in two processes that share cuda:0
    over gloo, with ``parallel.ba_backend: edge_sharded`` over a mesh of
    both ranks: each rank gives the dense loop run's stats and edge count,
    and the ranks' keyframe poses are bit-identical and within
    ``SHARD_TOL`` of the dense loop run's."""
    import pathlib
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        found, _ = run_children([["loop", str(tmp / f"rank{r}.pt")]
                                 for r in range(2)], _ranks(_free_port()),
                                str(tmp))
        wall = time.perf_counter() - t0
        Ts = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    ref = torch.from_numpy(loop_ref["T"])
    d = (float((Ts[0] - ref).abs().max()) if Ts[0].shape == ref.shape
         else None)
    missing = [sorted(k for k in LOOP_KERNELS if f["launches"][k] <= 0)
               for f in found]
    if (not torch.equal(Ts[0], Ts[1]) or d is None or not d <= SHARD_TOL
            or any(f["stats"] != loop_ref["stats"]
                   or f["edges"] != loop_ref["edges"]
                   or f["backend"] != "edge_sharded" for f in found)
            or any(missing)):
        raise AssertionError(
            f"multi-host loop: ranks equal {torch.equal(Ts[0], Ts[1])}, "
            f"poses from the dense loop run {d} (gate {SHARD_TOL}), never "
            f"launched {missing}, {found} vs {loop_ref['stats']}, edges "
            f"{loop_ref['edges']}")
    for f in found:
        run_launches[f"multi_host_loop_rank{f['rank']}"] = f["launches"]
    out = {"ranks": 2, "wall_s": wall, "ranks_bit_identical": True,
           "max_pose_diff_dense_loop": d, "stats": found[0]["stats"],
           "edges": found[0]["edges"],
           "backend_ms_by_rank": [f["backend_ms"] for f in found],
           "frontend_median_ms_by_rank": [f["frontend_median_ms"]
                                          for f in found],
           "child_s": [f["seconds"] for f in found]}
    log("multi-host loop: " + json.dumps(out))
    return out


def _bit_equal(a, b):
    """Equal shapes, dtypes and bits (NaN payloads and signed zeros
    included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(view[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def multi_host_kf_ba_phase(g, run_launches):
    """**multi-host keyframe-sharded BA**: the loop graph (K = 9 padded to
    10, 42 edges, solved from moved poses) keyframe-sharded across two
    processes that share cuda:0 over gloo (``--phase9-child kf_ba``): each
    rank's ``EdgePre`` bit-equal to the one-process prep of the same shard,
    the ranks' poses bit-identical and within ``SHARD_TOL`` of the dense
    solve; the bytes each rank sends and receives in the exchange, its ms,
    the solve's ms and iterations."""
    import pathlib
    import tempfile

    import torch

    from mast3r_slam_tpu_torch.slam import ba

    T = moved_poses(g)
    dense = ba.gauss_newton_rays(T, g["Xs"], g["Cs"], *g["edges"], g["n_kf"],
                                 g["cfg"])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        torch.save({"T": T.cpu(), "Xs": g["Xs"].cpu(), "Cs": g["Cs"].cpu(),
                    "edges": [a.cpu() for a in g["edges"]],
                    "n_kf": g["n_kf"], "cfg": g["cfg"]._asdict(),
                    "dense": dense.T_WC.cpu()}, tmp / "graph.pt")
        t0 = time.perf_counter()
        found, _ = run_children(
            [["kf_ba", str(tmp / "graph.pt"), str(tmp / f"rank{r}.pt")]
             for r in range(2)], _ranks(_free_port()), str(tmp))
        wall = time.perf_counter() - t0
        Ts = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    missing = [sorted(k for k in BA_KERNELS if f["launches"][k] <= 0)
               for f in found]
    if (not _bit_equal(Ts[0], Ts[1]) or any(missing)
            or not all(f["edge_pre_bit_equal"] for f in found)
            or not all(f["max_pose_diff"] <= SHARD_TOL for f in found)
            or found[0]["iters"] != found[1]["iters"]):
        raise AssertionError(f"multi-host kf BA: ranks equal "
                             f"{_bit_equal(Ts[0], Ts[1])}, never launched "
                             f"{missing}, {found}")
    for f in found:
        run_launches[f"kf_ba_rank{f['rank']}"] = f["launches"]
    keys = ("sent_bytes", "received_bytes", "exchange_ms", "prep_ms",
            "solve_ms", "iters", "max_pose_diff", "seconds")
    out = {"ranks": 2, "backend": "gloo", "keyframes": g["n_kf"],
           "keyframes_padded": found[0]["keyframes_padded"],
           "edges": found[0]["edges"], "wall_s": wall,
           "edge_pre_bit_equal": True, "ranks_bit_identical": True,
           **{f"{k}_by_rank": [f[k] for f in found] for k in keys}}
    log("multi-host kf BA: " + json.dumps(out))
    return out


def dp_serve_phase(run_launches):
    """**multi-host dp serving**: ``track_window_dp`` across two processes
    that share cuda:0 over gloo (``--phase9-child dp_serve``), one tpu_fast
    stream a rank (ViT-L, W = ``WINDOW``, ``models.oracle_timing``; rank
    r's oracle from seed r, its first frame ``DP_FIRST[r]``): each rank's
    window, outputs and store rows, bit-equal to a lone
    ``_track_window_body`` of the same stream in the same child; the ms of
    each rank's window with both ranks tracking at once (each rep started
    at a barrier), and of its lone window with the other rank waiting."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        found, _ = run_children([["dp_serve"]] * 2, _ranks(_free_port()),
                                tmp)
        wall = time.perf_counter() - t0
    missing = [sorted(k for k in FRONTEND if f["launches"][k] <= 0)
               for f in found]
    if any(f["unequal"] or f["keyframes_promoted"] < 1 or not f["all_active"]
           for f in found) or any(missing):
        raise AssertionError(f"multi-host dp serving: never launched "
                             f"{missing}, {found}")
    for f in found:
        run_launches[f"dp_serve_rank{f['rank']}"] = f["launches"]
    out = {"ranks": 2, "backend": "gloo", "window": WINDOW, "wall_s": wall,
           "bit_equal_to_lone_windows": True,
           "frame_ids_by_rank": [f["ids"] for f in found],
           "keyframes_promoted_by_rank": [f["keyframes_promoted"]
                                          for f in found],
           "window_ms_by_rank": [f["window_ms"] for f in found],
           "lone_window_ms_by_rank": [f["lone_window_ms"] for f in found],
           "child_s": [f["seconds"] for f in found]}
    log("multi-host dp serving: " + json.dumps(out))
    return out


def dp_decode_phase(batch, run_launches):
    """**multi-host sharded decode**: the loop run's 3-edge batch (padded
    to 4) through ``inference_symmetric_dp`` across two processes that
    share cuda:0 over gloo (``--phase9-child dp_decode``): every rank's
    gathered outputs bit-equal to the one-process call over
    (cuda:0, cuda:0); the bytes and ms of the all-gather."""
    import pathlib
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        torch.save([t.cpu() for t in batch], tmp / "batch.pt")
        t0 = time.perf_counter()
        found, _ = run_children(
            [["dp_decode", str(tmp / "batch.pt")]] * 2, _ranks(_free_port()),
            str(tmp))
        wall = time.perf_counter() - t0
    if any(f["unequal"] or f["launches"]["rope_qk"] <= 0 for f in found):
        raise AssertionError(f"multi-host sharded decode: {found}")
    for f in found:
        run_launches[f"dp_decode_rank{f['rank']}"] = f["launches"]
    keys = ("gather_sent_bytes", "gather_received_bytes", "gather_ms",
            "decode_ms", "seconds")
    out = {"ranks": 2, "backend": "gloo", "edges": found[0]["edges"],
           "padded_to": found[0]["padded_to"], "wall_s": wall,
           "bit_equal_to_one_process": True,
           **{f"{k}_by_rank": [f[k] for f in found] for k in keys}}
    log("multi-host sharded decode: " + json.dumps(out))
    return out


def phase9_child(kind, *args):
    """A child process of phase 9: ``ba <graph.pt> <out.pt>``, ``loop
    <out.pt>``, ``cli <argv...>``, ``kf_ba <graph.pt> <out.pt>``,
    ``dp_serve`` or ``dp_decode <batch.pt>``. Prints one ``CHILD_TAG`` JSON
    line; returns 0."""
    import torch

    from mast3r_slam_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    if kind == "cli":
        from mast3r_slam_tpu_torch import cli

        _kernels.reset_launch_counts()
        result = {"stats": cli.main(list(args))}
        torch.cuda.synchronize()
        result["launches"] = dict(_kernels.LAUNCHES)
    elif kind in _CHILDREN:
        result = _CHILDREN[kind](*args)
    else:
        raise ValueError(f"unknown phase 9 child {kind!r}")
    result["seconds"] = time.perf_counter() - t0
    print(CHILD_TAG + json.dumps(result), flush=True)
    return 0


def _child_loop(out_path):
    import torch
    import torch.distributed as dist

    from mast3r_slam_tpu_torch.config import tpu_fast_config
    from mast3r_slam_tpu_torch.models import oracle, oracle_timing
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod
    from mast3r_slam_tpu_torch.slam import retrieval
    from mast3r_slam_tpu_torch.utils import timing

    if not mesh_mod.init_distributed(device="cuda"):
        raise RuntimeError("phase 9 child: no process group")
    # main()'s network, oracle and retrieval head, from the same seeds
    net, model_cfg = _child_vit_l()
    orc = oracle.make_params(oracle.make_traj(N_TRAJ).cuda(),
                             desc_dim=model_cfg.desc_dim, seed=0,
                             device="cuda")
    rparams = retrieval.init_retrieval_params(
        torch.Generator(device="cuda").manual_seed(1),
        backbone_dim=model_cfg.enc_embed_dim, proj_dim=1024,
        codebook_size=CODEBOOK, device="cuda")
    m = mesh_mod.make_mesh()
    _kernels.reset_launch_counts()
    with timing.recording() as rec:
        system, times, backend = run_slam(
            tpu_fast_config(), oracle_timing.make_params(net, orc),
            model_cfg, N_LOOP, KF_LOOP, retrieval_params=rparams,
            edge_capacity=EDGE_CAPACITY_LOOP,
            parallel={"ba_backend": "edge_sharded"}, mesh=m)
    torch.cuda.synchronize()
    k = len(system.keyframes)
    torch.save(system.keyframes.T_WC[:k].cpu(), out_path)
    fg = system.factor_graph
    out = {"rank": dist.get_rank(), "mesh_size": m.size,
           "stats": system.stats, "edges": fg.n_edges,
           "backend": last_solve(rec).get("backend"),
           "launches": dict(_kernels.LAUNCHES),
           "frontend_median_ms": statistics.median(times[1:]),
           "backend_ms": [round(b[0], 3) for b in backend]}
    dist.destroy_process_group()
    return out


def _child_ba(graph_path, out_path):
    import torch
    import torch.distributed as dist

    from mast3r_slam_tpu_torch.config import BAConfig
    from mast3r_slam_tpu_torch.models import mast3r
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import dist_ba
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod
    from mast3r_slam_tpu_torch.slam import ba

    if not mesh_mod.init_distributed(device="cuda"):
        raise RuntimeError("phase 9 child: no process group")
    g = torch.load(graph_path)
    T, Xs, Cs = (g[k].cuda() for k in ("T", "Xs", "Cs"))
    edges = [a.cuda() for a in g["edges"]]
    n_kf, cfg, dense = g["n_kf"], BAConfig(**g["cfg"]), g["dense"].cuda()
    m = mesh_mod.make_mesh()
    Tc, Xc, Cc, ec, _ = chain_graph(mast3r.MASt3RConfig())
    chain_dense = ba.gauss_newton_rays(Tc, Xc, Cc, *ec, CHAIN_KF, cfg).T_WC
    solves = {
        "edge_sharded": lambda: dist_ba.gauss_newton_rays_dist(
            T, Xs, Cs, *_padded(edges, m.size), n_kf, m, cfg),
        "schur": lambda: _schur_or_fallback(T, Xs, Cs, None, edges, n_kf, m,
                                            cfg, "rays", None),
        "schur_chain": lambda: _schur_or_fallback(
            Tc, Xc, Cc, None, ec, CHAIN_KF, m, cfg, "rays", None)}
    refs = {"edge_sharded": dense, "schur": dense, "schur_chain": chain_dense}
    _kernels.reset_launch_counts()
    got = {name: fn() for name, fn in solves.items()}
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    res = {k: (v if hasattr(v, "T_WC") else v[0]) for k, v in got.items()}
    # both ranks make the same calls in the same order, so every
    # collective below pairs up
    ms = {name: time_ms(fn, reps=3, warmup=0) for name, fn in solves.items()}
    flat = torch.zeros(7 * T.shape[0] * (7 * T.shape[0] + 1), device="cuda")
    ar_ms = time_ms(lambda: dist.all_reduce(flat), reps=20, warmup=3)
    torch.save({k: r.T_WC.cpu() for k, r in res.items()}, out_path)
    out = {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
           "mesh_size": m.size,
           "max_pose_diff": {k: float((r.T_WC - refs[k]).abs().max())
                             for k, r in res.items()},
           "iters": {k: r.iters for k, r in res.items()},
           "fell_back": {k: bool(v[2]) if not hasattr(v, "T_WC") else False
                         for k, v in got.items()},
           "ms": ms, "all_reduce_ms": ar_ms, "all_reduce_floats": flat.numel(),
           "launches": launches}
    dist.destroy_process_group()
    return out


def _child_kf_ba(graph_path, out_path):
    import torch
    import torch.distributed as dist

    from mast3r_slam_tpu_torch.config import BAConfig
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import dist_ba
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod

    if not mesh_mod.init_distributed(device="cuda"):
        raise RuntimeError("phase 9 child: no process group")
    me = dist.get_rank()
    g = torch.load(graph_path)
    T, Xs, Cs = (g[k].cuda() for k in ("T", "Xs", "Cs"))
    n_kf, cfg, dense = g["n_kf"], BAConfig(**g["cfg"]), g["dense"].cuda()
    m = mesh_mod.make_mesh()
    ii, jj, idx, vm, Q, mask = _padded([a.cuda() for a in g["edges"]],
                                       m.size)
    Xp, Cp = (mesh_mod.pad_to_multiple(a, m.size) for a in (Xs, Cs))
    stride = cfg.point_stride

    def prep():
        Xs_b, Cs_b = dist_ba.shard_keyframe_store(m, Xp, Cp)
        return dist_ba.prep_edges_kf_sharded(m, Xs_b, Cs_b, ii, jj, idx, vm,
                                             stride=stride)

    def solve(pres):
        return dist_ba.gauss_newton_rays_dist_pre(T, pres, ii, jj, vm, Q,
                                                  mask, n_kf, m, cfg)

    _kernels.reset_launch_counts()
    pres = prep()
    res = solve(pres)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    # the one-process prep of the same graph over (cuda:0, cuda:0)
    one = mesh_mod.Mesh((torch.device("cuda", 0),) * m.size)
    ref = dist_ba.prep_edges_kf_sharded(
        one, *dist_ba.shard_keyframe_store(one, Xp, Cp), ii, jj, idx, vm,
        stride=stride)
    equal = all(_bit_equal(a, b) for l, pre in enumerate(pres)
                for a, b in zip(pre, ref[m.first_shard + l]))
    # the exchange alone, on the points it moved
    _, send, recv, _ = dist_ba.kf_gather(
        m, *dist_ba.shard_keyframe_store(m, Xp, Cp), ii, jj, idx, vm, stride)
    nbytes = lambda shape: math.prod(shape) * 4
    sent = sum(t.numel() * t.element_size() for r, ts in enumerate(send)
               if r != me for t in ts)
    received = sum(nbytes(shape) for r, specs in enumerate(recv) if r != me
                   for shape, _ in specs)
    # both ranks make the same calls in the same order: the collectives
    # pair up
    ex_ms = time_ms(lambda: mesh_mod.exchange(m, send, recv,
                                              dtypes=(torch.float32,)),
                    reps=10, warmup=2)
    prep_ms = time_ms(prep, reps=3, warmup=1)
    solve_ms = time_ms(lambda: solve(pres), reps=3, warmup=1)
    torch.save(res.T_WC.cpu(), out_path)
    out = {"rank": me, "mesh_size": m.size,
           "keyframes_padded": Xp.shape[0], "edges": int(ii.shape[0]),
           "edge_pre_bit_equal": equal,
           "max_pose_diff": float((res.T_WC - dense).abs().max()),
           "iters": res.iters, "sent_bytes": sent,
           "received_bytes": received, "exchange_ms": ex_ms,
           "prep_ms": prep_ms, "solve_ms": solve_ms, "launches": launches}
    dist.destroy_process_group()
    return out


def _child_vit_l():
    """main()'s ViT-L network from the same seed."""
    import torch

    from mast3r_slam_tpu_torch.models import mast3r

    model_cfg = mast3r.MASt3RConfig(head_dtype="bfloat16")
    net = mast3r.init_params(
        model_cfg, torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    return net, model_cfg


def _child_dp_serve():
    import torch
    import torch.distributed as dist

    from mast3r_slam_tpu_torch.models import oracle, oracle_timing
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import dp_tracking
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod

    if not mesh_mod.init_distributed(device="cuda"):
        raise RuntimeError("phase 9 child: no process group")
    me = dist.get_rank()
    net, model_cfg = _child_vit_l()
    # this rank's stream: its own oracle scene (seed) and frames
    orc = oracle.make_params(oracle.make_traj(N_TRAJ).cuda(),
                             desc_dim=model_cfg.desc_dim, seed=me,
                             device="cuda")
    params = oracle_timing.make_params(net, orc)
    first = DP_FIRST[me]
    m = mesh_mod.make_mesh()
    lone_sys, lone_seq = window_seq(params, model_cfg, first)
    ref = lone_window(params, model_cfg, lone_sys, lone_seq)
    system, seq = window_seq(params, model_cfg, first)
    tr = system.tracker
    dp = lambda: dp_tracking.track_window_dp(
        dp_tracking.replicate_params(params, m), model_cfg, tr.mcfg, tr.tcfg,
        [seq], m, model_mod=oracle_timing, **_window_args(system))
    _kernels.reset_launch_counts()
    (got,) = dp()
    stats = got.hoststats.cpu()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    fields = ("hoststats", "T_WCf", "idx_last", "prev_T_WC")
    bufs = ("X", "C", "N", "N_updates", "score", "T_WC", "feat", "pos",
            "dataset_idx")
    unequal = [f for f in fields if not _bit_equal(getattr(got, f),
                                                   getattr(ref, f))]
    unequal += [f"kfs.{b}" for b in bufs
                if not _bit_equal(getattr(seq.kfs, b),
                                  getattr(lone_seq.kfs, b))]
    out = {"rank": me, "mesh_size": m.size, "ids": seq.frame_ids,
           "unequal": unequal,
           "keyframes_promoted": int(stats[:, 5].sum()),
           "all_active": bool((stats[:, 7] == 1).all()),
           # both ranks' windows at once, each rep started at a barrier
           "window_ms": ranks_wall_ms(lambda: dp()[0].hoststats.cpu(),
                                      together=True),
           # the ranks in turn, the other waiting at a barrier
           "lone_window_ms": ranks_wall_ms(lambda: lone_window(
               params, model_cfg, lone_sys, lone_seq).hoststats.cpu(),
               together=False),
           "launches": launches}
    dist.destroy_process_group()
    return out


def _child_dp_decode(batch_path):
    import torch
    import torch.distributed as dist

    from mast3r_slam_tpu_torch.models import mast3r
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.parallel import dp_tracking
    from mast3r_slam_tpu_torch.parallel import mesh as mesh_mod

    if not mesh_mod.init_distributed(device="cuda"):
        raise RuntimeError("phase 9 child: no process group")
    me = dist.get_rank()
    net, model_cfg = _child_vit_l()
    batch = [t.cuda() for t in torch.load(batch_path)]
    m = mesh_mod.make_mesh()
    by_device = dp_tracking.replicate_params(net, m)
    dp = lambda: dp_tracking.inference_symmetric_dp(by_device, m, *batch,
                                                    model_cfg)
    _kernels.reset_launch_counts()
    got = dp()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    one = mesh_mod.Mesh((torch.device("cuda", 0),) * m.size)
    ref = dp_tracking.inference_symmetric_dp(
        dp_tracking.replicate_params(net, one), one, *batch, model_cfg)
    unequal = sorted(k for k in ref if k not in got
                     or not _bit_equal(got[k], ref[k]))
    # the all-gather alone, on this rank's decoded chunk
    chunks = mesh_mod.shard_edges(m, *(mesh_mod.pad_to_multiple(t, m.size)
                                       for t in batch))
    local = mast3r.inference_symmetric(net, *(c[0] for c in chunks),
                                       model_cfg)
    mine = tuple(local[k] for k in sorted(local))
    sent = sum(t.numel() * t.element_size() for t in mine)
    out = {"rank": me, "mesh_size": m.size, "edges": batch[0].shape[0],
           "padded_to": chunks[0][0].shape[0] * m.size, "unequal": unequal,
           "gather_sent_bytes": sent,
           "gather_received_bytes": sent * (m.world_size - 1),
           "gather_ms": time_ms(lambda: mesh_mod.all_gather_shards(
               m, [mine]), reps=10, warmup=2),
           "decode_ms": time_ms(dp, reps=3, warmup=1),
           "launches": launches}
    dist.destroy_process_group()
    return out


_CHILDREN = {"ba": _child_ba, "loop": _child_loop, "kf_ba": _child_kf_ba,
             "dp_serve": _child_dp_serve, "dp_decode": _child_dp_decode}


# -- phase 10: training -------------------------------------------------------

TRAIN_STEPS = 3          # trainer steps of ViT-L MASt3R at full width
TRAIN_FRAMES = 8         # rendered oracle frames those steps draw pairs from
# one attention call per encoder block, two per decoder block and stream:
# rope_qk and rope_qk_bwd launch this often per ViT-L step
ATTN_CALLS = 24 + 2 * 12 * 2
# the shortened rehearsal: the trainer's default model (4x128 encoder, 4x96
# decoders) at 384x512, its 1,200 steps and 48 frames cut to these
REHEARSAL_STEPS, REHEARSAL_FRAMES = 400, 16
# the full-width step's gradient through the kernels against the same step
# through rope_qk_plain: both kernels are bit-equal to their plain versions,
# so what differs is the order of the atomic sums in the backward of
# attention, bilinear upsampling and transposed convolutions (rounding,
# carried back through 24 encoder and 12 decoder blocks); 1e-4 of a tensor's
# largest entry is the CPU tests' margin between the port's gradient and
# JAX's
GRAD_TOL = 1e-4
PROBE_LR = 1e-5          # the full-width steps again at this learning rate
REHEARSAL_TIMEOUT = 300  # seconds the rehearsal's CLI child may take
# what the CLI with configs/base.yaml launches when it tracks and solves
REHEARSAL_KERNELS = {"scharr_rays", "iter_proj", "refine_matches", "gn_step",
                     "rope_qk", "gather_rows", "ba_edge_terms", "take_along"}


def check_rope_bwd(records, model_cfg):
    """``rope_qk_bwd`` against autograd through ``rope_qk_plain`` at the
    shapes of both trainer runs, gradients in fp32 and bf16, q and k strided
    views of a qkv projection: bit-equal, and so is the gradient that
    ``rope_qk``'s autograd Function scatters into qkv. The full-width step
    (ViT-L, d = 64: encoder on both views of 2 pairs, decoder on the 2 pairs
    of one stream, and 4) and the rehearsal's student (d = 32 and 24, which
    take the kernels' scalar branch: encoder 4, decoder 2); at the student's
    shapes ``rope_qk`` itself is held bit-equal too (fp32 and bf16 out) and
    gets its own records. Each backward is timed beside the forward at the
    same shape; the bound is the forward's bytes."""
    import torch

    from mast3r_slam_tpu_torch import distill
    from mast3r_slam_tpu_torch.models import rope

    student = distill.model_config(distill._parser().parse_args([]))
    g = torch.Generator(device="cuda").manual_seed(10)
    fwd_of = ("mast3r_slam_tpu/models/rope.py:33 (rope_2d on q and k, "
              "models/vit.py:57-59 and :68-70, XLA)")
    bwd_of = ("mast3r_slam_tpu/models/rope.py:33 (the gradient of rope_2d "
              "on q and k, models/vit.py:57-59 and :68-70, that "
              "jax.value_and_grad derives in scripts/distill_oracle.py:141, "
              "XLA)")
    for model, cfg, shapes in (
            ("ViT-L", model_cfg,
             (("encoder", cfg_dims(model_cfg, "enc"), (4,)),
              ("decoder", cfg_dims(model_cfg, "dec"), (2, 4)))),
            ("student", student,
             (("encoder", cfg_dims(student, "enc"), (4,)),
              ("decoder", cfg_dims(student, "dec"), (2,))))):
        h, w = cfg.img_size
        n_tok = cfg.num_patches
        ys = torch.arange(h // 16, device="cuda").repeat_interleave(w // 16)
        xs = torch.arange(w // 16, device="cuda").repeat(h // 16)
        pos = torch.stack([ys, xs], dim=-1)
        for part, (heads, d), batches in shapes:
            for b in batches:
                qkv = torch.randn(b, n_tok, 3, heads, d, generator=g,
                                  device="cuda")
                tabs = rope.rope_tables(pos.expand(b, n_tok, 2), d,
                                        cfg.rope_base, torch.float32)
                el = b * heads * n_tok * d
                shape = f"{model} {part} ({b},{heads},{n_tok},{d})"
                qd, kd = (qkv[:, :, i].transpose(1, 2) for i in (0, 1))
                if model == "student":
                    err = max(float((x.float() - y.float()).abs().max())
                              for dt in (torch.float32, torch.bfloat16)
                              for x, y in zip(
                                  rope.rope_qk(qd, kd, tabs, tabs, dt),
                                  rope.rope_qk_plain(qd, kd, tabs, tabs, dt)))
                    if err != 0.0:
                        raise AssertionError(f"rope_qk {shape}: differs "
                                             f"from the plain version by "
                                             f"{err}")
                    kernel_record(
                        records, "rope_qk", f"{shape} q,k fp32 -> fp32 "
                        "(strided views of the qkv projection)", err,
                        lambda: rope.rope_qk(qd, kd, tabs, tabs,
                                             torch.float32),
                        lambda: rope.rope_qk_plain(qd, kd, tabs, tabs,
                                                   torch.float32),
                        None, 2 * el * 8 + 2 * b * n_tok * d * 4, 2 * el * 3,
                        "fp32", fwd_of,
                        "mast3r_slam_tpu_torch/csrc/rope_qk.cu",
                        tolerance="bit-equal, fp32 and bf16 outputs")
                for dt in (torch.float32, torch.bfloat16):
                    leaf = qkv.clone().requires_grad_()
                    q, k = (leaf[:, :, i].transpose(1, 2) for i in (0, 1))
                    out = rope.rope_qk_plain(q, k, tabs, tabs, dt)
                    gq, gk = (torch.randn(o.shape, generator=g,
                                          device="cuda").to(dt) for o in out)
                    ref_q, ref_k, ref_qkv = torch.autograd.grad(
                        out, (q, k, leaf), (gq, gk))
                    dq, dk = rope.rope_qk_bwd(gq, gk, tabs, tabs)
                    leaf2 = qkv.clone().requires_grad_()
                    q2, k2 = (leaf2[:, :, i].transpose(1, 2) for i in (0, 1))
                    torch.autograd.backward(
                        rope.rope_qk(q2, k2, tabs, tabs, dt), (gq, gk))
                    err = max(float((a - r).abs().max()) for a, r in (
                        (dq, ref_q), (dk, ref_k), (leaf2.grad, ref_qkv)))
                    if err != 0.0:
                        raise AssertionError(f"rope_qk_bwd {shape} {dt}: "
                                             f"differs from autograd "
                                             f"through the plain version "
                                             f"by {err}")
                    esize = 4 if dt == torch.float32 else 2
                    kernel_record(
                        records, "rope_qk_bwd",
                        f"{shape} dq,dk from {str(dt)[6:]} gradients -> fp32",
                        err, lambda: rope.rope_qk_bwd(gq, gk, tabs, tabs),
                        lambda: rope.rope_qk_bwd_plain(gq, gk, tabs, tabs),
                        None, 2 * el * (esize + 4) + 2 * b * n_tok * d * 4,
                        2 * el * 3, "fp32", bwd_of,
                        "mast3r_slam_tpu_torch/csrc/rope_qk_bwd.cu",
                        tolerance="bit-equal to autograd through "
                        "rope_qk_plain (dq, dk and the qkv gradient of "
                        "rope_qk's Function)",
                        forward_ms=device_ms(lambda: rope.rope_qk(
                            qd, kd, tabs, tabs, dt)))


def cfg_dims(cfg, part):
    """(heads, head dim) of a MASt3RConfig's encoder ("enc") or decoder
    ("dec") attention."""
    heads = getattr(cfg, f"{part}_num_heads")
    return heads, getattr(cfg, f"{part}_embed_dim") // heads


def full_width_grads(model, distill, cfg, oparams, data, i, j):
    """One forward and backward of the trainer's loss on pairs (i, j):
    (loss, {name: gradient} of the parameters the loss reaches)."""
    model.zero_grad(set_to_none=True)
    targets = distill.pair_targets(oparams, data[2], data[3], i, j, cfg)
    loss, _ = distill.loss_fn(model, cfg, data[0], targets, i, j)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def train_full_width(run_launches):
    """Trainer steps of ViT-L MASt3R at its published widths, 384x512, fp32
    transformer and head (as the trainer sets them), the trainer's batch of
    2 pairs drawn from rendered oracle frames.

    First the gradient of the first step's pairs at the initial weights,
    twice: through ``rope_qk``'s autograd Function (the two kernels) and
    with ``rope_qk_plain`` in its place (autograd); the losses must agree
    within ``GRAD_TOL`` relative, every reached parameter's gradient must be
    nonzero and agree within ``GRAD_TOL`` of that tensor's largest entry.
    Then ``TRAIN_STEPS`` counted steps: every gradient finite, every
    parameter the loss reaches changed, ``ATTN_CALLS`` launches of
    ``rope_qk`` and of ``rope_qk_bwd`` a step; ms a step split into forward
    (oracle targets and loss), backward and optimizer (CUDA events), peak
    memory. Last, as a reading and not a gate, the same steps from the same
    weights at ``PROBE_LR``."""
    import torch

    from mast3r_slam_tpu_torch import distill
    from mast3r_slam_tpu_torch.models import mast3r, oracle, rope, vit
    from mast3r_slam_tpu_torch.ops import _kernels

    cfg = mast3r.MASt3RConfig(dtype="float32", head_dtype="float32")
    args = distill._parser().parse_args(["--frames", str(TRAIN_FRAMES),
                                         "--steps", str(TRAIN_STEPS)])
    oparams = oracle.make_params(oracle.make_traj(args.frames),
                                 desc_dim=cfg.desc_dim,
                                 desc_freq=args.desc_freq, device="cuda")
    init = lambda: mast3r.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda", trainable=True)
    model = init()
    n_params = sum(p.numel() for p in model.parameters())
    data = distill.train_data(args, cfg, oparams)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    pairs = [distill.sample_pairs(gen, args.frames, args.batch)
             for _ in range(args.steps)]

    loss_k, grads_k = full_width_grads(model, distill, cfg, oparams, data,
                                       *pairs[0])
    try:
        vit.rope_qk = rope.rope_qk_plain
        loss_p, grads_p = full_width_grads(model, distill, cfg, oparams,
                                           data, *pairs[0])
    finally:
        vit.rope_qk = rope.rope_qk
    zero = sorted(k for k, gr in grads_k.items() if not bool(gr.any()))
    rel = {k: float((gr - grads_p[k]).abs().max() / grads_p[k].abs().max())
           for k, gr in grads_k.items() if k not in zero}
    worst = max(rel, key=rel.get)
    if (zero or set(grads_k) != set(grads_p)
            or abs(loss_k - loss_p) > GRAD_TOL * abs(loss_p)
            or rel[worst] > GRAD_TOL):
        raise AssertionError(f"full-width gradient: loss {loss_k} with the "
                             f"kernels, {loss_p} with rope_qk_plain; zero "
                             f"gradients {zero[:10]}; largest difference "
                             f"{rel[worst]} of the tensor's largest entry "
                             f"({worst}); tolerance {GRAD_TOL}")
    log(f"train full width, first step's gradient through the kernels vs "
        f"rope_qk_plain: loss {loss_k} / {loss_p}, {len(rel)} gradients, "
        f"all nonzero, largest difference {rel[worst]} of the tensor's "
        f"largest entry ({worst}), median "
        f"{statistics.median(rel.values())}; tolerance {GRAD_TOL}")
    del grads_k, grads_p

    opt = distill.make_optimizer(model, args.lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    steps, bwd_counts, losses = [], [], []
    reached = None
    for t, (i, j) in enumerate(pairs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        w0 = time.perf_counter()
        ev[0].record()
        targets = distill.pair_targets(oparams, data[2], data[3], i, j, cfg)
        loss, _ = distill.loss_fn(model, cfg, data[0], targets, i, j)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        bwd_counts.append(_kernels.LAUNCHES["rope_qk_bwd"])
        named = [(k, p.grad) for k, p in model.named_parameters()
                 if p.grad is not None]
        finite = torch.stack([torch.isfinite(gr).all() for _, gr in named])
        ev[3].record()
        distill.optimizer_step(opt, t, args.lr, args.steps)
        ev[4].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        loss = float(loss.detach())
        if not bool(finite.all()) or not math.isfinite(loss):
            bad = [k for (k, _), ok in zip(named, finite.tolist()) if not ok]
            raise AssertionError(f"full-width step {t}: loss {loss}, "
                                 f"non-finite gradients {bad[:10]}")
        reached = reached or {k for k, _ in named}
        losses.append(loss)
        steps.append({"forward": ev[0].elapsed_time(ev[1]),
                      "backward": ev[1].elapsed_time(ev[2]),
                      "optimizer": ev[3].elapsed_time(ev[4]),
                      "step_device": ev[0].elapsed_time(ev[4]),
                      "step_wall": wall * 1e3})
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = run_launches["train_full_width"] = dict(_kernels.LAUNCHES)
    per_step = [b - a for a, b in zip([0] + bwd_counts, bwd_counts)]
    if (per_step != [ATTN_CALLS] * args.steps
            or launches["rope_qk"] != ATTN_CALLS * args.steps):
        raise AssertionError(f"full-width steps: rope_qk_bwd launches a step "
                             f"{per_step}, rope_qk {launches['rope_qk']}; "
                             f"expected {ATTN_CALLS} a step")
    trained = dict(model.named_parameters())
    del opt, named, loss, targets
    model = init()
    unchanged = [k for k, p in model.named_parameters()
                 if torch.equal(p, trained[k])]
    if set(unchanged) & reached:
        raise AssertionError(f"full-width steps left parameters unchanged: "
                             f"{sorted(set(unchanged) & reached)[:10]}")
    log(f"train full width: ViT-L MASt3R {n_params / 1e6:.1f} M params "
        f"(fp32), 384x512, batch {args.batch} pairs, {args.steps} steps, "
        f"losses {losses}, per step (ms): {json.dumps(steps)}; peak device "
        f"memory {peak:.3f} GiB; rope_qk_bwd launches a step {per_step}; "
        f"{len(reached)} of {len(trained)} parameters reached by the loss, "
        f"all changed; not reached: {sorted(set(trained) - reached)} "
        f"(unchanged: {sorted(unchanged)})")
    del trained
    args.lr = PROBE_LR
    opt = distill.make_optimizer(model, args.lr)
    probe = [float(distill.train_step(model, opt, t, args, cfg, data, i, j)[0])
             for t, (i, j) in enumerate(pairs)]
    log(f"train full width at lr {PROBE_LR} (a reading, not gated), the "
        f"same pairs from the same weights: losses {probe}")
    del model, opt, data
    torch.cuda.empty_cache()


def rehearsal_phase(run_launches):
    """``distill.main`` at the trainer's default model and 384x512, steps
    and frames cut to ``REHEARSAL_STEPS`` / ``REHEARSAL_FRAMES``: the CLI
    child (``REHEARSAL_TIMEOUT``) exits 0 with one pose per frame and
    launches ``REHEARSAL_KERNELS``; the mean loss of the last 10 steps below
    that of the first 10. ATE and RPE are printed, not gated."""
    import pathlib
    import tempfile

    from mast3r_slam_tpu_torch import distill
    from mast3r_slam_tpu_torch.ops import _kernels

    with tempfile.TemporaryDirectory() as tmp:
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            m = distill.main(["--steps", str(REHEARSAL_STEPS), "--frames",
                              str(REHEARSAL_FRAMES), "--out",
                              str(pathlib.Path(tmp) / "rehearsal")],
                             slam_timeout=REHEARSAL_TIMEOUT)
        except SystemExit as e:
            raise AssertionError(f"rehearsal: {e}") from None
        wall = time.perf_counter() - t0
    run_launches["rehearsal_train"] = dict(_kernels.LAUNCHES)
    child = m.get("launches")
    if child is None:
        raise AssertionError("rehearsal: the CLI printed no kernel launches")
    run_launches["rehearsal_cli"] = child
    missing = sorted(k for k in REHEARSAL_KERNELS if child.get(k, 0) <= 0)
    if (missing or m["poses"] != REHEARSAL_FRAMES
            or not m["loss_last10"] < m["loss_first10"]):
        raise AssertionError(f"rehearsal: poses {m['poses']} of "
                             f"{REHEARSAL_FRAMES} frames, loss first 10 "
                             f"{m['loss_first10']} last 10 "
                             f"{m['loss_last10']}, the CLI never launched "
                             f"{missing}: {m}")
    log(f"rehearsal (cut: {REHEARSAL_STEPS} of 1200 steps, "
        f"{REHEARSAL_FRAMES} of 48 frames; 4x128 / 4x96 model at 384x512): "
        f"{wall:.2f} s, " + json.dumps(m))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from mast3r_slam_tpu_torch import native
    from mast3r_slam_tpu_torch.config import base_config, tpu_fast_config
    from mast3r_slam_tpu_torch.models import mast3r, oracle, oracle_timing
    from mast3r_slam_tpu_torch.ops import _kernels
    from mast3r_slam_tpu_torch.slam import retrieval

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({smi}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    # the run loop's and the CLI's host modules (phase 5 needs all three)
    import cv2
    import PIL
    import yaml

    log(f"host modules: yaml {yaml.__version__}, PIL {PIL.__version__}, "
        f"cv2 {cv2.__version__}")

    t0 = time.perf_counter()
    outs = _kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(sorted(outs)) or 'cached'})")
    for name, text in sorted(outs.items()):
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"  {name}: {regs}")
    t0 = time.perf_counter()
    native.load()
    log(f"native ASMK build: {time.perf_counter() - t0:.2f} s "
        f"({native.lib_path().name} from {native.SOURCE.name})")

    model_cfg = mast3r.MASt3RConfig(head_dtype="bfloat16")
    h, w = model_cfg.img_size
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    net = mast3r.init_params(model_cfg, g, device="cuda")
    torch.cuda.synchronize()
    log(f"ViT-L MASt3R init: {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in net.parameters()) / 1e6:.1f} M params")

    # the smooth orbit that keeps the oracle scene in view (the rehearsal's
    # path; bench.py::_make_traj at phase 0)
    traj = oracle.make_traj(N_TRAJ).cuda()
    orc = oracle.make_params(traj, desc_dim=model_cfg.desc_dim, seed=0,
                             device="cuda")
    params = oracle_timing.make_params(net, orc)

    # phase 2: every kernel against its plain version
    t0 = time.perf_counter()
    records = check_kernels(model_cfg, orc)
    check_conv_3xtf32(records)
    log(f"phase 2 (kernels against their plain versions): "
        f"{time.perf_counter() - t0:.2f} s")

    # phase 3: the main path, tpu_fast presets; frontend and backend
    run_launches = {}       # run label -> kernel launches of that run

    def drive(label, preset, n_frames, kf_every, expect, K=None, **kw):
        _kernels.reset_launch_counts()
        system, times, backend = run_slam(preset, params, model_cfg,
                                          n_frames, kf_every, K, **kw)
        launches = run_launches[label] = dict(_kernels.LAUNCHES)
        rmse, extent = assert_healthy(system, n_frames, kf_every, traj, label)
        missing = sorted(k for k in expect if launches[k] <= 0)
        if missing:
            raise AssertionError(f"{label} run never launched {missing}: "
                                 f"{launches}")
        med = statistics.median(times[1:])
        fg = system.factor_graph
        log(f"{label} main path: {n_frames} frames, stats {system.stats}, "
            f"edges {fg.n_edges} (dropped {fg.edges_dropped}), launches "
            f"{launches}, keyframe RMSE after BA {rmse:.6f} of extent "
            f"{extent:.6f}")
        log(f"{label} frontend ms per frame (tracked): median {med:.3f}, all "
            f"{[round(t, 3) for t in times]}; frames/s {1e3 / med:.3f}")
        log(f"{label} backend per keyframe (wall ms, GN iterations, "
            f"keyframes, edges): "
            f"{[(round(t, 3), it, k, e) for t, it, k, e in backend]}")
        return system, launches

    torch.cuda.reset_peak_memory_stats()
    system, _ = drive("tpu_fast", tpu_fast_config(), N_FAST, KF_FAST,
                      FRONTEND | BA_KERNELS)
    k = len(system.keyframes)
    fast_ref = {"stats": dict(system.stats),
                "ids": system.keyframes.dataset_idx[:k].cpu().numpy(),
                "T": system.keyframes.T_WC[:k].cpu().numpy()}
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"(edge buffers at capacity {EDGE_CAPACITY}: "
        f"{(EDGE_CAPACITY + 1) * h * w * 9 / 2**20:.0f} MiB)")
    log("the tracker's solve on an oracle frame: " + json.dumps(
        check_oracle_gn(params, model_cfg, system.tracker.mcfg,
                        system.tracker.tcfg)))
    syncs = host_syncs(system, N_FAST, oracle_timing.make_frame_image(
        N_FAST, h, w))
    log("host syncs of one tracked frame: " + json.dumps(syncs))

    # the base presets: radius 3, dilation 5, 10 LM iterations; edges by
    # symmetric decode + match, bundle adjustment on every point
    # every kernel but the loop run's and the separable search's
    every = set(_kernels.SOURCES) - {"coarse_correlate", "refine_separable",
                                     "rope_qk_bwd"}
    sys_b, _ = drive("base", base_config(), N_BASE, KF_BASE, every)
    log("the tracker's solve on an oracle frame, base: " + json.dumps(
        check_oracle_gn(params, model_cfg, sys_b.tracker.mcfg,
                        sys_b.tracker.tcfg)))

    # calibrated base run: pixel + log-depth residuals, the oracle's pinhole
    f = 0.8 * w
    K = [[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]]
    drive("calib", base_config(), N_CALIB, KF_CALIB, every, K=K)

    # phase 4: loop closure and relocalization; tpu_fast as its YAML states
    # it, a seeded random retrieval head at the published sizes
    g = torch.Generator(device="cuda").manual_seed(1)
    rparams = retrieval.init_retrieval_params(
        g, backbone_dim=model_cfg.enc_embed_dim, proj_dim=1024,
        codebook_size=CODEBOOK, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    sys_l, _ = drive("loop", tpu_fast_config(), N_LOOP, KF_LOOP,
                        LOOP_KERNELS, retrieval_params=rparams,
                        edge_capacity=EDGE_CAPACITY_LOOP)
    log("ba_edge_terms on the loop run's final graph: "
        + json.dumps(check_graph(graph_args(sys_l))))
    scene_cost("the loop run", sys_l)
    loop_ref = {"stats": dict(sys_l.stats),
                "edges": sys_l.factor_graph.n_edges,
                "T": sys_l.keyframes.T_WC[:len(sys_l.keyframes)].cpu()
                .numpy()}
    loop_graph = loop_graph_of(sys_l)       # for phases 8 and 9
    decode_batch = loop_edge_batch(sys_l)   # for phase 9
    log(f"loop peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (codebook "
        f"{CODEBOOK * 1024 * 4 / 2**20:.0f} MiB, edge buffers at capacity "
        f"{EDGE_CAPACITY_LOOP}: "
        f"{(EDGE_CAPACITY_LOOP + 1) * h * w * 9 / 2**20:.0f} MiB)")
    del sys_l

    teleports = {
        "teleport_reloc": (teleport_traj(4, 5), 0, {
            "mode": "RELOC", "stats": {
                "skipped": (">=", 1), "reloc_failed": (">=", 2),
                "frames_reloc": (">=", 2), "relocs": ("==", 0),
                "reinits": ("==", 0)}}, set()),
        "teleport_reinit": (teleport_traj(4, 5), 2, {
            "mode": "TRACKING", "stats": {
                "skipped": ("==", 1), "reloc_failed": ("==", 2),
                "reinits": ("==", 1), "relocs": ("==", 0),
                "frames_tracking": (">=", 2), "keyframes": (">=", 3)}},
            set()),
        # the camera comes back: the relocalization must succeed, through
        # add_factors(is_reloc=True) and the dense matcher
        "teleport_return": (teleport_traj(4, 2, 3), 0, {
            "mode": "TRACKING", "stats": {
                "skipped": ("==", 1), "relocs": ("==", 1),
                "reloc_failed": ("==", 1), "reinits": ("==", 0),
                "keyframes": (">=", 3)}},
            {"coarse_correlate", "take_along"}),
    }
    for label, (traj_t, reinit_after, expect, must_launch) in (
            teleports.items()):
        orc_t = oracle.make_params(traj_t.cuda(), desc_dim=model_cfg.desc_dim,
                                   seed=0, device="cuda")
        _kernels.reset_launch_counts()
        system, _, backend = run_slam(
            tpu_fast_config(), oracle_timing.make_params(net, orc_t),
            model_cfg, len(traj_t), KF_TELEPORT, retrieval_params=rparams,
            edge_capacity=EDGE_CAPACITY_LOOP, reinit_after=reinit_after)
        launches_t = run_launches[label] = dict(_kernels.LAUNCHES)
        assert_teleport(system, label, expect)
        missing = sorted(k for k in must_launch | {"rope_qk"}
                         if launches_t[k] <= 0)
        if missing:
            raise AssertionError(f"{label} run never launched {missing}: "
                                 f"{launches_t}")
        events = [(r["event"], r["frame"]) for r in system.metrics.rows
                  if r["event"] != "track"]
        log(f"{label}: {len(traj_t)} frames, end mode {system.mode.name}, "
            f"stats {system.stats}, edges {system.factor_graph.n_edges}, "
            f"events {events}, launches {launches_t}, backend per step "
            f"(wall ms, GN iterations, keyframes, edges): "
            f"{[(round(t, 3), it, k, e) for t, it, k, e in backend]}")
        del system

    # phase 5: the run loop, the exports and the command line
    run_sys, run_wall = run_loop_phase(params, model_cfg, traj, sys_b,
                                       run_launches, every)
    cli_phase(run_launches)

    # phase 6: the windowed frontend, checkpoints and resume, and the CLI
    # with a released-format checkpoint, all with tpu_fast as shipped
    window_phase(params, model_cfg, traj, fast_ref, loop_ref, rparams,
                 run_launches)
    cli_tpu_fast_phase(net, model_cfg, run_launches)

    # phase 7: the separable search, the step-by-step tracker, the viewer
    # and the CLI's renders
    sep_cfg = base_config()
    sep_cfg["matching"] = dict(sep_cfg["matching"], separable_refine=True)
    _, launches_s = drive("separable", sep_cfg, N_BASE, KF_BASE,
                             (every - {"refine_matches"})
                             | {"refine_separable"})
    if launches_s["refine_matches"]:
        raise AssertionError(f"separable run launched the full search: "
                             f"{launches_s}")
    sys_s, _ = drive("steps", base_config(), N_BASE, KF_BASE, every,
                        fused=False)
    k = len(sys_b.keyframes)
    dT = float((sys_s.keyframes.T_WC[:k] - sys_b.keyframes.T_WC[:k]).abs()
               .max()) if len(sys_s.keyframes) == k else None
    if (sys_s.stats != sys_b.stats or dT is None or not dT <= 1e-4
            or not torch.equal(sys_s.keyframes.dataset_idx[:k],
                               sys_b.keyframes.dataset_idx[:k])):
        raise AssertionError(f"steps run: stats {sys_s.stats}, keyframe pose "
                             f"diff {dT} vs the fused base run's "
                             f"{sys_b.stats}")
    log(f"steps run vs the fused base run: the same stats and keyframes, "
        f"keyframe poses within {dT} (gate 1e-4)")
    log("host syncs of one tracked frame, step path: " + json.dumps(
        host_syncs(sys_s, N_BASE, oracle_timing.make_frame_image(
            N_BASE, h, w))))
    del sys_s
    viewer_phase(params, model_cfg, run_sys, run_wall, run_launches, every)
    big_store_scene_cost(model_cfg, sys_b.keyframes)
    # a tracked frame with a viewer attached and no refresh due: the
    # frame's own syncs only
    from mast3r_slam_tpu_torch import viz_server

    viewer = viz_server.LiveViewer(port=0, refresh_s=0.0).start()
    try:
        viewer.update(sys_b, force=True)
        viewer.refresh_s = 3600.0
        frame = sys_b.make_frame(N_BASE, oracle_timing.make_frame_image(
            N_BASE, h, w))
        with_viewer = host_syncs_of(lambda: (sys_b.process_frame(frame),
                                             viewer.update(sys_b)))
    finally:
        viewer.stop()
    if len(with_viewer) != 1:
        raise AssertionError(f"a tracked frame with the viewer attached "
                             f"waited at {with_viewer}")
    log(f"host syncs of one tracked frame with the viewer attached and no "
        f"refresh due: {with_viewer}")
    cli_viz_phase(run_launches)

    # phase 8: the backend across devices, over cuda:0 repeated
    t8 = time.perf_counter()
    mirror_phase(params, model_cfg, traj, loop_ref, rparams, net,
                 teleports["teleport_return"][2], run_launches)
    sharded_graph_phase(loop_graph, run_launches)
    schur_chain_phase(model_cfg, loop_graph["cfg"], run_launches)
    sharded_loop_phase(params, model_cfg, traj, loop_ref, rparams,
                       run_launches)
    log(f"phase 8 (the backend across devices): "
        f"{time.perf_counter() - t8:.2f} s")

    # phase 9: data-parallel tracking, the sharded decode and multi-host
    # runs (two processes that share cuda:0 over gloo)
    t9 = time.perf_counter()
    dp_tracking_phase(params, model_cfg, run_launches)
    sharded_decode_phase(net, model_cfg, decode_batch, run_launches)
    multi_host_ba_phase(loop_graph, run_launches)
    multi_host_loop_phase(loop_ref, run_launches)
    multi_host_cli_phase(run_launches)
    multi_host_kf_ba_phase(loop_graph, run_launches)
    dp_serve_phase(run_launches)
    dp_decode_phase(decode_batch, run_launches)
    log(f"phase 9 (data-parallel tracking, sharded decode, multi-host): "
        f"{time.perf_counter() - t9:.2f} s")

    # phase 10: training (the backward kernel, full-width trainer steps,
    # the shortened rehearsal through the CLI)
    t10 = time.perf_counter()
    check_rope_bwd(records, model_cfg)
    train_full_width(run_launches)
    rehearsal_phase(run_launches)
    log(f"phase 10 (training): {time.perf_counter() - t10:.2f} s")

    for r in records:
        r["launches_by_run"] = {label: ln[r["name"]]
                                for label, ln in run_launches.items()}
        r["launches"] = sum(r["launches_by_run"].values())
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was launched by no run")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase9-child"]:
        sys.exit(phase9_child(*sys.argv[2:]))
    sys.exit(main())
