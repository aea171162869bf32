"""Dense SLAM over a monocular stream on one GPU: the port's command line.

    python -m mast3r_slam_tpu_torch --dataset <path> \
        --config configs/base.yaml [--save-as NAME] [--no-viz] \
        [--calib intrinsics.yaml] [--checkpoint model.pth] \
        [--retrieval-checkpoint retrieval.pth --codebook codebook.pkl] \
        [--save-state state.npz [--save-state-every N]] \
        [--resume state.npz] [--estimate-calib] [--max-frames N] \
        [--serve-viz PORT [--serve-viz-host ADDR]] [--device cuda|cpu] \
        [--coordinator HOST:PORT --num-hosts N --host-id R]

Counterpart of ``mast3r_slam_tpu/cli.py``; it takes the same flags, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions of
the kernels, for tests). ``--checkpoint`` loads a released-format MASt3R
``.pth`` (``models/convert.load_released_checkpoint``); without one the
model runs with random weights from ``--seed``, which is only good for
smoke and speed runs. ``--retrieval-checkpoint`` (with ``--codebook``)
turns on retrieval and loop closure. ``--save-state`` writes the SLAM state
at the end of the run, and every N frames with ``--save-state-every``;
``--resume`` starts from such a file (``slam/checkpoint.py``).
``--estimate-calib`` estimates the focal length from the first frame's
pointmap and runs the calibrated pipeline. ``--serve-viz`` serves the live
viewer (``viz_server.LiveViewer``) during the run. Writes
``logs/[<save-as>/]<sequence>.txt`` (TUM trajectory), ``.ply`` (point
cloud) and ``keyframes/<sequence>/*.png``, and without ``--no-viz`` the
renders ``<sequence>_viewer.html``, ``_traj.png``, ``_cloud.png`` and
``_keyframes.png`` (the PNGs need matplotlib; the HTML viewer is written
first and needs only numpy).

``--ba-backend edge_sharded|schur`` shards the global bundle adjustment
over every visible GPU when there are several (``parallel/mesh.py``), and
solves dense on one, as the JAX CLI does.

A multi-host run starts one process per host, each with the same dataset
and flags plus ``--coordinator HOST:PORT --num-hosts N --host-id R`` (or
``SLAM_COORDINATOR``, ``SLAM_NUM_PROCESSES``, ``SLAM_PROCESS_ID``). The
processes meet in ``torch.distributed`` (``mesh.init_distributed``; its
backend is ``SLAM_DIST_BACKEND``, else NCCL on CUDA and gloo on the CPU),
each runs the whole program on its first local GPU, and a sharded
``--ba-backend`` spans every rank's GPUs, with the partial systems
all-reduced, so every rank solves to the same poses and writes the same
trajectory. A partial set of the flags is an error (exit 2), as in the JAX
CLI. A sharded backend across processes needs ``single_thread: True``:
with the backend in a host thread each rank would solve whenever its
thread gets to it, and the ranks' all-reduces would pair different graphs.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

import torch

def _parser():
    p = argparse.ArgumentParser(prog="python -m mast3r_slam_tpu_torch")
    p.add_argument("--dataset",
                   default="datasets/tum/rgbd_dataset_freiburg1_desk")
    p.add_argument("--config", default="configs/base.yaml")
    p.add_argument("--save-as", default="default")
    p.add_argument("--no-viz", action="store_true")
    p.add_argument("--calib", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--retrieval-checkpoint", default="")
    p.add_argument("--codebook", default="")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--random-retrieval", action="store_true",
                   help="use a random retrieval head (smoke runs only)")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace to this directory")
    p.add_argument("--serve-viz", type=int, default=None, metavar="PORT")
    p.add_argument("--serve-viz-host", default="127.0.0.1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ba-backend", default="",
                   choices=["", "dense", "edge_sharded", "schur"])
    p.add_argument("--coordinator", default="",
                   help="multi-host: rank 0's rendezvous address host:port "
                        "(or SLAM_COORDINATOR)")
    p.add_argument("--num-hosts", type=int, default=None,
                   help="multi-host: the process count "
                        "(or SLAM_NUM_PROCESSES)")
    p.add_argument("--host-id", type=int, default=None,
                   help="multi-host: this process's rank "
                        "(or SLAM_PROCESS_ID)")
    p.add_argument("--metrics", default="",
                   help="write per-frame metrics as JSONL here")
    p.add_argument("--save-state", default="")
    p.add_argument("--save-state-every", type=int, default=0)
    p.add_argument("--resume", default="")
    p.add_argument("--estimate-calib", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch versions "
                        "of the kernels)")
    return p


def _join_hosts(parser, args) -> bool:
    """The JAX CLI's multi-host rules (``cli.py:80-98``), then
    ``init_distributed``. A partial flag set is a usage error: without
    ``--num-hosts`` every process would run as an independent one-host
    SLAM. Returns True in a process group."""
    from .parallel import mesh as mesh_mod

    n_hosts = args.num_hosts
    if n_hosts is None and "SLAM_NUM_PROCESSES" in os.environ:
        n_hosts = int(os.environ["SLAM_NUM_PROCESSES"])
    if (args.coordinator or args.host_id is not None) and (
            n_hosts is None or n_hosts <= 1):
        parser.error("--coordinator/--host-id require --num-hosts >= 2 "
                     "(or SLAM_NUM_PROCESSES)")
    if (n_hosts or 1) > 1 and not (args.coordinator
                                   or os.environ.get("SLAM_COORDINATOR")):
        parser.error("--num-hosts > 1 requires --coordinator host:port "
                     "(or SLAM_COORDINATOR)")
    return mesh_mod.init_distributed(args.coordinator or None,
                                     args.num_hosts, args.host_id,
                                     device=args.device)


def _ba_mesh(cfg, n_devices: int, local_devices=None):
    """The JAX CLI's device rule for a sharded ``parallel.ba_backend``
    (``cli.py:199-206``): a mesh over the ``n_devices`` devices of every
    process when there are several, else None and the dense solver.
    ``local_devices``: this process's devices (default the first
    ``n_devices`` GPUs)."""
    from .parallel import mesh as mesh_mod

    backend = cfg.get("parallel", {}).get("ba_backend", "dense")
    if backend == "dense":
        return None
    if n_devices > 1:
        mesh = mesh_mod.make_mesh(n_devices if local_devices is None
                                  else local_devices)
        print(f"global BA: {backend} over {mesh.size} devices")
        return mesh
    print(f"global BA: {backend} requested but only one device visible; "
          "using the dense solver")
    return None


def _renders(save_dir, seq_name, system):
    """The offline renders of the JAX CLI (``cli.py:278``); the HTML viewer
    first, since it needs no matplotlib."""
    from . import viz

    kfs, fg = system.keyframes, system.factor_graph
    viz.export_html_viewer(kfs, save_dir / f"{seq_name}_viewer.html",
                           factor_graph=fg)
    viz.plot_trajectory(kfs, save_dir / f"{seq_name}_traj.png")
    viz.render_pointcloud(kfs, save_dir / f"{seq_name}_cloud.png",
                          factor_graph=fg)
    viz.keyframe_mosaic(kfs, save_dir / f"{seq_name}_keyframes.png")


def main(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)
    hosts = _join_hosts(parser, args)

    from . import config as config_mod
    from ._device import resolve_device
    from .io import datasets, export
    from .models import convert
    from .models import mast3r as mast3r_mod
    from .slam import checkpoint
    from .slam import retrieval as retrieval_mod
    from .slam.system import SLAMSystem

    device = resolve_device(args.device)
    local = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if device.type == "cuda" else [device])
    n_devices = len(local)
    if hosts:
        import torch.distributed as dist

        n_devices *= dist.get_world_size()
        print(f"torch.distributed: process {dist.get_rank()}/"
              f"{dist.get_world_size()} over {dist.get_backend()}, "
              f"{n_devices} devices")
    cfg = config_mod.load_config(args.config)
    if args.ba_backend:
        cfg["parallel"] = dict(cfg.get("parallel", {}),
                               ba_backend=args.ba_backend)
    print(f"dataset: {args.dataset}")

    use_calib = bool(cfg.get("use_calib", False))
    dataset = datasets.load_dataset(
        args.dataset, use_calib=use_calib,
        center_principle_point=bool(cfg["dataset"]["center_principle_point"]))
    dataset.subsample(int(cfg["dataset"]["subsample"]))

    if args.calib:
        import yaml

        with open(args.calib) as f:
            intr = yaml.safe_load(f)
        cfg["use_calib"] = True
        use_calib = True
        dataset.use_calibration = True
        dataset.camera_intrinsics = datasets.Intrinsics.from_calib(
            dataset.img_size, intr["width"], intr["height"],
            intr["calibration"])

    (h, w), _ = dataset.get_img_shape()
    print(f"frame size: {h}x{w}")

    rt = cfg.get("runtime", {})
    dtypes = dict(dtype=rt.get("model_dtype", "bfloat16"),
                  head_dtype=rt.get("head_dtype", "float32"))
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    if args.checkpoint:
        # the architecture from the file's instantiation string
        print(f"loading checkpoint {args.checkpoint}")
        model_cfg, params = convert.load_released_checkpoint(
            args.checkpoint, img_size=(h, w), device=device, **dtypes)
    else:
        model_cfg = mast3r_mod.MASt3RConfig(img_size=(h, w), **dtypes)
        print("WARNING: no checkpoint; random weights (smoke/perf mode)")
        params = mast3r_mod.init_params(model_cfg, gen(args.seed),
                                        device=device)

    if args.retrieval_checkpoint:
        rparams = retrieval_mod.convert_retrieval_checkpoint(
            args.retrieval_checkpoint, args.codebook or None, device=device)
    elif args.random_retrieval:
        # smoke runs only: a random retriever proposes spurious loops
        rparams = retrieval_mod.init_retrieval_params(
            gen(args.seed + 1), backbone_dim=model_cfg.enc_embed_dim,
            device=device)
    else:
        rparams = None        # retrieval and loop closure off

    K = None
    if use_calib:
        if not dataset.has_calib():
            print("[Warning] No calibration provided for this dataset!")
            sys.exit(0)
        K = torch.as_tensor(dataset.camera_intrinsics.K_frame,
                            dtype=torch.float32)
    elif args.estimate_calib:
        # an unknown camera: the focal from the first frame's pointmap,
        # then the calibrated pipeline with that pinhole model
        from . import geometry
        from .io.image import resize_img

        _, img0 = dataset[0]
        img = torch.from_numpy(
            resize_img(img0, dataset.img_size)["img"]).to(device)[None]
        feat, pos = mast3r_mod.encode(params, img, model_cfg)
        X, C = mast3r_mod.inference_mono(params, feat, pos, model_cfg)
        f = float(geometry.estimate_focal(X[0], (h, w), conf=C[0, :, 0]))
        if f > 0.1 * max(h, w):
            K = torch.tensor([[f, 0.0, w / 2.0], [0.0, f, h / 2.0],
                              [0.0, 0.0, 1.0]], dtype=torch.float32)
            cfg["use_calib"] = True
            print(f"estimated focal: {f:.2f} px (frame size {h}x{w})")
        else:
            print(f"estimated focal {f:.2f} px is implausible; staying in "
                  "the uncalibrated (ray-residual) pipeline")

    mesh = _ba_mesh(cfg, n_devices, local)
    metrics = None
    if args.metrics:
        from .utils.metrics import Metrics

        metrics = Metrics(args.metrics)

    system = SLAMSystem(params, model_cfg, cfg, (h, w),
                        retrieval_params=rparams, K=K, metrics=metrics,
                        device=device, mesh=mesh)
    start_frame = 0
    if args.resume:
        checkpoint.load_state(args.resume, system)
        start_frame = system.resume_frame
        print(f"resumed SLAM state from {args.resume} "
              f"({len(system.keyframes)} keyframes, "
              f"{system.factor_graph.n_edges} edges, "
              f"next frame {start_frame})")
    viewer = None
    if args.serve_viz is not None:
        from .viz_server import LiveViewer

        viewer = LiveViewer(port=args.serve_viz,
                            host=args.serve_viz_host).start()
        print(f"live viewer: http://localhost:{viewer.port}/")
    run_kwargs = dict(max_frames=args.max_frames, progress=True,
                      start_frame=start_frame,
                      checkpoint_path=args.save_state or None,
                      checkpoint_every=args.save_state_every, viewer=viewer)
    t0 = time.time()
    try:
        if args.profile_dir:
            from .utils.timing import ProfilerTrace

            with ProfilerTrace(args.profile_dir):
                stats = system.run(dataset, **run_kwargs)
        else:
            stats = system.run(dataset, **run_kwargs)
    finally:
        if viewer is not None:
            viewer.stop()
    elapsed = time.time() - t0
    n = len(dataset) if args.max_frames is None else min(args.max_frames,
                                                         len(dataset))
    print(f"done: {n} frames in {elapsed:.1f}s = {n / elapsed:.2f} FPS")
    print(f"stats: {stats}")

    if args.save_state:
        checkpoint.save_state(args.save_state, system)
        print(f"saved SLAM state to {args.save_state}")

    if dataset.save_results:
        save_dir = pathlib.Path("logs")
        if args.save_as != "default":
            save_dir = save_dir / args.save_as
        seq_name = pathlib.Path(args.dataset).stem
        export.save_traj(save_dir, f"{seq_name}.txt", dataset.timestamps,
                         system.keyframes)
        export.save_reconstruction(save_dir, f"{seq_name}.ply",
                                   system.keyframes, 1.5)
        export.save_keyframes(save_dir / "keyframes" / seq_name,
                              dataset.timestamps, system.keyframes)
        if not args.no_viz:
            _renders(save_dir, seq_name, system)
        print(f"saved results under {save_dir}")
    if hosts:
        import torch.distributed as dist

        dist.destroy_process_group()
    return stats


if __name__ == "__main__":
    main()
