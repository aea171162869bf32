"""Dense SLAM over a monocular stream on one GPU: the port's command line.

    python -m mast3r_slam_tpu_torch --dataset <path> \
        --config configs/base.yaml [--save-as NAME] [--no-viz] \
        [--calib intrinsics.yaml] [--checkpoint model.pth] \
        [--retrieval-checkpoint retrieval.pth --codebook codebook.pkl] \
        [--save-state state.npz [--save-state-every N]] \
        [--resume state.npz] [--estimate-calib] [--max-frames N] \
        [--device cuda|cpu]

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
pointmap and runs the calibrated pipeline. Writes
``logs/[<save-as>/]<sequence>.txt`` (TUM trajectory), ``.ply`` (point
cloud) and ``keyframes/<sequence>/*.png``.

Flags whose modules are not ported yet raise ``NotImplementedError`` naming
their ROADMAP.md item: the live viewer and the offline renders (queue 1
item 6, so pass ``--no-viz``), and the sharded BA backends and multi-host
runs (item 7).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

_ITEM6 = "is not ported yet; see ROADMAP.md queue 1 item 6"
_ITEM7 = "is not ported yet; see ROADMAP.md queue 1 item 7"


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
    p.add_argument("--coordinator", default="")
    p.add_argument("--num-hosts", type=int, default=None)
    p.add_argument("--host-id", type=int, default=None)
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


def _refuse_unported(args):
    """Raise ``NotImplementedError`` for a flag whose module is not
    ported."""
    item7 = {"--ba-backend " + args.ba_backend:
             args.ba_backend not in ("", "dense"),
             "--coordinator": args.coordinator,
             "--num-hosts": args.num_hosts is not None,
             "--host-id": args.host_id is not None}
    for flag, given in item7.items():
        if given:
            raise NotImplementedError(f"{flag} {_ITEM7}")
    if args.serve_viz is not None:
        raise NotImplementedError(f"--serve-viz (the live viewer) {_ITEM6}")
    if not args.no_viz:
        raise NotImplementedError(
            f"the offline renders (viz.py) {_ITEM6}; pass --no-viz")


def main(argv=None):
    args = _parser().parse_args(argv)
    _refuse_unported(args)

    import torch

    from . import config as config_mod
    from ._device import resolve_device
    from .io import datasets, export
    from .models import convert
    from .models import mast3r as mast3r_mod
    from .slam import checkpoint
    from .slam import retrieval as retrieval_mod
    from .slam.system import SLAMSystem

    device = resolve_device(args.device)
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

    metrics = None
    if args.metrics:
        from .utils.metrics import Metrics

        metrics = Metrics(args.metrics)

    system = SLAMSystem(params, model_cfg, cfg, (h, w),
                        retrieval_params=rparams, K=K, metrics=metrics,
                        device=device)
    start_frame = 0
    if args.resume:
        checkpoint.load_state(args.resume, system)
        start_frame = system.resume_frame
        print(f"resumed SLAM state from {args.resume} "
              f"({len(system.keyframes)} keyframes, "
              f"{system.factor_graph.n_edges} edges, "
              f"next frame {start_frame})")
    run_kwargs = dict(max_frames=args.max_frames, progress=True,
                      start_frame=start_frame,
                      checkpoint_path=args.save_state or None,
                      checkpoint_every=args.save_state_every)
    t0 = time.time()
    if args.profile_dir:
        from .utils.timing import ProfilerTrace

        with ProfilerTrace(args.profile_dir):
            stats = system.run(dataset, **run_kwargs)
    else:
        stats = system.run(dataset, **run_kwargs)
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
        print(f"saved results under {save_dir}")
    return stats


if __name__ == "__main__":
    main()
