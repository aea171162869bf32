"""Multi-device scaling benchmark: global-BA keyframes/s on 1 device
against N devices.

Counterpart of the JAX system's ``bench_multichip.py``:

    python -m mast3r_slam_tpu_torch.bench_multichip [--devices 8]
        [--n-kf 16] [--points 4096] [--iters 3] [--schur]
        [--device cuda|cpu] [--cpu]

A synthetic pose graph sized like a real run (consecutive edges and
``(i, i + 4)`` edges, both directions, every point of every edge matched,
C = 5, Q = 4, poses noised by 0.03 but the first) is solved by the
edge-sharded Gauss-Newton (``parallel/dist_ba.gauss_newton_rays_dist``) on
a 1-device mesh and on an N-device mesh, or on the N-device mesh by the
Schur-complement solver (``parallel/schur``) with ``--schur``; both with
``max_iters`` 10. Each mesh solves once to warm up, then ``--iters``
timed solves ending in a synchronize of every device. The N-device poses
must agree with the 1-device poses at rtol = atol = 1e-4, else the run
exits non-zero.

The mesh is built over the visible GPUs. Where fewer than ``--devices``
are visible, it repeats them in turn (as ``chip_smoke.py`` phase 8 does):
the process never moves to the CPU on its own, which would hide the
device, and ``note`` then says that the efficiency measures no scaling.
``--device cpu`` runs the plain PyTorch path over the CPU repeated;
``--cpu``, the JAX script's flag, is another spelling of it (both set one
option, so where both are given the last one wins).

Prints one JSON line on stdout:
  {"metric": "ba_scaling_efficiency", "value": eff, "unit": "x",
   "devices": N, "kf_per_s_1dev": a, "kf_per_s_ndev": b,
   "platform": "gpu" | "cpu", "solver": "edge_sharded" | "schur",
   "note": ...}
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ._device import resolve_device
from .lie import sim3
from .utils.timing import device_sync

POSE_TOL = 1e-4       # rtol and atol of the N-device poses, as JAX asserts


def make_graph(n_kf, P, device, seed=0):
    """The synthetic graph (``bench_multichip.py:60-85``) from a
    ``torch.Generator`` on ``device``: (T_init, Xs, Cs, ii, jj, idx, valid,
    Q, mask)."""
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=device)
    pts_w = randn(P, 3) + torch.tensor([0.0, 0.0, 4.0], device=device)
    T_true = [sim3.identity(device=device)]
    for _ in range(1, n_kf):
        T_true.append(sim3.mul(T_true[-1], sim3.exp(0.05 * randn(7))))
    T_true = torch.stack(T_true)
    Xs = sim3.act(sim3.inv(T_true)[:, None], pts_w[None])
    Cs = torch.full((n_kf, P), 5.0, device=device)

    pairs = ([(i, i + 1) for i in range(n_kf - 1)]
             + [(i, i + 4) for i in range(n_kf - 4)])
    ii = torch.tensor([p for a, b in pairs for p in (a, b)],
                      dtype=torch.int32, device=device)
    jj = torch.tensor([p for a, b in pairs for p in (b, a)],
                      dtype=torch.int32, device=device)
    E = ii.shape[0]
    idx = torch.arange(P, dtype=torch.int32, device=device).expand(
        E, P).contiguous()
    valid = torch.ones((E, P), dtype=torch.bool, device=device)
    Q = torch.full((E, P), 4.0, device=device)
    mask = torch.ones((E,), device=device)

    noise = 0.03 * randn(n_kf, 7)
    noise[0] = 0.0
    T_init = sim3.retr(T_true, noise)
    return T_init, Xs, Cs, ii, jj, idx, valid, Q, mask


def mesh_devices(n, device):
    """``n`` mesh devices: the visible GPUs in turn on CUDA (repeated when
    fewer are visible), the CPU repeated on the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i % torch.cuda.device_count())
                for i in range(n)]
    return [device] * n


def solver(graph, n_kf, devices, schur_solver, cfg):
    """A function that solves ``graph`` on a mesh over ``devices`` and
    returns the poses: edge-sharded, or Schur on more than one device."""
    from .parallel import dist_ba, schur
    from .parallel.mesh import make_mesh, pad_to_multiple

    T, Xs, Cs, ii, jj, idx, valid, Q, mask = graph
    m = make_mesh(devices)
    nd = len(devices)
    if schur_solver and nd > 1:
        part, order, keep = schur.schur_partition(
            ii.cpu().numpy(), jj.cpu().numpy(), mask.cpu().numpy() > 0,
            K_cap=n_kf, n_shards=nd)
        edges = schur.reorder_edges(order, keep, ii, jj, idx, valid, Q, mask)
        return lambda: schur.gauss_newton_rays_schur(
            T, Xs, Cs, part.owner, part.int_slot, part.sep_slot, *edges,
            n_kf, part.I_cap, part.S_cap, m, cfg).T_WC
    fills = (0, 0, 0, False, 0, 0)
    edges = [pad_to_multiple(a, nd, 0, f)
             for a, f in zip((ii, jj, idx, valid, Q, mask), fills)]
    return lambda: dist_ba.gauss_newton_rays_dist(
        T, Xs, Cs, *edges, n_kf, m, cfg).T_WC


def kf_per_s(fn, n_kf, iters):
    """One warm solve, then ``iters`` timed ones: (keyframes/s, poses)."""
    out = fn()
    device_sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    device_sync()
    return n_kf * iters / (time.perf_counter() - t0), out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--n-kf", type=int, default=16)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--schur", action="store_true",
                    help="solve on the N-device mesh by the Schur "
                         "complement (parallel/schur.py) instead of the "
                         "summed dense system")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--cpu", dest="device", action="store_const",
                    const="cpu", help="the same as --device cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from .slam import ba

    n_kf, n_dev = args.n_kf, args.devices
    graph = make_graph(n_kf, args.points, dev)
    cfg = ba.BAConfig(max_iters=10, point_chunk=min(4096, args.points))
    kf_s_1, T_1 = kf_per_s(solver(graph, n_kf, mesh_devices(1, dev), False,
                                  cfg), n_kf, args.iters)
    kf_s_n, T_n = kf_per_s(solver(graph, n_kf, mesh_devices(n_dev, dev),
                                  args.schur, cfg), n_kf, args.iters)
    T_1, T_n = T_1.cpu(), T_n.cpu()
    diff = float((T_n - T_1).abs().max())
    if not torch.allclose(T_n, T_1, rtol=POSE_TOL, atol=POSE_TOL):
        raise SystemExit(
            f"the {n_dev}-device poses differ from the 1-device poses by "
            f"{diff} (rtol = atol = {POSE_TOL})")
    print(f"1 device: {kf_s_1:.2f} keyframes/s; {n_dev} devices: "
          f"{kf_s_n:.2f} keyframes/s; the {n_dev}-device poses within "
          f"{diff} of the 1-device poses (rtol = atol = {POSE_TOL})",
          file=sys.stderr, flush=True)
    if dev.type == "cuda":
        from .ops import _kernels

        print(f"kernel launches: {json.dumps(_kernels.LAUNCHES)}",
              file=sys.stderr, flush=True)

    eff = kf_s_n / (kf_s_1 * n_dev)
    out = {
        "metric": "ba_scaling_efficiency",
        "value": round(eff, 3),
        "unit": "x",
        "devices": n_dev,
        "kf_per_s_1dev": round(kf_s_1, 2),
        "kf_per_s_ndev": round(kf_s_n, 2),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "solver": "schur" if args.schur and n_dev > 1 else "edge_sharded",
    }
    distinct = len(set(mesh_devices(n_dev, dev)))
    if distinct < n_dev:
        out["note"] = (
            f"{n_dev} shards over {distinct} {out['platform']} device(s) "
            f"repeated: the shards share a device and run in turn, so the "
            f"efficiency measures the sharded code path, not scaling")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
