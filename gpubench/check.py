"""What decides ``correct``: the timed path's answers held against the plain
references of ``reference/``, once the window has closed. Each cell's
``limits/<cell>.json`` names the numbers it compares and their limits.

- The network (``net_numbers``): its outputs on a sample of the window's
  calls (``record.Sampler``), against ``reference/mast3r_plain.py`` in
  float32 on the same inputs: the benchmark's frames for an encoder call;
  for a decoder call, the encoder tokens that ``reference/scene.py``
  computes for the frames the call names (rounded to the dtype the program
  handed the decoder). Each output is compared where it carries its
  information (the exponent of ``pts3d``'s norm and of the two confidences,
  the descriptor as it is), as a relative L2 error.
- The poses (``pose_numbers``): the tracker's pose of every tracked frame,
  and the keyframe poses after the scan's last global optimization (at its
  end, or once the backend has taken the keyframes queued at the window's
  close), against the scan's own poses.
- ``graph_faults``: edges of a scan's factor graph that name a keyframe
  out of range or join a keyframe to itself, and keyframes with no edge to
  their predecessor.
- ``health_faults``: the health gate of ``mast3r_slam_tpu_torch/bench.py``
  (``assert_healthy``, frozen here): the keyframe cadence, no skipped or
  relocalizing frame, a live factor graph with nothing dropped, a TRACKING
  or TERMINATED end.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import mast3r_plain, poses, scene


def health_problems(stats, mode, n_edges, edges_dropped, n_frames, kf_every):
    """``assert_healthy``'s list of problems for one scan of ``n_frames``
    frames run."""
    problems = []
    if kf_every:
        expect = len(range(0, n_frames, kf_every))
        if abs(stats["keyframes"] - expect) > 2:
            problems.append(f"keyframes {stats['keyframes']} != ~{expect}")
    elif not 2 <= stats["keyframes"] <= max(n_frames // 2, 2):
        problems.append(f"degenerate natural cadence: {stats['keyframes']} "
                        f"keyframes over {n_frames} frames")
    if stats["skipped"]:
        problems.append(f"skipped={stats['skipped']}")
    if stats["reloc_failed"] or stats["frames_reloc"]:
        problems.append(f"reloc storm: {stats}")
    if mode not in ("TERMINATED", "TRACKING"):
        problems.append(f"end mode {mode}")
    if n_edges <= 0:
        problems.append("empty factor graph")
    if edges_dropped:
        problems.append(f"edges_dropped={edges_dropped}")
    return problems


def graph_faults(ii, jj, n_kf):
    bad = int(np.sum((ii < 0) | (ii >= n_kf) | (jj < 0) | (jj >= n_kf)))
    bad += int(np.sum(ii == jj))
    pairs = {(int(a), int(b)) for a, b in zip(ii, jj)}
    bad += sum(1 for i in range(1, n_kf)
               if (i - 1, i) not in pairs and (i, i - 1) not in pairs)
    return bad


def _log_norm_map(x):
    """``pts3d`` -> direction times log1p(norm): the head's 'exp' activation
    undone, so each point weighs by its exponent."""
    d = x.norm(dim=-1, keepdim=True)
    return x / d.clamp(min=1e-30) * torch.log1p(d)


def _log_conf(c, vmin):
    return torch.log((c - vmin).clamp(min=1e-6))


def _views(kind, out):
    """The program's recorded outputs as named NHWC-ish maps."""
    if kind == "encode":
        return {"feat": out[0]}
    if kind == "inference_mono":
        return {"X": out[0], "C": out[1]}
    if kind == "inference_asymmetric":
        return dict(zip(("pts3d", "conf", "desc", "desc_conf"), out))
    # the order of ``inference_symmetric``'s dict, as ``_total`` sees its
    # values (``models/mast3r.py::symmetric_from_decode``)
    keys = [c + p for c in "XCDQ" for p in ("ii", "jj", "ji", "ij")]
    return dict(zip(keys, out))


def reference_views(net, kind, inputs, traj, m):
    """The same maps from the reference network."""
    if kind == "encode":
        return {"feat": net.encode(inputs["img"])}
    dev = inputs["feat1"].device

    def tokens(feat):
        fids = feat[:, 0, -1].float().round().long().cpu().tolist()
        f = scene.oracle_features(torch.as_tensor(traj, device=dev), fids, m)
        return f.to(feat.dtype).float()

    f1 = tokens(inputs["feat1"])
    if kind == "inference_mono":
        r1, _ = net.decode_pair(f1, f1)
        ds = int(inputs["ds"])
        X = r1["pts3d"][:, ::ds, ::ds]
        C = r1["conf"][:, ::ds, ::ds]
        b = X.shape[0]
        return {"X": X.reshape(b, -1, 3), "C": C.reshape(b, -1, 1)}
    f2 = tokens(inputs["feat2"])
    if kind == "inference_asymmetric":
        r1, r2 = net.decode_pair(f1, f2)
        return {k: torch.cat([r1[k], r2[k]]) for k in
                ("pts3d", "conf", "desc", "desc_conf")}
    b = f1.shape[0]
    r1, r2 = net.decode_pair(torch.cat([f1, f2]), torch.cat([f2, f1]))
    out = {}
    for c, k in (("X", "pts3d"), ("C", "conf"), ("D", "desc"),
                 ("Q", "desc_conf")):
        out[c + "ii"], out[c + "jj"] = r1[k][:b], r1[k][b:]
        out[c + "ji"], out[c + "ij"] = r2[k][:b], r2[k][b:]
    return out


def _comparable(name, x):
    x = x.float()
    if name in ("feat", "desc") or name[0] == "D":
        return x
    if name == "pts3d" or name[0] == "X":
        return _log_norm_map(x)
    if name == "conf" or name[0] == "C":
        return _log_conf(x, 1.0)
    return _log_conf(x, 0.0)         # desc_conf, Q..


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def net_errors(samples, weights, m, trajs, prec=None, program=True):
    """[(kind, output, relative error, call)] of the sampled calls
    (``call`` numbers them). ``program``
    False puts the reference at precision ``prec`` in the program's place
    (the control)."""
    mast3r_plain.exact_fp32()
    ref = mast3r_plain.Net(weights, m)
    ctl = None if program else mast3r_plain.Net(weights, m, prec)
    out = []
    with torch.no_grad():
        for i, s in enumerate(samples):
            kind = s["kind"]
            traj = trajs[s["scan"]]
            want = reference_views(ref, kind, s["inputs"], traj, m)
            if program:
                got = _views(kind, s["outputs"])
            else:
                got = reference_views(ctl, kind, s["inputs"], traj, m)
            for name, r in want.items():
                g = got[name].reshape(r.shape)
                out.append((kind, name, rel_err(_comparable(name, g),
                                                _comparable(name, r)), i))
    return out


KIND_NUMBER = {"encode": "enc_err", "inference_mono": "mono_err",
               "inference_asymmetric": "asym_err",
               "inference_symmetric": "sym_err"}


# the decoders' outputs by what they carry, under the names that
# ``_views`` gives them
OUTPUT_KINDS = {"pts": ("pts3d", "X"), "conf": ("conf", "C"),
                "desc": ("desc", "D"), "dconf": ("desc_conf", "Q")}


def output_kind(name):
    for k, (full, short) in OUTPUT_KINDS.items():
        if name == full or (name[0] == short and name[1:] in (
                "", "ii", "jj", "ji", "ij")):
            return k
    return None


def net_numbers(errs):
    """The network's numbers from ``net_errors``' list: for each call kind
    the largest relative error over its sampled calls and outputs
    (``enc_err``, ``mono_err``, ``asym_err``, ``sym_err``); and, over the
    decoders' calls, for each kind of output (``pts``, ``conf``, ``desc``,
    ``dconf``) the median (``dec_<kind>_median_err``), which a few
    small-norm maps move less than the largest, and the largest
    (``dec_<kind>_max_err``)."""
    out = {v: float("nan") for v in KIND_NUMBER.values()}
    for kind, _, e, _ in errs:
        k = KIND_NUMBER[kind]
        out[k] = e if out[k] != out[k] else max(out[k], e)
    for ok in OUTPUT_KINDS:
        dec = [e for kind, name, e, _ in errs
               if kind != "encode" and output_kind(name) == ok]
        out[f"dec_{ok}_median_err"] = (float(np.median(dec)) if dec
                                       else float("nan"))
        out[f"dec_{ok}_max_err"] = max(dec) if dec else float("nan")
    return out


def pose_numbers(scans, answers=None):
    """The largest over scans of each pose number of the tracker's frames
    (``track_``, every tracked frame) and of the keyframes after a scan's
    last optimization (``kf_``): ``*_err``, the aligned position
    RMSE over the extent; ``*_rot_err``, the RMS orientation error in
    radians relative to the first; ``*_step_rot_err``, the RMS error of the
    rotations from each to the next, in radians. ``answers(r, which)`` gives the poses judged, (n, 7)
    position and quaternion (default: the program's)."""
    if answers is None:
        def answers(r, which):
            return np.asarray(r["track_T" if which == "track" else
                                "kf_T"])[:, :7]
    out = {f"{w}_{k}": [] for w in ("track", "kf")
           for k in ("err", "rot_err", "step_rot_err")}
    for r in scans:
        for which, ok, ids in (("track", len(r["track_ids"]) >= 3,
                                r["track_ids"]),
                               ("kf", r.get("checked", False),
                                r.get("kf_idx"))):
            if not ok:
                continue
            gt = r["traj"][np.asarray(ids)][:, :7]
            est = answers(r, which)
            out[which + "_err"].append(poses.aligned_error(est[:, :3],
                                                           gt[:, :3]))
            out[which + "_rot_err"].append(poses.rotation_error(est, gt))
            out[which + "_step_rot_err"].append(
                poses.step_rotation_error(est, gt))
    return {k: max(v) if v else float("nan") for k, v in out.items()}


def graph_and_health(scans):
    """(graph faults, health faults, detail lines) of the scans whose
    backend is checked."""
    gf, hf, detail = 0, 0, []
    for r in scans:
        if r.get("checked"):
            gf += graph_faults(r["ii"], r["jj"], len(r["kf_idx"]))
            hf += len(r["health"])
            detail += [f"scan {r['scan']}: {p}" for p in r["health"]]
    return gf, hf, detail
