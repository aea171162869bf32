"""The benchmark's scans and the oracle scene they look at, in NumPy and
plain PyTorch.

``make_traj`` is a frozen copy of the 65-frame orbit of
``mast3r_slam_tpu_torch/bench.py::make_traj`` (itself ``bench.py:74`` of
the JAX package), composed in float64 and stored as float32 Sim(3) poses
``[t, q (xyzw), s]``. ``make_scan`` sweeps that orbit forth and back into
a scan of any length. ``frame_pool`` and ``stamp`` make the uint8 frames
that carry their id in two pixels, as
``mast3r_slam_tpu_torch/models/oracle_timing.py::make_frame_image`` does.
``oracle_features`` recomputes what the oracle's encoder hands the
decoders (``models/oracle.py::encode_fid``): the world point seen at each
patch centre, repeated along the channels, the frame id in the last
channel of token 0.
"""

from __future__ import annotations

import numpy as np
import torch


def _hat(v):
    x, y, z = v
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def se3_exp(xi):
    """[tau, omega] (float64) -> 4x4 matrix."""
    tau, phi = np.asarray(xi[:3], np.float64), np.asarray(xi[3:6], np.float64)
    th = float(np.linalg.norm(phi))
    P = _hat(phi)
    if th < 1e-12:
        R, V = np.eye(3) + P, np.eye(3) + 0.5 * P
    else:
        a = np.sin(th) / th
        b = (1.0 - np.cos(th)) / th ** 2
        c = (1.0 - a) / th ** 2
        R = np.eye(3) + a * P + b * (P @ P)
        V = np.eye(3) + b * P + c * (P @ P)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, V @ tau
    return T


def mat_to_quat(R):
    """Rotation matrix -> unit quaternion (x, y, z, w), w >= 0."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2.0
    y = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2.0
    z = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2.0
    x = np.copysign(x, R[2, 1] - R[1, 2])
    y = np.copysign(y, R[0, 2] - R[2, 0])
    z = np.copysign(z, R[1, 0] - R[0, 1])
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def make_traj(n_frames, phase, step_scale=1.0):
    """(n_frames, 8) float32 poses T_WC of the orbit: a start pose turned
    by ``phase``, then a step of [0.03, 0.01 sin((i + 3 phase) / 5), 0.008]
    in translation and [0, 0.012, 0.002] in rotation, times
    ``step_scale``."""
    T = se3_exp(np.array([0.011, -0.007, 0.004, 0.0, 0.002, 0.001]) * phase)
    out = []
    for i in range(n_frames):
        if i:
            xi = np.array([0.03, 0.01 * np.sin((i + 3.0 * phase) / 5.0),
                           0.008, 0.0, 0.012, 0.002]) * step_scale
            T = T @ se3_exp(xi)
        out.append(np.concatenate([T[:3, 3], mat_to_quat(T[:3, :3]), [1.0]]))
    return np.asarray(out, np.float32)


def scan_index(n_frames, orbit_frames):
    """Orbit index of each of ``n_frames`` frames of a scan that sweeps the
    orbit's ``orbit_frames`` poses forth and back: 0, 1, ..., o - 1,
    o - 2, ..., 0, 1, ... (a triangle wave of period 2 (o - 1))."""
    period = 2 * (orbit_frames - 1)
    k = np.arange(n_frames) % period
    return np.where(k < orbit_frames, k, period - k)


def make_scan(n_frames, orbit_frames, phase, step_scale=1.0):
    """(n_frames, 8) float32 poses of a scan over ``make_traj``'s orbit
    (``scan_index``): every leg revisits the poses of the one before."""
    orbit = make_traj(orbit_frames, phase, step_scale)
    return orbit[scan_index(n_frames, orbit_frames)]


def frame_pool(rng, n, h, w):
    """``n`` uint8 noise frames (n, h, w, 3) from ``rng``, drawn at once."""
    return rng.integers(0, 255, (n, h, w, 3), np.uint8)


def stamp(img, frame_id):
    """A copy of ``img`` carrying ``frame_id`` in pixels (0, 0, 0) and
    (0, 0, 1)."""
    out = img.copy()
    out[0, 0, 0] = frame_id % 256
    out[0, 0, 1] = frame_id // 256
    return out


# -- the oracle scene: a sphere before a plane -----------------------------------

SPHERE_C = (0.0, 0.0, 4.0)
SPHERE_R = 1.5
PLANE_Z = 7.0


def _quat_act(q, v):
    qv, qw = q[:3], q[3]
    uv = 2.0 * torch.cross(qv.expand_as(v), v, dim=-1)
    return v + qw * uv + torch.cross(qv.expand_as(uv), uv, dim=-1)


def raycast(T_WC, h, w):
    """World points (h*w, 3) hit by the pixel rays of a camera at pose
    ``T_WC`` (8,) with focal 0.8 w and the principal point at (w/2, h/2)."""
    f = 0.8 * w
    dev = T_WC.device
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev),
                          indexing="ij")
    dirs = torch.stack([(u - w / 2.0) / f, (v - h / 2.0) / f,
                        torch.ones_like(u)], -1).reshape(-1, 3)
    t, q, s = T_WC[:3], T_WC[3:7], T_WC[7]
    d = s * _quat_act(q, dirs)
    a = (d * d).sum(-1)
    oc = t - torch.tensor(SPHERE_C, device=dev)
    b = 2.0 * d @ oc
    c = oc @ oc - SPHERE_R ** 2
    disc = b * b - 4.0 * a * c
    s_sph = (-b - torch.sqrt(disc.clamp(min=0.0))) / (2.0 * a)
    hit = (disc > 0) & (s_sph > 1e-3)
    dz = d[:, 2]
    dz = torch.where(dz.abs() < 1e-6, torch.full_like(dz, 1e-6), dz)
    s_pl = (PLANE_Z - t[2]) / dz
    return t + torch.where(hit, s_sph, s_pl)[:, None] * d


def oracle_features(traj, fids, m):
    """Encoder tokens (b, n, E) the oracle gives frames ``fids`` of the
    scan with poses ``traj`` (n_frames, 8) under model sizes ``m``."""
    h, w = m["img_size"]
    ps, E = m["patch_size"], m["enc_embed_dim"]
    nh, nw = h // ps, w // ps
    out = []
    for fid in fids:
        X = raycast(traj[int(fid)], h, w).reshape(h, w, 3)
        c = X[ps // 2::ps, ps // 2::ps].reshape(nh * nw, 3)
        feat = c.repeat(1, -(-E // 3))[:, :E].clone()
        feat[0, -1] = float(fid)
        out.append(feat)
    return torch.stack(out)
