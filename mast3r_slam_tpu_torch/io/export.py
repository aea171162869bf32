"""Trajectory and reconstruction export.

The port's copy of ``mast3r_slam_tpu/io/export.py``: the TUM trajectory
(``t x y z qx qy qz qw`` per keyframe, the Sim(3) scale dropped), a
confidence-thresholded world point cloud as a binary little-endian PLY, and
the keyframe images. The keyframes are read from the port's
``KeyframeStore``; the points go to the world frame on the store's device.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..lie import sim3


def save_traj(logdir, logfile, timestamps, keyframes):
    """Write the TUM trajectory of the keyframes; returns its path."""
    logdir = pathlib.Path(logdir)
    logdir.mkdir(exist_ok=True, parents=True)
    path = logdir / logfile
    n = len(keyframes)
    T = keyframes.T_WC[:n].cpu().numpy()
    ids = keyframes.dataset_idx[:n].cpu().numpy()
    with open(path, "w") as f:
        for i in range(n):
            t = timestamps[int(ids[i])]
            x, y, z, qx, qy, qz, qw = T[i, :7]
            f.write(f"{t} {x} {y} {z} {qx} {qy} {qz} {qw}\n")
    return path


def save_ply(filename, points: np.ndarray, colors: np.ndarray):
    """Binary little-endian PLY with x, y, z float32 and rgb uchar."""
    filename = pathlib.Path(filename)
    filename.parent.mkdir(exist_ok=True, parents=True)
    n = len(points)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = points.astype(np.float32).T
    rec["red"], rec["green"], rec["blue"] = colors.astype(np.uint8).T
    with open(filename, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)
    return filename


def save_reconstruction(savedir, filename, keyframes, c_conf_threshold):
    """The world points of every keyframe whose average confidence is above
    ``c_conf_threshold``, coloured by the keyframe image, as a PLY."""
    n = len(keyframes)
    if n:
        pW = sim3.act(keyframes.T_WC[:n, None], keyframes.X[:n]).cpu().numpy()
        valid = (keyframes.average_confs(n) > c_conf_threshold).cpu().numpy()
        colors = keyframes.uimg[:n].reshape(n, -1, 3) * 255
        pts, cols = pW[valid], colors[valid]
    else:
        pts, cols = np.zeros((0, 3)), np.zeros((0, 3))
    return save_ply(pathlib.Path(savedir) / filename, pts, cols)


def save_keyframes(savedir, timestamps, keyframes):
    """Write each keyframe's RGB image as ``<timestamp>.png``."""
    import PIL.Image

    savedir = pathlib.Path(savedir)
    savedir.mkdir(exist_ok=True, parents=True)
    n = len(keyframes)
    ids = keyframes.dataset_idx[:n].cpu().numpy()
    for i in range(n):
        t = timestamps[int(ids[i])]
        img = (keyframes.uimg[i] * 255).astype(np.uint8)
        PIL.Image.fromarray(img).save(savedir / f"{t}.png")
