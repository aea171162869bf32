"""Camera/point geometry with closed-form Jacobians.

Counterpart of ``mast3r_slam_tpu/geometry.py`` (same layouts: ``(..., 3)``
points, ``(..., h*w, 2)`` pixel grids in row-major order).
"""

from __future__ import annotations

import torch

from .lie import sim3


def point_to_dist(X):
    return torch.sqrt(torch.sum(X * X, dim=-1, keepdim=True))


def point_to_ray_dist(X, jacobian: bool = False):
    """[ray(3), dist(1)] and optionally the (..., 4, 3) Jacobian
    (``geometry.py:21``)."""
    d = point_to_dist(X)
    d_inv = 1.0 / d
    r = d_inv * X
    rd = torch.cat([r, d], dim=-1)
    if not jacobian:
        return rd
    d_inv_2 = d_inv * d_inv
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    outer = X[..., :, None] * X[..., None, :]
    dr_dX = d_inv[..., None] * (eye - d_inv_2[..., None] * outer)
    dd_dX = r[..., None, :]
    return rd, torch.cat([dr_dX, dd_dX], dim=-2)


def act_Sim3(T, X, jacobian: bool = False):
    """Sim3 action and the (..., 3, 7) Jacobian [I | -skew(TX) | TX]
    (``geometry.py:41``)."""
    Y = sim3.act(T, X)
    if not jacobian:
        return Y
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(
        Y.shape[:-1] + (3, 3))
    J = torch.cat([eye, -sim3.skew(Y), Y[..., :, None]], dim=-1)
    return Y, J


def decompose_K(K):
    return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]


def host_intrinsics(K):
    """fx, fy, cx, cy of the 3x3 K as host floats: one read of a device K,
    which a caller that uses one K many times makes once."""
    return tuple(float(v) for v in torch.stack(decompose_K(K)).cpu())


def project_calib(P, K, img_size, jacobian: bool = False, border: int = 0,
                  z_eps: float = 0.0):
    """[u, v, log z] with validity mask (``geometry.py:59``)."""
    h, w = img_size
    fx, fy, cx, cy = decompose_K(K)
    x, y, z = P[..., 0:1], P[..., 1:2], P[..., 2:3]
    valid_z = z > z_eps
    z_safe = torch.where(valid_z, z, torch.ones_like(z))
    z_inv = 1.0 / z_safe
    u = fx * x * z_inv + cx
    v = fy * y * z_inv + cy
    valid = ((u > border) & (u < w - 1 - border) & (v > border)
             & (v < h - 1 - border) & valid_z)
    logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(z))
    pz = torch.cat([u, v, logz], dim=-1)
    if not jacobian:
        return pz, valid
    zi = torch.where(valid_z[..., 0], z_inv[..., 0],
                     torch.zeros_like(z_inv[..., 0]))
    xz = x[..., 0] * zi
    yz = y[..., 0] * zi
    zero = torch.zeros_like(zi)
    row_u = torch.stack([fx * zi, zero, -fx * xz * zi], dim=-1)
    row_v = torch.stack([zero, fy * zi, -fy * yz * zi], dim=-1)
    row_z = torch.stack([zero, zero, zi], dim=-1)
    return pz, torch.stack([row_u, row_v, row_z], dim=-2), valid


def backproject(p, z, K):
    x = (p[..., 0:1] - K[..., 0, 2]) / K[..., 0, 0]
    y = (p[..., 1:2] - K[..., 1, 2]) / K[..., 1, 1]
    return z * torch.cat([x, y, torch.ones_like(x)], dim=-1)


def pixel_coords(img_size, dtype=torch.float32, device="cpu"):
    """(h*w, 2) [u, v] grid in row-major pixel order."""
    h, w = img_size
    v, u = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([u, v], dim=-1).reshape(h * w, 2)


def ray_dist_pose_jacobian(Y):
    """d[ray, dist]/d(left Sim3 perturbation) at Y: (..., 4, 7)
    (``geometry.py:161``)."""
    d = torch.sqrt(torch.sum(Y * Y, dim=-1, keepdim=True))
    d_inv = 1.0 / d
    r = Y * d_inv
    eye = torch.eye(3, dtype=Y.dtype, device=Y.device)
    dr_dP = d_inv[..., None] * (eye - r[..., :, None] * r[..., None, :])
    ray_rows = torch.cat(
        [dr_dP, -sim3.skew(r), torch.zeros_like(r)[..., :, None]], dim=-1)
    dist_row = torch.cat([r, torch.zeros_like(r), d], dim=-1)[..., None, :]
    return torch.cat([ray_rows, dist_row], dim=-2)


def calib_pose_jacobian(P, K, z_eps: float = 0.0):
    """d[u, v, log z]/d(left Sim3 perturbation) at P: (..., 3, 7)
    (``geometry.py:183``); invalid depths give zero rows."""
    fx, fy, cx, cy = decompose_K(K)
    x, y, z = P[..., 0], P[..., 1], P[..., 2]
    valid = z > z_eps
    zi = torch.where(valid, 1.0 / torch.where(valid, z, torch.ones_like(z)),
                     torch.zeros_like(z))
    xz = x * zi
    yz = y * zi
    zero = torch.zeros_like(zi)
    one = valid.to(zi.dtype)
    row_u = torch.stack([fx * zi, zero, -fx * xz * zi, -fx * xz * yz,
                         fx * (one + xz * xz), -fx * yz, zero], dim=-1)
    row_v = torch.stack([zero, fy * zi, -fy * yz * zi,
                         -fy * (one + yz * yz), fy * xz * yz, fy * xz, zero],
                        dim=-1)
    row_z = torch.stack([zero, zero, zi, yz, -xz, zero, one], dim=-1)
    return torch.stack([row_u, row_v, row_z], dim=-2)


def constrain_points_to_ray(img_size, Xs, K):
    """Keep z, put x, y on the calibrated ray of each pixel
    (``geometry.py:208``)."""
    uv = pixel_coords(img_size, dtype=Xs.dtype, device=Xs.device)
    uv = uv.expand(Xs.shape[:-1] + (2,))
    return backproject(uv, Xs[..., 2:3], K)
