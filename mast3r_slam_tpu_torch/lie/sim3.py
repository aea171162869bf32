"""Sim(3) Lie group on torch tensors.

Counterpart of ``mast3r_slam_tpu/lie/sim3.py``; same layouts and the same
fp32-safe series branches. Storage (dim 8): ``[tx, ty, tz, qx, qy, qz, qw,
s]``; tangent (dim 7): ``[tau(3), omega(3), sigma(1)]``. All functions
broadcast over leading batch dims.
"""

from __future__ import annotations

import torch

EMBEDDED_DIM = 8
TANGENT_DIM = 7
_EPS = 1e-6


def _where(c, a, b):
    return torch.where(c, a, b)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm(x, keepdim=True):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


# -- quaternions (xyzw, scalar last) -----------------------------------------


def quat_mul(qi, qj):
    """Hamilton product qi * qj (``sim3.py:44``)."""
    xi, yi, zi, wi = qi.unbind(-1)
    xj, yj, zj, wj = qj.unbind(-1)
    return torch.stack([
        wi * xj + xi * wj + yi * zj - zi * yj,
        wi * yj - xi * zj + yi * wj + zi * xj,
        wi * zj + xi * yj - yi * xj + zi * wj,
        wi * wj - xi * xj - yi * yj - zi * zj,
    ], dim=-1)


def quat_inv(q):
    # negated vector part; no host constant, whose copy to the GPU would
    # wait for the stream
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_act(q, v):
    """R(q) v (``sim3.py:64``)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, v)
    return v + qw * uv + _cross(qv, uv)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (y2 + z2), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (x2 + z2), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (x2 + y2)], -1),
    ]
    return torch.stack(rows, dim=-2)


def exp_so3_quat(phi):
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < _EPS
    one = torch.ones_like(theta_sq)
    theta = torch.sqrt(_where(small, one, theta_sq))
    imag = _where(small, 0.5 - theta_sq / 48.0 + theta_p4 / 3840.0,
                  torch.sin(0.5 * theta) / _where(small, one, theta))
    real = _where(small, 1.0 - theta_sq / 8.0 + theta_p4 / 384.0,
                  torch.cos(0.5 * theta))
    return torch.cat([imag * phi, real], dim=-1)


def log_so3_quat(q):
    qv = q[..., :3]
    qw = q[..., 3:4]
    sign = _where(qw < 0, -torch.ones_like(qw), torch.ones_like(qw))
    qv = qv * sign
    qw = qw * sign
    nv_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = nv_sq < _EPS * _EPS
    one = torch.ones_like(nv_sq)
    nv = torch.sqrt(_where(small, one, nv_sq))
    angle = 2.0 * torch.atan2(nv, qw)
    scale = _where(small, 2.0 / torch.clamp(qw, min=_EPS),
                   angle / _where(small, one, nv))
    return scale * qv


# -- Sim(3) ------------------------------------------------------------------


def identity(batch_shape=(), dtype=torch.float32, device="cpu"):
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return base.expand(tuple(batch_shape) + (EMBEDDED_DIM,)).clone()


def from_parts(t, q, s):
    if s.dim() < t.dim():
        s = s[..., None]
    return torch.cat([t, q, s], dim=-1)


def parts(T):
    return T[..., 0:3], T[..., 3:7], T[..., 7:8]


def act(T, X):
    """Y = s R X + t."""
    t, q, s = parts(T)
    return s * quat_act(q, X) + t


def inv(T):
    t, q, s = parts(T)
    q_inv = quat_inv(q)
    s_inv = 1.0 / s
    t_inv = -s_inv * quat_act(q_inv, t)
    return from_parts(t_inv, q_inv, s_inv)


def mul(Ta, Tb):
    """Ta * Tb, quaternion renormalized (``sim3.py:164``): without it fp32
    rounding compounds along the pose chain and |q| drifts off 1."""
    ta, qa, sa = parts(Ta)
    tb, qb, sb = parts(Tb)
    q = quat_mul(qa, qb)
    q = q / _norm(q)
    t = sa * quat_act(qa, tb) + ta
    return from_parts(t, q, sa * sb)


def rel(Ti, Tj):
    """Ti^{-1} * Tj."""
    return mul(inv(Ti), Tj)


def _w_coefficients(theta_sq, theta, sigma, scale):
    """A, B, C of W = C I + A Phi + B Phi^2 (``sim3.py:192``)."""
    s_tiny = torch.abs(sigma) < 1e-20
    s_small = torch.abs(sigma) < 0.1
    t_small = theta < 1e-2
    one = torch.ones_like(sigma)

    safe_theta_sq = _where(t_small, one, theta_sq)
    safe_theta = _where(t_small, one, theta)
    safe_sigma = _where(s_tiny, one, sigma)
    sigma_sq = sigma * sigma

    C = _where(s_tiny, 1.0 + 0.5 * sigma, torch.expm1(sigma) / safe_sigma)

    A_ts = (0.5 - theta_sq / 24.0) + sigma * (1.0 / 3.0) \
        + sigma_sq * (1.0 / 8.0) + sigma * sigma_sq * (1.0 / 30.0)
    B_ts = (1.0 / 6.0 - theta_sq / 120.0) + sigma * (1.0 / 8.0) \
        + sigma_sq * (1.0 / 20.0) + sigma * sigma_sq * (1.0 / 72.0)
    safe_sigma_sq = _where(s_small, one, sigma_sq)
    A_tl = (sigma * scale - torch.expm1(sigma)) / safe_sigma_sq
    B_tl = (0.5 * sigma_sq * scale + torch.expm1(sigma) - sigma * scale) / (
        safe_sigma_sq * safe_sigma)
    A_t = _where(s_small, A_ts, A_tl)
    B_t = _where(s_small, B_ts, B_tl)

    a = scale * torch.sin(theta)
    b = scale * torch.cos(theta)
    c = theta_sq + sigma_sq
    safe_c = _where(t_small, one, c)
    A_g = (a * sigma + (1.0 - b) * theta) / (safe_theta * safe_c)
    B_g = (C - ((b - 1.0) * sigma + a * theta) / safe_c) / safe_theta_sq

    return _where(t_small, A_t, A_g), _where(t_small, B_t, B_g), C


def _theta(phi):
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < _EPS * _EPS
    theta = _where(small, torch.zeros_like(theta_sq),
                   torch.sqrt(_where(small, torch.ones_like(theta_sq),
                                     theta_sq)))
    return theta_sq, theta


def exp(xi):
    """Sim(3) exponential: [tau, omega, sigma] -> embedded."""
    tau = xi[..., 0:3]
    phi = xi[..., 3:6]
    sigma = xi[..., 6:7]
    scale = torch.exp(sigma)
    q = exp_so3_quat(phi)
    theta_sq, theta = _theta(phi)
    A, B, C = _w_coefficients(theta_sq, theta, sigma, scale)
    phi_x_tau = _cross(phi, tau)
    phi_x2_tau = _cross(phi, phi_x_tau)
    t = C * tau + A * phi_x_tau + B * phi_x2_tau
    return from_parts(t, q, scale)


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], -1),
        torch.stack([z, o, -x], -1),
        torch.stack([-y, x, o], -1),
    ], dim=-2)


def log(T):
    """Sim(3) logarithm; W inverted with a 3x3 solve."""
    t, q, s = parts(T)
    phi = log_so3_quat(q)
    sigma = torch.log(s)
    theta_sq, theta = _theta(phi)
    A, B, C = _w_coefficients(theta_sq, theta, sigma, torch.exp(sigma))
    Phi = skew(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    W = C[..., None] * eye + A[..., None] * Phi + B[..., None] * (Phi @ Phi)
    tau = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)


def retr(T, xi):
    """Left retraction exp(xi) * T."""
    return mul(exp(xi), T)


def normalize(T):
    t, q, s = parts(T)
    return from_parts(t, q / _norm(q), s)


def matrix(T):
    """Embedded -> 4x4 homogeneous matrix (scale folded into rotation)."""
    t, q, s = parts(T)
    R = quat_to_matrix(q) * s[..., None]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = T.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def apply_adj_inv_T(T, v):
    """Adj(T)^{-T} applied to tangent covectors (``sim3.py:322``)."""
    t, q, s = parts(T)
    a, b, c = v[..., 0:3], v[..., 3:6], v[..., 6:7]
    s_inv = 1.0 / s
    Ra = quat_act(q, a)
    Rb = quat_act(q, b)
    y0 = s_inv * Ra
    y1 = Rb + s_inv * _cross(t, Ra)
    y2 = c + s_inv * torch.sum(t * Ra, dim=-1, keepdim=True)
    return torch.cat([y0, y1, y2], dim=-1)


def to_se3(T):
    return T[..., :7]
