"""Pixel-to-point matching: LM ray projection, occlusion gate, descriptor
window refine.

Counterpart of ``mast3r_slam_tpu/ops/matching.py``. Two hand-written CUDA
kernels carry it on the GPU:

* ``iter_proj`` -> ``csrc/iter_proj.cu`` (replaces the XLA ``iter_proj``,
  ``matching.py:117-186``); ``match`` hands it the padded 12-float record
  of ``gradient.prep_rays_grad_padded``, which it reads with vector loads;
* ``refine_matches`` -> ``csrc/refine_matches.cu`` (replaces
  ``refine_matches``, ``matching.py:189-231``, shipped as
  ``window_gather.refine_matches_full_unfold``, ``window_gather.py:183``).

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it for CPU tensors; nothing else falls back. The
TPU layout workarounds of the JAX package (pair/quad unfolds, the
phase-decimated window unfolds, payload riding) are not ported: the
kernels read the images directly.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from .gradient import l2_normalize, prep_rays_grad_padded


def pixel_to_lin(p, w):
    return p[..., 0] + w * p[..., 1]


def lin_to_pixel(idx, w):
    return torch.stack([idx % w, torch.div(idx, w, rounding_mode="floor")],
                       dim=-1)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# -- iter_proj ---------------------------------------------------------------


def _bilinear(flat, u, v, h, w):
    """Sample (b, h*w, c) at float (u, v) (b, n); corner pairing of
    ``matching.py:75``. Coordinates are in [1, w-2] x [1, h-2] (the index
    clamp only keeps NaN coordinates in bounds; they sample NaN)."""
    c = flat.shape[-1]
    u11 = torch.floor(u)
    v11 = torch.floor(v)
    du = (u - u11)[..., None]
    dv = (v - v11)[..., None]
    iu = u11.to(torch.int64).clamp(0, w - 2)
    iv = v11.to(torch.int64).clamp(0, h - 2)
    base = iv * w + iu

    def g(idx):
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))

    top = g(base) * (1.0 - du) + g(base + 1) * du
    bot = g(base + w) * (1.0 - du) + g(base + w + 1) * du
    return top * (1.0 - dv) + bot * dv


def iter_proj_plain(rays_with_grad_img, pts3d_norm, p_init,
                    max_iter: int = 10, lambda_init: float = 1e-8,
                    cost_thresh: float = 1e-6):
    """Plain vectorized LM; same trajectory and operation order as the
    kernel (see ``csrc/iter_proj.cu``)."""
    b, h, w, c = rays_with_grad_img.shape
    flat = rays_with_grad_img.reshape(b, h * w, c)
    t = pts3d_norm
    u_a = torch.clamp(p_init[..., 0], 1.0, w - 2.0)
    v_a = torch.clamp(p_init[..., 1], 1.0, h - 2.0)
    u_t, v_t = u_a, v_a
    s_a = torch.zeros(u_a.shape + (c,), dtype=flat.dtype, device=flat.device)
    cost_a = torch.full_like(u_a, math.inf)
    lam = torch.full_like(u_a, lambda_init)
    conv = torch.zeros(u_a.shape, dtype=torch.bool, device=u_a.device)

    for _ in range(max_iter + 1):
        s_t = _bilinear(flat, u_t, v_t, h, w)
        e = l2_normalize(s_t[..., 0:3]) - t
        cost_t = _dot3(e, e)
        improved = cost_t < cost_a
        u_a = torch.where(improved, u_t, u_a)
        v_a = torch.where(improved, v_t, v_a)
        s_a = torch.where(improved[..., None], s_t, s_a)
        cost_a = torch.minimum(cost_t, cost_a)
        lam = torch.where(improved, lam * 0.1, lam * 10.0)
        conv = cost_a < cost_thresh

        eb = l2_normalize(s_a[..., 0:3]) - t
        gx = s_a[..., 3:6]
        gy = s_a[..., 6:9]
        A00 = _dot3(gx, gx) + lam
        A01 = _dot3(gx, gy)
        A11 = _dot3(gy, gy) + lam
        b0 = -_dot3(eb, gx)
        b1 = -_dot3(eb, gy)
        det = A00 * A11 - A01 * A01
        det_inv = 1.0 / det
        du = det_inv * (A11 * b0 - A01 * b1)
        dv = det_inv * ((-A01) * b0 + A00 * b1)
        u_t = torch.clamp(u_a + du, 1.0, w - 2.0)
        v_t = torch.clamp(v_a + dv, 1.0, h - 2.0)
    return torch.stack([u_a, v_a], dim=-1), conv


def iter_proj(rays_with_grad_img, pts3d_norm, p_init, max_iter: int = 10,
              lambda_init: float = 1e-8, cost_thresh: float = 1e-6):
    """Per-point LM ray projection (``matching.py:117``).

    rays_with_grad_img (b, h, w, 9), or (b, h, w, 12) with channels 9-11
    unread (``gradient.prep_rays_grad_padded``); pts3d_norm (b, n, 3) unit
    targets, p_init (b, n, 2) float. Returns (p (b, n, 2) float, converged
    (b, n)).
    """
    if rays_with_grad_img.device.type == "cpu":
        return iter_proj_plain(rays_with_grad_img, pts3d_norm, p_init,
                               max_iter, lambda_init, cost_thresh)
    return _iter_proj_cuda(rays_with_grad_img, pts3d_norm, p_init, max_iter,
                           lambda_init, cost_thresh)


def _iter_proj_cuda(img, pts3d_norm, p_init, max_iter, lambda_init,
                    cost_thresh, first: bool = False):
    """Launch ``iter_proj``, or with ``first`` its first design (9-float
    record, scalar loads)."""
    f32 = torch.float32
    _kernels.check_cuda(img, "iter_proj image", f32, 4)
    _kernels.check_cuda(pts3d_norm, "iter_proj points", f32, 3, 3)
    _kernels.check_cuda(p_init, "iter_proj p_init", f32, 3, 2)
    b, h, w, c = img.shape
    n = pts3d_norm.shape[1]
    if c not in (9, 12) or (c == 12 and img.data_ptr() % 16):
        raise ValueError(f"iter_proj: the image needs 9 floats a pixel, or "
                         f"12 starting 16-byte aligned; got c={c} at "
                         f"{img.data_ptr() % 16} bytes past a 16-byte "
                         "boundary")
    if first and c != 9:
        raise ValueError(f"iter_proj: the first design reads 9 floats a "
                         f"pixel, got c={c}")
    if pts3d_norm.shape[0] != b or p_init.shape[:2] != (b, n):
        raise ValueError("iter_proj: batch/point counts disagree")
    if h < 3 or w < 3:
        raise ValueError("iter_proj: image must be at least 3x3")
    p = torch.empty((b, n, 2), dtype=f32, device=p_init.device)
    conv = torch.empty((b, n), dtype=torch.bool, device=p_init.device)
    _kernels.launch("iter_proj", _kernels.ptr(img), _kernels.ptr(pts3d_norm),
                    _kernels.ptr(p_init), _kernels.ptr(p), _kernels.ptr(conv),
                    b, h, w, n, c, int(first), int(max_iter),
                    float(lambda_init), float(cost_thresh))
    return p, conv


# -- refine_matches ----------------------------------------------------------


def refine_matches_plain(D11, D21, p1, radius: int = 3,
                         dilation_max: int = 5):
    """Plain dilated window search; scores summed over f in order, as the
    kernel does (bf16/int8 products are exact in fp32, so the two agree to
    the bit)."""
    b, h, w, f = D11.shape
    n = D21.shape[1]
    flat = D11.reshape(b, h * w, f)
    q = D21.to(torch.float32)
    u0 = p1[..., 0].to(torch.int64)
    v0 = p1[..., 1].to(torch.int64)
    k = 2 * radius + 1
    for d in range(dilation_max, 0, -1):
        offs = torch.arange(-radius, radius + 1, device=D11.device) * d
        ou = offs.repeat(k)                  # u fastest
        ov = offs.repeat_interleave(k)       # v slowest
        u = u0[..., None] + ou
        v = v0[..., None] + ov
        inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        uc = u.clamp(0, w - 1)
        vc = v.clamp(0, h - 1)
        idx = (vc * w + uc).reshape(b, n * k * k)
        cand = torch.gather(flat, 1, idx[..., None].expand(-1, -1, f))
        cand = cand.reshape(b, n, k * k, f)
        s = torch.zeros((b, n, k * k), dtype=torch.float32, device=D11.device)
        for c in range(f):
            s = s + cand[..., c].to(torch.float32) * q[..., c, None]
        s = torch.where(inside, s, torch.full_like(s, -math.inf))
        best = torch.argmax(s, dim=-1, keepdim=True)
        u0 = torch.gather(uc, -1, best)[..., 0]
        v0 = torch.gather(vc, -1, best)[..., 0]
    return torch.stack([u0, v0], dim=-1).to(torch.int32)


def refine_matches(D11, D21, p1, radius: int = 3, dilation_max: int = 5,
                   grid_width=None):
    """Coarse-to-fine dilated descriptor search (``matching.py:189``).

    D11 (b, h, w, f) and D21 (b, n, f), both bf16 or both int8; p1
    (b, n, 2) int32. Returns refined (b, n, 2) int32 positions.

    ``grid_width`` only steers how the GPU kernel reads its bytes; the
    result is the same. With it the queries are a row-major grid of that
    width (n % grid_width == 0), so a block can own a 2-D patch of them,
    whose search windows overlap; without it a block owns consecutive
    queries.
    """
    if D11.device.type == "cpu":
        return refine_matches_plain(D11, D21, p1, radius, dilation_max)
    if D11.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"refine_matches: descriptors must be bf16 or int8, "
                         f"got {D11.dtype}")
    _kernels.check_cuda(D11, "refine_matches D11", D11.dtype, 4)
    b, h, w, f = D11.shape
    _kernels.check_cuda(D21, "refine_matches D21", D11.dtype, 3, f)
    _kernels.check_cuda(p1, "refine_matches p1", torch.int32, 3, 2)
    n = D21.shape[1]
    if D21.shape[0] != b or p1.shape[:2] != (b, n):
        raise ValueError("refine_matches: batch/point counts disagree")
    if f not in (8, 16, 24, 32):
        raise ValueError(f"refine_matches: descriptor width {f} not built "
                         "(8, 16, 24 or 32)")
    if radius < 0:
        raise ValueError(f"refine_matches: radius {radius} < 0")
    gw = 0 if grid_width is None else int(grid_width)
    if gw < 0 or (gw > 0 and n % gw):
        raise ValueError(f"refine_matches: grid_width {grid_width} does not "
                         f"divide the {n} queries")
    # a descriptor row is read as units of 8 values: 16 bytes (bf16), 8 (int8)
    unit = 8 * D11.element_size()
    if D11.data_ptr() % unit or D21.data_ptr() % unit or p1.data_ptr() % 8:
        raise ValueError(f"refine_matches: descriptors must be {unit}-byte "
                         "aligned and p1 8-byte aligned")
    out = torch.empty((b, n, 2), dtype=torch.int32, device=p1.device)
    _kernels.launch("refine_matches", _kernels.ptr(D11), _kernels.ptr(D21),
                    _kernels.ptr(p1), _kernels.ptr(out), b, h, w, n, f,
                    int(radius), int(dilation_max),
                    int(D11.dtype == torch.int8), gw)
    return out


# -- match -------------------------------------------------------------------


def _quantize_int8(x):
    """Symmetric x127 quantization of L2-normalized descriptors."""
    return torch.clamp(torch.round(x.to(torch.float32) * 127.0),
                       -127, 127).to(torch.int8)


def match(X11, X21, D11, D21, idx_1_to_2_init=None, max_iter: int = 10,
          lambda_init: float = 1e-8, convergence_thresh: float = 1e-6,
          dist_thresh: float = 1e-1, radius: int = 3, dilation_max: int = 5,
          subpixel: bool = False, coarse_iter: int = 0,
          separable_refine: bool = False, refine_dtype: str = "bfloat16",
          payload=None):
    """Ray LM projection + occlusion gate + descriptor refine
    (``matching.py:234``).

    X11 (b, h, w, 3) and D11 (b, h, w, f) of view 1; X21/D21 (b, hq, wq, .)
    queries (a sub-grid needs ``idx_1_to_2_init``). Returns (idx (b, n)
    int64, valid (b, n, 1) bool) and, with ``subpixel``, p_sub (b, n, 2).
    """
    if separable_refine:
        raise NotImplementedError(
            "separable_refine is not ported yet (ROADMAP.md, queue 1)")
    if payload is not None:
        raise NotImplementedError(
            "payload riding is a TPU layout workaround and is not ported")
    b, h, w, _ = X11.shape
    hq, wq = X21.shape[1], X21.shape[2]
    n = hq * wq
    dev = X11.device

    rays_grad = prep_rays_grad_padded(X11.contiguous())
    pts3d_norm = l2_normalize(X21.reshape(b, n, 3)).contiguous()
    if idx_1_to_2_init is None:
        if (hq, wq) != (h, w):
            raise ValueError(
                "sub-grid queries need an explicit idx_1_to_2_init "
                f"(X11 {h}x{w} vs X21 {hq}x{wq})")
        idx_1_to_2_init = torch.arange(n, device=dev).expand(b, n)
    p_init = lin_to_pixel(idx_1_to_2_init.to(torch.int64), w).to(X11.dtype)

    if coarse_iter > 0 and (hq % 2 or wq % 2):
        raise ValueError(
            f"coarse_iter > 0 needs an even working resolution, got "
            f"{hq}x{wq}; set matching.coarse_iter: 0 for this image size "
            "(a silent fall-through would leave only max_iter LM "
            "iterations and quietly under-converge the projection)")
    valid_coarse = None
    if coarse_iter > 0:
        p_img = p_init.reshape(b, hq, wq, 2)
        t_img = pts3d_norm.reshape(b, hq, wq, 3)
        pc = p_img[:, ::2, ::2].reshape(b, n // 4, 2).contiguous()
        tc = t_img[:, ::2, ::2].reshape(b, n // 4, 3).contiguous()
        p_c, v_c = iter_proj(rays_grad, tc, pc, coarse_iter, lambda_init,
                             convergence_thresh)
        flow = (p_c - pc).reshape(b, hq // 2, wq // 2, 2)
        flow_up = flow.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        p_init = (p_img + flow_up).reshape(b, n, 2)
        v_img = v_c.reshape(b, hq // 2, wq // 2)
        valid_coarse = v_img.repeat_interleave(2, dim=1).repeat_interleave(
            2, dim=2).reshape(b, n)

    if max_iter == 0 and valid_coarse is not None:
        # pyramidal-only: the upsampled coarse flow is the projection
        p1, valid_proj = p_init, valid_coarse
    else:
        p1, valid_proj = iter_proj(rays_grad, pts3d_norm,
                                   p_init.contiguous(), max_iter,
                                   lambda_init, convergence_thresh)
    p1i = p1.to(torch.int32)
    p1i = torch.stack([p1i[..., 0].clamp(0, w - 1),
                       p1i[..., 1].clamp(0, h - 1)], dim=-1)

    if refine_dtype not in ("bfloat16", "int8"):
        raise ValueError(
            f"refine_dtype must be 'bfloat16' or 'int8', got "
            f"{refine_dtype!r} (a silent fall-through would quietly run "
            "bf16 while the user believes the quantized search is active)")

    # occlusion gate: 3D distance between matched points
    lin = pixel_to_lin(p1i.to(torch.int64), w)
    X11_at = torch.gather(X11.reshape(b, h * w, 3), 1,
                          lin[..., None].expand(-1, -1, 3))
    diff = X11_at - X21.reshape(b, n, 3)
    dists = torch.sqrt(_dot3(diff, diff))
    valid = valid_proj & (dists < dist_thresh)

    if radius > 0:
        cast = (_quantize_int8 if refine_dtype == "int8"
                else (lambda x: x.to(torch.bfloat16)))
        p1i = refine_matches(cast(D11).contiguous(),
                             cast(D21.reshape(b, n, -1)).contiguous(),
                             p1i.contiguous(), radius, dilation_max,
                             grid_width=wq)

    idx = pixel_to_lin(p1i.to(torch.int64), w)
    if not subpixel:
        return idx, valid[..., None]
    p_sub, _ = iter_proj(rays_grad, pts3d_norm, p1i.to(X11.dtype),
                         max(2, max_iter // 3), lambda_init,
                         convergence_thresh)
    return idx, valid[..., None], p_sub
