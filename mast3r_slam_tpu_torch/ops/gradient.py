"""Scharr image gradients and the matcher's ray-plus-gradient image.

Counterparts of ``mast3r_slam_tpu/ops/gradient.py::img_gradient`` and
``mast3r_slam_tpu/ops/matching.py::prep_rays_grad`` (:47). On a CUDA tensor
they launch the hand-written kernel ``csrc/scharr_rays.cu``, which replaces
the Pallas kernel ``mast3r_slam_tpu/ops/pallas_gradient.py::_scharr_kernel``
(:31); ``prep_rays_grad`` fuses the ray normalization into it, as a tiled
kernel. ``prep_rays_grad_padded`` writes the same image with each pixel's
record padded to 12 floats (48 bytes, 16-byte aligned), the layout in which
``ops/matching.iter_proj`` reads its taps with vector loads. On a CPU tensor
they run the plain versions below. There is no other fallback.
"""

from __future__ import annotations

import torch

from . import _kernels


def l2_normalize(x, eps: float = 1e-12):
    """x / max(|x|, eps) over the last dim; the 3-vector sum runs in the
    kernels' order."""
    if x.shape[-1] == 3:
        sq = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
              + x[..., 2] * x[..., 2])
    else:
        sq = torch.sum(x * x, dim=-1)
    n = torch.sqrt(sq)[..., None]
    return x / torch.clamp(n, min=eps)


def _reflect_pad_hw(img):
    """Reflect-pad (..., h, w, c) by one pixel on h and w (numpy
    "reflect": the edge is not repeated)."""
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    rows = torch.tensor([1, *range(h), h - 2], device=dev)
    cols = torch.tensor([1, *range(w), w - 2], device=dev)
    return img.index_select(-3, rows).index_select(-2, cols)


def img_gradient_plain(img):
    """Plain Scharr stencil: (..., h, w, c) -> (gx, gy)."""
    p = _reflect_pad_hw(img)
    h, w = img.shape[-3], img.shape[-2]

    def sh(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, :]

    gx = (1.0 / 32.0) * (
        3.0 * (sh(-1, 1) - sh(-1, -1))
        + 10.0 * (sh(0, 1) - sh(0, -1))
        + 3.0 * (sh(1, 1) - sh(1, -1)))
    gy = (1.0 / 32.0) * (
        3.0 * (sh(1, -1) - sh(-1, -1))
        + 10.0 * (sh(1, 0) - sh(-1, 0))
        + 3.0 * (sh(1, 1) - sh(-1, 1)))
    return gx, gy


def prep_rays_grad_plain(X11):
    """Plain (b, h, w, 3) -> (b, h, w, 9) [ray, gx, gy]."""
    rays = l2_normalize(X11)
    gx, gy = img_gradient_plain(rays)
    return torch.cat([rays, gx, gy], dim=-1)


def prep_rays_grad_padded_plain(X11):
    """Plain (b, h, w, 3) -> (b, h, w, 12) [ray, gx, gy, 0, 0, 0]."""
    out = prep_rays_grad_plain(X11)
    return torch.cat([out, torch.zeros_like(out[..., :3])], dim=-1)


def _scharr_cuda(img, normalize: bool, out_c=None, tiled: bool = True):
    """Launch ``scharr_rays``. With ``normalize`` (c == 3) the record has
    ``out_c`` = 9 or 12 floats, written by the tiled kernel, or with
    ``tiled=False`` (9 floats only) by the first design, one thread a
    pixel; without it, 2c ([gx, gy]), one thread a pixel."""
    _kernels.check_cuda(img, "scharr_rays", torch.float32)
    if img.dim() < 3:
        raise ValueError(f"scharr_rays: expected (..., h, w, c), got "
                         f"{tuple(img.shape)}")
    *lead, h, w, c = img.shape
    if h < 2 or w < 2:
        raise ValueError("scharr_rays: reflect padding needs h, w >= 2")
    if normalize and c != 3:
        raise ValueError("scharr_rays: ray normalization needs c == 3")
    B = 1
    for s in lead:
        B *= s
    if normalize:
        out_c = 9 if out_c is None else out_c
        if out_c not in (9, 12) or (out_c == 12 and not tiled):
            raise ValueError(f"scharr_rays: a {out_c}-float record is not "
                             f"built by the {'tiled' if tiled else 'per-pixel'}"
                             " kernel")
        offs = (out_c, 0, 3, 6)
    else:
        out_c, offs, tiled = 2 * c, (2 * c, -1, 0, c), False
    out = torch.empty((*lead, h, w, out_c), dtype=img.dtype,
                      device=img.device)
    _kernels.launch("scharr_rays", img, out, B, h, w, c, *offs,
                    int(normalize), int(tiled))
    return out


def img_gradient(img):
    """Scharr x/y gradients of (..., h, w, c) fp32 images -> (gx, gy)."""
    if img.device.type == "cpu":
        return img_gradient_plain(img)
    out = _scharr_cuda(img, normalize=False)
    c = img.shape[-1]
    return out[..., :c], out[..., c:]


def prep_rays_grad(X11):
    """Normalized-ray image with Scharr gradients: (b,h,w,3) -> (b,h,w,9)."""
    if X11.device.type == "cpu":
        return prep_rays_grad_plain(X11)
    return _scharr_cuda(X11, normalize=True)


def prep_rays_grad_padded(X11):
    """The same image as ``prep_rays_grad`` with every pixel's record padded
    by three zeros: (b,h,w,3) -> (b,h,w,12), the layout in which
    ``iter_proj`` reads its taps with vector loads."""
    if X11.device.type == "cpu":
        return prep_rays_grad_padded_plain(X11)
    return _scharr_cuda(X11, normalize=True, out_c=12)
