"""Host-side image preprocessing (the dataset decode path).

The port's copy of ``mast3r_slam_tpu/io/image.py``: the long side to
``size`` with LANCZOS when shrinking and BICUBIC otherwise, a centre crop to
multiples of 16, and the ``(x - 0.5) / 0.5`` normalization. Pillow is
imported only when the long side differs from ``size``: Pillow's ``resize``
to the image's own size returns a copy, so skipping it gives the same
pixels. The crop is numpy slicing (the crop box always lies inside the
image, so Pillow's zero padding never applies).
"""

from __future__ import annotations

import numpy as np


def _resize_pil(img: np.ndarray, long_edge: int) -> np.ndarray:
    import PIL.Image

    pil = PIL.Image.fromarray(img)
    S = max(pil.size)
    interp = PIL.Image.LANCZOS if S > long_edge else PIL.Image.BICUBIC
    new_size = tuple(int(round(x * long_edge / S)) for x in pil.size)
    return np.array(pil.resize(new_size, interp))     # writable


def resize_img(img: np.ndarray, size: int = 512, return_transformation=False):
    """img: (H, W, 3) float in [0, 1] or uint8. Returns a dict with ``img``
    (h, w, 3) normalized float32, ``img_u8`` the raw uint8 pixels,
    ``unnormalized`` (h, w, 3) float32 in [0, 1] and ``true_shape`` (h, w);
    with ``return_transformation`` also (scale_w, scale_h, half_crop_w,
    half_crop_h)."""
    if img.dtype != np.uint8:
        img = np.uint8(np.clip(img, 0.0, 1.0) * 255)
    H1, W1 = img.shape[:2]
    if max(H1, W1) != size:
        img = _resize_pil(img, size)
    H, W = img.shape[:2]
    cx, cy = W // 2, H // 2
    halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
    if W == H:
        halfh = 3 * halfw // 4
    u8 = np.ascontiguousarray(img[cy - halfh:cy + halfh,
                                  cx - halfw:cx + halfw])

    arr = u8.astype(np.float32) / 255.0
    res = {
        "img": (arr - 0.5) / 0.5,
        # raw pixels for the upload; models.mast3r.encode normalizes uint8
        # inputs on the device with the same expression
        "img_u8": u8,
        "unnormalized": arr,
        "true_shape": (arr.shape[0], arr.shape[1]),
    }
    if return_transformation:
        scale_w = W1 / W
        scale_h = H1 / H
        half_crop_w = (W - u8.shape[1]) / 2
        half_crop_h = (H - u8.shape[0]) / 2
        return res, (scale_w, scale_h, half_crop_w, half_crop_h)
    return res
