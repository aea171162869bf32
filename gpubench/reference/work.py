"""Work of the network's calls, counted from their shapes, and the chip's
published peaks.

``call_flops`` counts 2 operations a multiply-add of every matmul and
convolution of MASt3R (``mast3r_plain.py``) for one call of the model
interface at batch ``b``; the element-wise work is left out. ``rope_bytes``
is the least traffic of the ``rope_qk`` launches of one call: q and k read
once as float32, rotated q and k written once as float32 (the attention
products take them in float32), and each distinct (cos, sin) table pair
read once (the byte count of ``chip_smoke.py``'s ``rope_qk`` records).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _conv(hw, cin, cout, k):
    return 2 * hw[0] * hw[1] * cin * cout * k * k


def _grid(m):
    ps = m["patch_size"]
    return m["img_size"][0] // ps, m["img_size"][1] // ps


def encode_flops(m, b):
    nh, nw = _grid(m)
    n, E, ps, r = nh * nw, m["enc_embed_dim"], m["patch_size"], m["mlp_ratio"]
    block = (2 * n * E * 3 * E + 2 * 2 * n * n * E + 2 * n * E * E
             + 2 * 2 * n * E * r * E)
    return b * (2 * n * 3 * ps * ps * E + m["enc_depth"] * block)


def _head_flops(m):
    nh, nw = _grid(m)
    E, D, ps = m["enc_embed_dim"], m["dec_embed_dim"], m["patch_size"]
    ld, fd, last = m["layer_dims"], m["feature_dim"], m["last_dim"]
    idim = E + D
    g = (nh, nw)
    s0, s1 = (4 * nh, 4 * nw), (2 * nh, 2 * nw)
    s3 = ((nh - 1) // 2 + 1, (nw - 1) // 2 + 1)
    f = (_conv(g, E, ld[0], 1) + nh * nw * 16 * 2 * ld[0] * ld[0]
         + _conv(g, D, ld[1], 1) + nh * nw * 4 * 2 * ld[1] * ld[1]
         + _conv(g, D, ld[2], 1)
         + _conv(g, D, ld[3], 1) + _conv(s3, ld[3], ld[3], 3)
         + _conv(s0, ld[0], fd, 3) + _conv(s1, ld[1], fd, 3)
         + _conv(g, ld[2], fd, 3) + _conv(s3, ld[3], fd, 3))
    # refinenet4 (one unit at s3), refinenets 3..1 (two units at g, s1,
    # s0), each unit two 3x3 convs, each block's 1x1 conv at twice its size
    for size, units in ((s3, 1), (g, 2), (s1, 2), (s0, 2)):
        f += units * 2 * _conv(size, fd, fd, 3)
        f += _conv((2 * size[0], 2 * size[1]), fd, fd, 1)
    half, full = (8 * nh, 8 * nw), (16 * nh, 16 * nw)
    f += (_conv(half, fd, fd // 2, 3) + _conv(full, fd // 2, last, 3)
          + _conv(full, last, 4, 1))
    n = nh * nw
    f += 2 * n * idim * 4 * idim + 2 * n * 4 * idim * (m["desc_dim"] + 1) * ps * ps
    return f


def decode_flops(m, b):
    """One ``decode_pair`` of ``b`` pairs: both decoder streams and both
    heads."""
    nh, nw = _grid(m)
    n, E, D, r = nh * nw, m["enc_embed_dim"], m["dec_embed_dim"], m["mlp_ratio"]
    block = (2 * n * D * 3 * D + 2 * 2 * n * n * D + 2 * n * D * D
             + 4 * 2 * n * D * D + 2 * 2 * n * n * D
             + 2 * 2 * n * D * r * D)
    view = 2 * n * E * D + m["dec_depth"] * block + _head_flops(m)
    return b * 2 * view


def decode_batch(kind, b):
    """Pairs decoded by one call of ``kind`` with a leading dim ``b``:
    a symmetric call decodes each edge both ways."""
    return 2 * b if kind == "inference_symmetric" else b


def call_flops(m, kind, b):
    if kind == "encode":
        return encode_flops(m, b)
    return decode_flops(m, decode_batch(kind, b))


def rope_launches(m, kind, b):
    """[(launches, bytes of one launch)] of ``rope_qk`` in one call."""
    nh, nw = _grid(m)
    n = nh * nw
    if kind == "encode":
        E, hd = m["enc_embed_dim"], m["enc_embed_dim"] // m["enc_num_heads"]
        return [(m["enc_depth"], 16 * b * n * E + 8 * b * n * hd)]
    bb = decode_batch(kind, b)
    D, hd = m["dec_embed_dim"], m["dec_embed_dim"] // m["dec_num_heads"]
    qk = 16 * bb * n * D
    # per decoder block and stream: self-attention (one table pair), then
    # cross-attention (the tables of both views)
    return [(2 * m["dec_depth"], qk + 8 * bb * n * hd),
            (2 * m["dec_depth"], qk + 16 * bb * n * hd)]
