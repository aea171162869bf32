"""Dense coarse-to-fine correspondence matcher for loop-closure and
relocalization edges, which have no warm start.

Counterpart of ``mast3r_slam_tpu/ops/dense_matcher.py``:

1. coarse: every query of the stride-2 subgrid is correlated with a strided
   grid of target descriptors and takes the best cell, a global search that
   stands in for a warm start. ``coarse_correlate`` ->
   ``csrc/coarse_correlate.cu`` (replaces the XLA ``coarse_correlate``,
   ``dense_matcher.py:37``): a hand-written tensor-core kernel that fuses
   the correlation with the row argmax and never writes the score matrix.
   The tensor cores add the products in an order of their own, so the
   kernel is held to the plain version by ``check_coarse_correlate``'s tie
   rule, not index by index;
2. polish + fine: the winners seed the pyramidal matcher the tracking path
   uses (``ops.matching.match`` with the subgrid LM, the window refine and
   the occlusion gate).

The wrapper launches the kernel for CUDA tensors and runs the plain PyTorch
version beside it for CPU tensors; nothing else falls back.
"""

from __future__ import annotations

import torch

from . import _kernels, matching


def _cell_to_pixel(idx_c, h, w, stride):
    """Coarse cell -> full-resolution linear index of the cell center."""
    wc = -(-w // stride)
    uc = idx_c % wc
    vc = torch.div(idx_c, wc, rounding_mode="floor")
    u = torch.clamp(uc * stride + stride // 2, max=w - 1)
    v = torch.clamp(vc * stride + stride // 2, max=h - 1)
    return v * w + u


def coarse_scores_plain(D21, D11, stride: int = 4):
    """The bf16-rounded score matrix (b, n, cells) as fp32: the fp32 sum
    over the features in order, as the kernel accumulates it, rounded to
    bf16 before any comparison. For the plain version and for checks."""
    b, h, w, f = D11.shape
    Dc = D11[:, ::stride, ::stride].reshape(b, -1, f).to(torch.float32)
    q = D21.to(torch.float32)
    s = torch.zeros((b, q.shape[1], Dc.shape[1]), dtype=torch.float32,
                    device=D11.device)
    for c in range(f):
        s = s + q[:, :, None, c] * Dc[:, None, :, c]
    return s.to(torch.bfloat16).to(torch.float32)


def coarse_correlate_plain(D21, D11, stride: int = 4, row_tile: int = 2048):
    """Plain version of ``coarse_correlate``, in row tiles so the score
    matrix stays small. ``argmax`` takes the first maximum and treats NaN
    as the maximum, as ``jnp.argmax`` does."""
    b, h, w, f = D11.shape
    n = D21.shape[1]
    idx = [torch.argmax(coarse_scores_plain(D21[:, r0:r0 + row_tile], D11,
                                            stride), dim=-1)
           for r0 in range(0, n, row_tile)]
    idx_c = torch.cat(idx, dim=1) if idx else torch.zeros(
        (b, 0), dtype=torch.int64, device=D11.device)
    return _cell_to_pixel(idx_c, h, w, stride).to(torch.int32)


def _bf16_steps(s):
    """Signed count of representable bf16 values between 0 and ``s`` (fp32
    holding bf16 values): neighbours differ by one, +0 and -0 are both 0.
    NaN has no place in the order; callers mask it."""
    bits = s.contiguous().view(torch.int32) >> 16
    mag = (bits & 0x7fff).to(torch.int64)
    return torch.where(bits < 0, -mag, mag)


def tie_rule_violations(scores, cells):
    """Hold chosen cells to the plain scores by the rule a product with no
    fixed summation order can meet.

    ``scores`` (b, r, cells) fp32 holding bf16 values (``coarse_scores_plain``),
    ``cells`` (b, r) the chosen coarse cells. Counts, over the rows:

    * ``score_off``: the chosen cell's plain score is more than one bf16
      step below the row's plain maximum (rows without a NaN score);
    * ``unique_moved``: the plain maximum is unique by more than one bf16
      step, yet the chosen cell is not the plain argmax;
    * ``nan_wrong``: the row has a NaN score and the chosen cell is not the
      first NaN cell (``argmax`` treats NaN as the maximum);
    * ``identical``: the chosen cell equals the plain ``argmax``;
    * ``rows``."""
    cells = cells.to(torch.int64)
    ref = torch.argmax(scores, dim=-1)
    isnan = torch.isnan(scores)
    has_nan = isnan.any(dim=-1)
    lowest = torch.finfo(torch.float32).min
    key = torch.where(isnan, torch.full_like(scores, lowest), scores)
    steps = _bf16_steps(key)
    top2 = torch.topk(steps, min(2, steps.shape[-1]), dim=-1).values
    chosen = torch.gather(steps, -1, cells[..., None])[..., 0]
    off = (top2[..., 0] - chosen > 1) & ~has_nan
    if top2.shape[-1] > 1:
        unique = (top2[..., 0] - top2[..., 1] > 1) & ~has_nan
    else:
        unique = ~has_nan
    return {"score_off": int(off.sum()),
            "unique_moved": int((unique & (cells != ref)).sum()),
            "nan_wrong": int((has_nan & (cells != ref)).sum()),
            "identical": int((cells == ref).sum()),
            "rows": cells.numel()}


def check_coarse_correlate(got, D21, D11, stride: int = 4,
                           row_tile: int = 2048):
    """``tie_rule_violations`` of ``coarse_correlate``'s output ``got``
    (b, n) against the plain scores of the same inputs, in row tiles, plus
    ``identical_share``. ``coarse_correlate`` meets the rule when
    ``score_off``, ``unique_moved`` and ``nan_wrong`` are all 0."""
    b, h, w, f = D11.shape
    wc = -(-w // stride)
    g = got.to(torch.int64)
    cells = torch.div(torch.div(g, w, rounding_mode="floor"), stride,
                      rounding_mode="floor") * wc + torch.div(
                          g % w, stride, rounding_mode="floor")
    total = {"score_off": 0, "unique_moved": 0, "nan_wrong": 0,
             "identical": 0, "rows": 0}
    for r0 in range(0, D21.shape[1], row_tile):
        sc = coarse_scores_plain(D21[:, r0:r0 + row_tile], D11, stride)
        part = tie_rule_violations(sc, cells[:, r0:r0 + row_tile])
        for k in total:
            total[k] += part[k]
    total["identical_share"] = total["identical"] / max(total["rows"], 1)
    return total


def coarse_correlate(D21, D11, stride: int = 4):
    """argmax_j <D21[p], D11_coarse[j]> for every query point p
    (``dense_matcher.py:37``).

    D21 (b, n, f) bf16 query descriptors; D11 (b, h, w, f) bf16 target
    descriptor image. The score is rounded to bf16 before the argmax, the
    first maximum wins. Returns (b, n) int32 full-resolution linear indices
    of the best coarse cell's center. On the GPU the product runs on the
    tensor cores, whose summation order can move a score by one bf16 step
    and with it a tie (``check_coarse_correlate``)."""
    if D11.device.type == "cpu":
        return coarse_correlate_plain(D21, D11, stride)
    _kernels.check_cuda(D11, "coarse_correlate D11", torch.bfloat16, 4)
    b, h, w, f = D11.shape
    _kernels.check_cuda(D21, "coarse_correlate D21", torch.bfloat16, 3, f)
    if D21.shape[0] != b:
        raise ValueError("coarse_correlate: batch sizes disagree")
    if f not in (8, 16, 24, 32):
        raise ValueError(f"coarse_correlate: descriptor width {f} not built "
                         "(8, 16, 24 or 32)")
    if stride < 1 or D11.data_ptr() % 16 or D21.data_ptr() % 16:
        raise ValueError("coarse_correlate: needs stride >= 1 and 16-byte "
                         "aligned descriptors")
    hc, wc = -(-h // stride), -(-w // stride)
    if hc * wc * wc >= 2 ** 32:
        raise ValueError(f"coarse_correlate: {hc} x {wc} cells are more than "
                         "the kernel's cell index arithmetic holds")
    n = D21.shape[1]
    out = torch.empty((b, n), dtype=torch.int32, device=D11.device)
    _kernels.launch("coarse_correlate", D21, D11, out, b, n, h, w, f,
                    int(stride))
    return out


def match_dense(X11, X21, D11, D21, stride: int = 4, fine_radius: int = 3,
                fine_dilation: int = 2, dist_thresh: float = 0.1,
                lm_iters: int = 3, lambda_init: float = 1e-8,
                convergence_thresh: float = 1e-6, query_stride: int = 1):
    """The dense matcher (``dense_matcher.py:83``); same contract as
    ``ops.matching.match``: returns (idx_1_to_2 (b, n) int64, valid
    (b, n, 1) bool).

    ``query_stride`` > 1 matches only every qs-th column of view 2 (the
    points bundle adjustment reads at ``point_stride == qs``) and scatters
    the results into full-size arrays, ``valid`` False elsewhere. Needs
    w % qs == 0 and an even query grid; the caller checks."""
    b, h, w, _ = X11.shape
    n = h * w
    qs = int(query_stride)
    X21q = X21[:, :, ::qs] if qs > 1 else X21
    D21q = D21[:, :, ::qs] if qs > 1 else D21
    wq = X21q.shape[2]
    nq = h * wq
    dev = X11.device

    # 1) coarse correlation on the stride-2 subgrid of the (possibly
    # column-strided) query grid
    D21qq = D21q[:, ::2, ::2].reshape(b, nq // 4, -1).to(
        torch.bfloat16).contiguous()
    idx_c = coarse_correlate(D21qq, D11.to(torch.bfloat16).contiguous(),
                             stride).to(torch.int64)
    # upsampled flow -> per-query integer warm start (target coordinates at
    # full resolution; query positions are their true full-image pixels)
    pq = matching.lin_to_pixel(idx_c, w)                  # (b, nq/4, 2)
    ar = lambda *a: torch.arange(*a, device=dev)
    vv, uu = torch.meshgrid(ar(0, h, 2), ar(0, w, 2 * qs), indexing="ij")
    qpos = torch.stack([uu, vv], dim=-1).reshape(1, nq // 4, 2)
    flow = (pq - qpos).reshape(b, h // 2, wq // 2, 2)
    flow_up = flow.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    vv, uu = torch.meshgrid(ar(h), ar(0, w, qs), indexing="ij")
    upos = torch.stack([uu, vv], dim=-1)[None]            # (1, h, wq, 2)
    # the bounds (w - 1, h - 1) made on the device: no upload, so that the
    # backend's edge chain captures as one CUDA graph
    hi = torch.full((2,), h - 1, dtype=upos.dtype, device=dev)
    hi[:1].fill_(w - 1)
    p0 = torch.minimum(torch.clamp(upos + flow_up, min=0), hi)
    idx_init = matching.pixel_to_lin(p0.reshape(b, nq, 2), w)

    # 2) pyramidal LM polish + window refine + occlusion gate: the tracking
    # matcher, warm-started by the correlation
    idx_q, valid_q = matching.match(
        X11, X21q, D11, D21q, idx_1_to_2_init=idx_init, max_iter=0,
        coarse_iter=max(int(lm_iters), 1), lambda_init=lambda_init,
        convergence_thresh=convergence_thresh, dist_thresh=dist_thresh,
        radius=fine_radius, dilation_max=fine_dilation)
    if qs == 1:
        return idx_q, valid_q
    idx = torch.zeros((b, h, w), dtype=idx_q.dtype, device=dev)
    idx[:, :, ::qs] = idx_q.reshape(b, h, wq)
    valid = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    valid[:, :, ::qs] = valid_q.reshape(b, h, wq)
    return idx.reshape(b, n), valid.reshape(b, n, 1)
