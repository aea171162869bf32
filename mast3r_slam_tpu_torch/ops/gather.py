"""Row gather and ``take_along_axis`` as hand-written CUDA kernels.

The JAX package has three Pallas gather probes
(``scripts/probe_pallas_gather.py``) for the two random-access operations
of its backend, which the TPU compiler could not lower inside a kernel:

* ``gather_rows`` -> ``csrc/gather_rows.cu``: ``out[n, :] = table[idx[n], :]``
  (``variant_a`` :38 and ``variant_b`` :52 of the probe, one function moved
  two ways on the TPU; on the backend's path ``ba._gather_points``,
  ``mast3r_slam_tpu/slam/ba.py:72``);
* ``take_along`` -> ``csrc/take_along.cu``: ``take_along_axis`` of a 2-D
  array (``variant_c`` :76; on the path the confidence lookup of
  ``factor_graph._gate_edges``, ``mast3r_slam_tpu/slam/factor_graph.py:117``,
  whose two directions ``take_along_pair`` moves in one launch).

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; nothing else falls back. Indices are
trusted to be in range, as the JAX package trusts them.
"""

from __future__ import annotations

import torch

from . import _kernels


def gather_rows_plain(table, idx):
    """``table[idx]`` for a (R, C) table and (N,) indices."""
    return table.index_select(0, idx.to(torch.int64))


def gather_rows(table, idx):
    """Rows ``idx`` (N,) int32 of the fp32 ``table`` (R, C) -> (N, C)."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    _kernels.check_cuda(table, "gather_rows table", torch.float32, 2)
    _kernels.check_cuda(idx, "gather_rows idx", torch.int32, 1)
    n, c = idx.shape[0], table.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    vec4 = int(c % 4 == 0 and table.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    _kernels.launch("gather_rows", table, idx, out, n, c, vec4)
    return out


def take_along_plain(t, idx, axis: int):
    return torch.take_along_dim(t, idx.to(torch.int64), dim=axis)


def take_along_pair_plain(t0, idx0, t1, idx1, axis: int):
    return take_along_plain(t0, idx0, axis), take_along_plain(t1, idx1, axis)


def _check_take_along(t, idx, axis, name):
    _kernels.check_cuda(t, f"{name} t", torch.float32, 2)
    _kernels.check_cuda(idx, f"{name} idx", torch.int32, 2)
    if axis not in (0, 1):
        raise ValueError(f"{name}: axis must be 0 or 1, got {axis}")
    if t.shape[1 - axis] != idx.shape[1 - axis]:
        raise ValueError(f"{name}: shapes {tuple(t.shape)} and "
                         f"{tuple(idx.shape)} disagree off axis {axis}")


def _take_along_cuda(problems, axis):
    """One launch for one or two (t, idx) problems of one shape."""
    t0, i0 = problems[0]
    t1, i1 = problems[-1]
    outs = [torch.empty(i.shape, dtype=torch.float32, device=t.device)
            for t, i in problems]
    _kernels.launch("take_along", t0, i0, outs[0], t1, i1, outs[-1],
                    len(problems), axis, t0.shape[1],
                    i0.shape[0], i0.shape[1])
    return outs


def take_along(t, idx, axis: int):
    """``take_along_axis(t, idx, axis)`` for a 2-D fp32 ``t`` and int32
    ``idx``: axis 0 needs equal column counts, axis 1 equal row counts."""
    if t.device.type == "cpu":
        return take_along_plain(t, idx, axis)
    _check_take_along(t, idx, axis, "take_along")
    return _take_along_cuda([(t, idx)], axis)[0]


def take_along_pair(t0, idx0, t1, idx1, axis: int):
    """``(take_along_axis(t0, idx0, axis), take_along_axis(t1, idx1,
    axis))`` in one launch; the two problems have the same shapes (the two
    directions of the edge gate)."""
    if t0.device.type == "cpu":
        return take_along_pair_plain(t0, idx0, t1, idx1, axis)
    _check_take_along(t0, idx0, axis, "take_along_pair first")
    _check_take_along(t1, idx1, axis, "take_along_pair second")
    if t0.shape != t1.shape or idx0.shape != idx1.shape:
        raise ValueError(
            f"take_along_pair: the problems' shapes differ: "
            f"{tuple(t0.shape)}/{tuple(idx0.shape)} and "
            f"{tuple(t1.shape)}/{tuple(idx1.shape)}")
    return tuple(_take_along_cuda([(t0, idx0), (t1, idx1)], axis))
