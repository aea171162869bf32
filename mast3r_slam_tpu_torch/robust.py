"""Robust weights and the convergence test (``mast3r_slam_tpu/robust.py``)."""

from __future__ import annotations

import math

import torch


def huber(r, k: float = 1.345):
    r_abs = torch.abs(r)
    return torch.where(r_abs < k, torch.ones_like(r),
                       k / torch.clamp(r_abs, min=1e-30))


def tukey(r, t: float = 4.6851):
    r_abs = torch.abs(r)
    tmp = 1.0 - (r_abs / t) ** 2
    return torch.where(r_abs < t, tmp * tmp, torch.zeros_like(r))


def converged(rel_error_threshold, delta_norm_threshold, old_cost, new_cost,
              delta):
    """Relative cost decrease or step norm below threshold
    (``robust.py:22``). Works on tensors, without a host sync."""
    finite_old = torch.isfinite(old_cost)
    safe_old = torch.where(finite_old & (old_cost != 0), old_cost,
                           torch.ones_like(old_cost))
    rel_dec = torch.abs((old_cost - new_cost) / safe_old)
    rel_dec = torch.where(finite_old, rel_dec,
                          torch.full_like(rel_dec, math.inf))
    delta_norm = torch.sqrt(torch.sum(delta * delta))
    return (rel_dec < rel_error_threshold) | (delta_norm < delta_norm_threshold)
