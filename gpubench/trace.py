"""The profiled part of the window read as intervals: device activity
(kernels, copies, fills) and the benchmark's host ranges, on the
profiler's clock, in seconds."""

from __future__ import annotations

import torch


def _times(e):
    if hasattr(e, "start_ns"):
        return e.start_ns() * 1e-9, e.duration_ns() * 1e-9
    return e.start_us() * 1e-6, e.duration_us() * 1e-6


def read_profile(prof, range_names):
    """(device [(name, t0, t1)], ranges [(name, t0, t1)]) of the profile
    ``prof`` (``torch.profiler.profile`` after its exit); ``ranges`` keeps
    the host ranges whose names are in ``range_names``. The profiler mirrors
    each host range onto the device's timeline as an annotation: those are
    not device work and are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    device, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        t0, dt = _times(e)
        if e.device_type() == cuda:
            if e.name() not in range_names:
                device.append((e.name(), t0, t0 + dt))
        elif e.name() in range_names:
            ranges.append((e.name(), t0, t0 + dt))
    return device, ranges


def merge(intervals, lo, hi):
    """The union of ``intervals`` [(t0, t1)] within [lo, hi], sorted."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_and_gaps(device, lo, hi):
    busy = merge([(a, b) for _, a, b in device], lo, hi)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    return sum(b - a for a, b in busy), gaps


def breakdown(device, ranges, lo, hi, top=10):
    """The device operations that took most time, and the idle gaps summed
    by the innermost benchmark range the host was in when each began."""
    by_op = {}
    for name, a, b in device:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    _, gaps = busy_and_gaps(device, lo, hi)
    by_host = {}
    for a, b in gaps:
        inside = [r for r in ranges if r[1] <= a < r[2]]
        name = (min(inside, key=lambda r: r[2] - r[1])[0] if inside
                else "outside the benchmark's ranges")
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
