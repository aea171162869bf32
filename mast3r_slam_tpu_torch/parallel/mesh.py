"""The device list that the sharded backend runs over.

Counterpart of ``mast3r_slam_tpu/parallel/mesh.py`` (:46-82) for one host
and one process. The JAX package shards arrays over a ``jax.sharding.Mesh``
and lets XLA insert the collectives; here a ``Mesh`` is a tuple of devices,
a shard is a tensor on its device, and a collective is a sum in shard order
on the first device (``parallel/dist_ba.py``, ``parallel/schur.py``).

The list may repeat a device: ``make_mesh([torch.device("cpu")] * 4)``
runs four shards on the CPU, ``make_mesh(["cuda:0"] * 2)`` two on one GPU.
That stands in for the JAX tests' forced host device count. On one device
a shard of ``shard_edges`` or ``replicate`` is the same tensor or a view of
it (``Tensor.to`` copies only across devices): the callers only read them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch
import torch.nn.functional as F

__all__ = ["Mesh", "make_mesh", "normalize_device", "pad_to_multiple",
           "replicate", "shard_edges"]


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an index on CUDA:
    ``torch.device("cuda")`` and ``torch.device("cuda", 0)`` compare
    unequal, so devices are compared and used as keys only in this form."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh(NamedTuple):
    """A 1-D device mesh: shard ``s`` lives on ``devices[s]``."""

    devices: tuple
    axis: str = "edge"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Union[int, Sequence, None] = None,
              axis: str = "edge") -> Mesh:
    """A mesh over ``devices``: a list (which may repeat a device), or the
    first ``devices`` visible GPUs for an int, or every visible GPU for
    None (``mesh.py:46``)."""
    if devices is None:
        devices = torch.cuda.device_count()
    if isinstance(devices, int):
        devs = tuple(torch.device("cuda", i) for i in range(devices))
    else:
        devs = tuple(normalize_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no device")
    return Mesh(devs, axis)


def pad_to_multiple(t: torch.Tensor, multiple: int, axis: int = 0,
                    fill=0) -> torch.Tensor:
    """Pad ``axis`` with ``fill`` up to a multiple of ``multiple``, as
    ``jnp.pad`` with a constant (``mesh.py:71``); ``t`` itself when it
    already is one."""
    n = t.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return t
    axis %= t.dim()
    pad = [0, 0] * (t.dim() - axis)
    pad[-1] = target - n
    if t.dtype == torch.bool:
        return F.pad(t.to(torch.uint8), pad, value=int(fill)).to(torch.bool)
    return F.pad(t, pad, value=fill)


def shard_edges(mesh: Mesh, *tensors):
    """Each tensor's leading dimension split into ``mesh.size`` equal
    chunks, chunk ``s`` on ``mesh.devices[s]``: one list of chunks per
    tensor (``mesh.py:60``). The leading dimension must divide evenly (pad
    with ``pad_to_multiple``)."""
    out = []
    for t in tensors:
        if t.shape[0] % mesh.size:
            raise ValueError(f"shard_edges: {t.shape[0]} rows do not split "
                             f"over {mesh.size} devices")
        out.append([c.to(d) for c, d in zip(t.chunk(mesh.size), mesh.devices)])
    return tuple(out)


def replicate(mesh: Mesh, *tensors):
    """Each tensor on every device of the mesh: one list of ``mesh.size``
    tensors per tensor (``mesh.py:66``)."""
    return tuple([t.to(d) for d in mesh.devices] for t in tensors)
