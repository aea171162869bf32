"""The device mesh that the sharded backend and data-parallel tracking run
over, in one process or across processes.

Counterpart of ``mast3r_slam_tpu/parallel/mesh.py``. The JAX package shards
arrays over a ``jax.sharding.Mesh`` and lets XLA insert the collectives;
here a ``Mesh`` is this process's tuple of devices plus the process layout,
a shard is a tensor on its device, and the collectives are three
functions: ``reduce_partials`` (the partials of this process's shards
combined in shard order on its first device, then one
``torch.distributed.all_reduce`` across processes), ``exchange`` (tensors
sent from each rank to each other, one ``all_to_all_single`` a dtype) and
``all_gather_shards`` (every shard's tensors, in global shard order, on
every rank's first device: one ``all_gather_into_tensor`` a dtype). The
last two move bits and do no arithmetic.

In one process the device list may repeat a device:
``make_mesh([torch.device("cpu")] * 4)`` runs four shards on the CPU,
``make_mesh(["cuda:0"] * 2)`` two on one GPU. That stands in for the JAX
tests' forced host device count. On one device a shard of ``shard_edges``
or ``replicate`` is the same tensor or a view of it (``Tensor.to`` copies
only across devices): the callers only read them.

Across processes (``init_distributed``, then ``make_mesh``): every rank
holds the same number of local devices, the mesh has ``world_size *
len(devices)`` shards, and shard ``s`` lives on rank ``s // len(devices)``,
on its local device ``s % len(devices)``. The process group's backend is
``SLAM_DIST_BACKEND`` when set, else NCCL for a run on CUDA and gloo on the
CPU. NCCL refuses two ranks on one GPU; two ranks on a machine with one
GPU set ``SLAM_DIST_BACKEND=gloo``, whose all-reduce of CUDA tensors goes
through the host. Gloo takes CUDA tensors in the two moves as well
(PyTorch's gloo stages them through the host itself), so every collective
here passes the tensors as they are, on any backend.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F

__all__ = ["Mesh", "all_gather_shards", "dist_backend", "exchange",
           "init_distributed", "make_mesh", "make_mesh_2d",
           "normalize_device", "pad_to_multiple", "reduce_partials",
           "replicate", "shard_edges"]


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an index on CUDA:
    ``torch.device("cuda")`` and ``torch.device("cuda", 0)`` compare
    unequal, so devices are compared and used as keys only in this form."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dist_backend(device=None) -> str:
    """The process group's backend: ``SLAM_DIST_BACKEND`` when set, else
    "nccl" for a run on CUDA (``device`` None: when a GPU is visible) and
    "gloo" on the CPU."""
    chosen = os.environ.get("SLAM_DIST_BACKEND")
    if chosen:
        return chosen
    on_cuda = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    return "nccl" if on_cuda else "gloo"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None) -> bool:
    """Join the process group of a multi-host run (``mesh.py:18``).

    Reads ``SLAM_COORDINATOR`` (host:port of rank 0's rendezvous),
    ``SLAM_NUM_PROCESSES`` and ``SLAM_PROCESS_ID`` for the arguments left
    out. One process: no process group, returns False, so callers may call
    it unconditionally. Otherwise ``torch.distributed.init_process_group``
    over ``tcp://<coordinator>`` with the backend of ``dist_backend(device)``
    and returns True; a failed rendezvous raises."""
    if num_processes is None:
        num_processes = int(os.environ.get("SLAM_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    import torch.distributed as dist

    dist.init_process_group(
        dist_backend(device),
        init_method=f"tcp://{coordinator or os.environ['SLAM_COORDINATOR']}",
        world_size=num_processes,
        rank=(process_id if process_id is not None
              else int(os.environ["SLAM_PROCESS_ID"])))
    return True


def _process_group():
    """(rank, world size, group) of the initialized process group, or
    (0, 1, None)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    return 0, 1, None


class Mesh(NamedTuple):
    """A device mesh: this process's ``devices`` and the process layout.

    Shard ``s`` of the ``size = world_size * len(devices)`` shards lives on
    rank ``s // len(devices)``, on local device ``devices[s %
    len(devices)]``; in one process (``world_size`` 1, ``group`` None) on
    ``devices[s]``. ``axis``: the axis name, or the pair of names of
    ``make_mesh_2d``."""

    devices: tuple
    axis: Any = "edge"
    rank: int = 0
    world_size: int = 1
    group: Any = None

    @property
    def size(self) -> int:
        return self.world_size * len(self.devices)

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def shape(self) -> tuple:
        """(processes, local devices): the layout of ``make_mesh_2d``."""
        return (self.world_size, len(self.devices))


def make_mesh(devices: Union[int, Sequence, None] = None,
              axis="edge") -> Mesh:
    """A mesh over ``devices`` (``mesh.py:46``).

    In one process: a list (which may repeat a device), or the first
    ``devices`` visible GPUs for an int, or every visible GPU for None.
    After ``init_distributed`` the mesh spans every rank: a list is this
    rank's local devices, None every visible GPU, and an int must be the
    global count (ranks x visible GPUs), as JAX's
    ``make_mesh(jax.device_count())``."""
    rank, world, group = _process_group()
    n_gpu = torch.cuda.device_count()
    if devices is None:
        devices = n_gpu * world
    if isinstance(devices, int):
        if world > 1 and devices != world * n_gpu:
            raise ValueError(f"make_mesh({devices}) across {world} processes: "
                             f"a mesh across processes spans all {world} x "
                             f"{n_gpu} GPUs")
        devs = tuple(torch.device("cuda", i) for i in range(devices // world))
    else:
        devs = tuple(normalize_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no device")
    return Mesh(devs, axis, rank, world, group)


def make_mesh_2d(axes=("host", "edge"), devices=None) -> Mesh:
    """The (processes, local devices) mesh (``mesh.py:53``): shard ``s``
    on process ``s // n_local``, local device ``s % n_local``, so the
    fast ``edge`` axis stays within a host. ``devices``: this process's
    devices (default every visible GPU)."""
    return make_mesh(None if devices is None else list(devices), axis=axes)


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
    chunks; this process's chunks, chunk ``first_shard + l`` on
    ``mesh.devices[l]``: one list of chunks per tensor (``mesh.py:60``).
    The leading dimension must divide evenly (pad with
    ``pad_to_multiple``)."""
    out = []
    lo = mesh.first_shard
    for t in tensors:
        if t.shape[0] % mesh.size:
            raise ValueError(f"shard_edges: {t.shape[0]} rows do not split "
                             f"over {mesh.size} devices")
        mine = t.chunk(mesh.size)[lo:lo + len(mesh.devices)]
        out.append([c.to(d) for c, d in zip(mine, mesh.devices)])
    return tuple(out)


def replicate(mesh: Mesh, *tensors):
    """Each tensor on every local device of the mesh: one list of
    ``len(mesh.devices)`` tensors per tensor (``mesh.py:66``)."""
    return tuple([t.to(d) for d in mesh.devices] for t in tensors)


def reduce_partials(mesh: Mesh, partials, op: str = "sum"):
    """Combine each shard's partial results over the whole mesh.

    ``partials``: one tuple of tensors per local shard, in shard order.
    Returns one tuple, on the first local device: this process's partials
    summed (``op="sum"``) or min-reduced (``op="min"``; bool tensors
    allowed) in shard order there, then, across processes, ``all_reduce``d,
    one call a dtype (the tensors of one dtype go as one flat buffer). Every
    rank gets the same bits: ranks add or compare the same per-rank
    values."""
    if op not in ("sum", "min"):
        raise ValueError(f"reduce_partials: unknown op {op!r}")
    d0 = mesh.devices[0]
    acc = None
    for part in partials:
        part = [p.to(d0) for p in part]
        if acc is None:
            acc = part
        elif op == "sum":
            acc = [a + p for a, p in zip(acc, part)]
        else:
            acc = [torch.minimum(a, p) for a, p in zip(acc, part)]
    if mesh.world_size > 1:
        acc = _all_reduce(acc, op, mesh.group)
    return tuple(acc)


def exchange(mesh: Mesh, send, recv, dtypes):
    """Tensors from each rank to each other rank, moved bit for bit.

    ``send[r]``: the list of tensors this rank sends to rank ``r``;
    ``recv[r]``: the (shape, dtype) of each tensor it gets from rank ``r``,
    in the order rank ``r`` sends them. Both sides know every size, so no
    size message is sent. Returns ``got[r]``, the tensors from rank ``r``,
    on the first local device. Across processes: one ``all_to_all_single``
    a dtype, over one flat buffer ordered by rank, each rank's tensors in
    list order. ``dtypes``: every dtype that any rank moves, the same
    list on every rank (each is one collective, so a rank that names
    fewer would leave the others waiting). In one process ``send[0]``
    comes back as local copies."""
    d0 = mesh.devices[0]
    if mesh.world_size == 1:
        return [[t.to(d0, copy=True) for t in send[0]]]
    import torch.distributed as dist

    got = [[None] * len(specs) for specs in recv]
    for dtype in dtypes:
        mine = [[t for t in ts if t.dtype == dtype] for ts in send]
        theirs = [[(r, i, torch.Size(shape)) for i, (shape, dt)
                   in enumerate(specs) if dt == dtype]
                  for r, specs in enumerate(recv)]
        out_split = [sum(shape.numel() for *_, shape in ts) for ts in theirs]
        out = torch.empty(sum(out_split), dtype=dtype, device=d0)
        dist.all_to_all_single(
            out, _pack([t for ts in mine for t in ts], dtype, d0), out_split,
            [sum(t.numel() for t in ts) for ts in mine], group=mesh.group)
        slots = [slot for ts in theirs for slot in ts]
        pieces = _unpack(out, [shape for *_, shape in slots])
        for (r, i, _), piece in zip(slots, pieces):
            got[r][i] = piece
    return got


def all_gather_shards(mesh: Mesh, shards):
    """Every shard's tensors over the whole mesh, bit for bit.

    ``shards``: one tuple of tensors per local shard, in shard order; the
    shards' tensors agree in dtype and in all but the leading dimension,
    which every rank must hold at the same sizes. Returns one tuple, on the
    first local device: each tensor concatenated over the ``mesh.size``
    shards in global shard order along its leading dimension. Across
    processes: this rank's shards as one flat buffer a dtype, one
    ``all_gather_into_tensor`` a dtype; in one process, local copies."""
    d0 = mesh.devices[0]
    n_t = len(shards[0])
    if mesh.world_size == 1:
        return tuple(torch.cat([sh[k].to(d0) for sh in shards])
                     for k in range(n_t))
    import torch.distributed as dist

    parts = [[None] * mesh.size for _ in range(n_t)]
    for dtype, ks in _by_dtype(shards[0]).items():
        mine = [sh[k] for sh in shards for k in ks]   # shard-major
        out = torch.empty(mesh.world_size * sum(t.numel() for t in mine),
                          dtype=dtype, device=d0)
        dist.all_gather_into_tensor(out, _pack(mine, dtype, d0),
                                    group=mesh.group)
        # every rank sends its shards at this rank's shapes
        pieces = _unpack(out, [t.shape for t in mine] * mesh.world_size)
        for j, piece in enumerate(pieces):
            s, k = divmod(j, len(ks))       # global shard s, its k-th tensor
            parts[ks[k]][s] = piece
    return tuple(torch.cat(p) for p in parts)


def _all_reduce(tensors, op: str, group):
    import torch.distributed as dist

    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MIN
    out = list(tensors)
    for dtype, idx in _by_dtype(tensors).items():
        flat = _pack([tensors[i] for i in idx], dtype, tensors[idx[0]].device)
        if dtype == torch.bool:
            flat = flat.to(torch.int32)
        dist.all_reduce(flat, op=red, group=group)
        pieces = _unpack(flat.to(dtype), [tensors[i].shape for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece
    return out


def _by_dtype(tensors):
    """The positions of ``tensors`` grouped by dtype, in first-seen order:
    each group is one flat buffer and one collective."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _pack(tensors, dtype, device):
    """``tensors`` (all of ``dtype``, maybe none) flattened in order into
    one buffer on ``device``."""
    return torch.cat([torch.empty(0, dtype=dtype, device=device)]
                     + [t.to(device).reshape(-1) for t in tensors])


def _unpack(flat, shapes):
    """``flat`` cut in order into tensors of ``shapes`` (views of it)."""
    shapes = [torch.Size(s) for s in shapes]
    return [piece.reshape(s) for piece, s
            in zip(flat.split([s.numel() for s in shapes]), shapes)]
