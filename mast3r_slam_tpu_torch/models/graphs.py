"""CUDA graphs of the program's inference work.

Eagerly, a call enqueues its kernels one by one, and the device waits for
the host while it does; a CUDA graph of the call replays them all in one
launch. A graph replays the kernels that the eager call launches, at the
same dtypes: nothing is dropped, fused or lowered. Three callers share
this module:

- ``mast3r.encode`` and ``mast3r.decode_pair`` (both decoders and both DPT
  heads), through ``run``;
- the backend's edge chain after the symmetric decode (match, gate and
  append, ``slam/factor_graph.py``), through ``run``;
- a bundle adjustment's Gauss-Newton iteration (``slam/ba.py``), through
  ``capture``: one graph a solve, replayed for each iteration and dropped
  when the solve returns. Its first call captures at once; before a
  thread's first capture on a device, ``capture`` makes the thread's
  cuBLAS and cuSOLVER handles (``_prepare``).

Which path a call takes is decided from what the call shows:

- **Eager**: CPU tensors, or grad enabled (``eager``).
- **Key** (``run``): the caller's key (the kind of call and what the body
  bakes in, such as a configuration), the device, the current stream, and
  each input's shape and dtype. Each owner (a module, a factor graph) has
  its own keys: they are held beside it in a weak map, so its graphs die
  with it and a copy of it starts with none.
- **Lifecycle of a key** (``run``): the first call runs eagerly and
  returns its own result; it is also the warm-up that capture needs
  (cuBLAS and cuSOLVER handles, cuDNN plans, the hand kernels'
  libraries). The second call captures, then replays. Every later call
  replays.

A call with a graph copies its inputs into the graph's static input
tensors (allocated outside the graph pool), replays, and returns clones of
the static outputs, so no caller ever holds a buffer that the next replay
overwrites (the CLI keeps decoded maps in its keyframes). Where the caller
asks (``share_inputs``), the graphs of one owner and key take their static
inputs as leading rows of one set of tensors sized for the largest call
seen, so that a key per batch size does not hold its own copy; a call
larger than those tensors makes larger ones and drops the graphs that read
the old ones (they capture again on their next call). The copy-in, the
replay and the clone-out are enqueued under one lock per (device, stream),
so the threaded backend's calls cannot interleave with the frontend's on a
shared stream.

All graphs of one (device, stream) share one memory pool, which lives as
long as the process. That is safe:
their replays run in sequence on that stream, each graph's static outputs
live as long as the graph (so a later capture never takes their memory),
and the outputs are cloned before the next replay. A capture runs on a
side stream of its own (device, stream) pair, with
``capture_error_mode="thread_local"``, so that another thread launching
work meanwhile is not disturbed; the replays run on the caller's stream.

A graph reads its tensors where they lay at capture: the network's
weights (change them in place, ``load_state_dict`` copies in place, not by
assigning new tensors to the parameters), the edge buffers (part of the
edge chain's key), a solve's prepared edges.

The hand kernels launched while a graph is captured (``rope_qk``,
``ba_edge_terms``, the matchers') are tallied into the graph
(``_kernels.tally_launches``) instead of ``_kernels.LAUNCHES``, and each
replay adds the tally, so the launch counts keep meaning kernels run.

Spans: the caller's outer span (``mast3r.encode`` / ``mono`` / ``asym`` /
``sym``, ``fg.add_factors``) gets the attribute ``graph`` = ``eager`` /
``capture`` / ``replay``, and a capture runs inside the span the caller
names (``mast3r.capture``, ``fg.capture``, ``ba.capture``; attribute
``batch``). A replayed call runs none of the eager call's Python, so it has
none of its inner spans.
"""

from __future__ import annotations

import threading
import weakref
from typing import NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..ops import _kernels
from ..utils import timing


class Graph(NamedTuple):
    """One captured call: the graph, its static inputs and flattened
    outputs, the outputs' structure, and the hand kernels' launches a
    replay runs."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: list
    spec: object
    launches: dict

    def replay(self):
        """Enqueue the graph on the current stream and count its
        launches."""
        self.graph.replay()
        _kernels.add_launches(self.launches)


class _Stream:
    """What the graphs of one (device, stream) share: the memory pool, the
    lock around their enqueues and captures, and the side stream that
    captures run on.

    A pool whose graphs have all died refuses a new capture, and an
    owner's graphs die with it. So the pool is opened by a graph of one
    fill, never replayed, that lives as long as the process; a dead graph's
    memory stays in the pool for the next captures."""

    def __init__(self, device):
        self.lock = threading.Lock()
        self.side = torch.cuda.Stream(device=device)
        self.keeper = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.side):
            self.keeper.capture_begin(capture_error_mode="thread_local")
            try:
                torch.zeros(1, device=device)
            finally:
                self.keeper.capture_end()
        self.pool = self.keeper.pool()


_lock = threading.Lock()         # guards the three maps below
_owners = weakref.WeakKeyDictionary()   # owner -> {key: None | Graph}
_arenas = weakref.WeakKeyDictionary()   # owner -> {key: [tensor]}
_streams: dict = {}              # (device index, stream id) -> _Stream

SEEN = None                      # a key's state after its eager call
_prepared = threading.local()    # .devices: where this thread has handles


def eager(t) -> bool:
    """True where a call on tensor ``t`` runs eagerly: CPU, or grad on."""
    return t.device.type != "cuda" or torch.is_grad_enabled()


def entries(owner) -> dict:
    """The keys that ``owner`` has been called with on CUDA, each with
    None (seen once, eagerly) or its ``Graph``."""
    with _lock:
        return dict(_owners.get(owner, {}))


def drop(owner):
    """Forget ``owner``'s keys, graphs and shared inputs (say, when the
    tensors its graphs write are replaced): its next calls start over."""
    with _lock:
        _owners.pop(owner, None)
        _arenas.pop(owner, None)


def run(owner, key, fn, args, span=None, capture_span="mast3r.capture",
        share_inputs=False):
    """``fn(*args)`` for inference, through the CUDA graph of ``key`` under
    ``owner`` where the rules of this module give one. ``args`` are
    tensors, ``key`` is hashable and names everything ``fn`` bakes in;
    ``span``, the caller's span, gets the attribute ``graph``; a capture
    runs inside the span ``capture_span``; ``share_inputs``: the key's
    graphs take their static inputs from one set of tensors (the module's
    docstring). Returns what ``fn`` returns; where a graph ran, in fresh
    tensors."""
    dev = args[0].device
    first = True
    if not eager(args[0]):
        stream = torch.cuda.current_stream(dev)
        full = (key, dev.index, stream.stream_id,
                tuple((tuple(a.shape), a.dtype) for a in args))
        with _lock:
            keys = _owners.setdefault(owner, {})
            first = full not in keys
            if first:
                keys[full] = SEEN
    if first:
        _mark(span, "eager")
        return fn(*args)
    shared = _shared(dev, stream)
    with shared.lock:
        g = keys[full]
        if g is SEEN:
            _mark(span, "capture")
            with timing.span(capture_span, batch=args[0].shape[0]):
                inputs = (_arena_views(owner, (key, full[1:3]), keys, args)
                          if share_inputs else
                          [torch.empty_like(a, memory_format=torch.
                                            contiguous_format) for a in args])
                g = keys[full] = _capture(lambda: fn(*inputs), inputs,
                                          shared, stream)
        else:
            _mark(span, "replay")
        for static, a in zip(g.inputs, args):
            static.copy_(a)
        g.replay()
        return tree_unflatten([t.clone() for t in g.outputs], g.spec)


def capture(fn, device, capture_span) -> Graph:
    """``fn()`` captured into the pool of ``device``'s current stream,
    inside the span ``capture_span``: a graph with no inputs of its own
    (it reads and writes the tensors ``fn`` holds), for the caller to
    ``replay`` on that stream and drop when done. ``fn`` is never run
    eagerly: before a thread's first capture on ``device``, ``_prepare``
    makes what the capture cannot."""
    stream = torch.cuda.current_stream(device)
    shared = _shared(device, stream)
    with shared.lock, timing.span(capture_span):
        _prepare(device, shared.side)
        return _capture(fn, [], shared, stream)


def _prepare(device, side):
    """Once per thread and device: the thread's cuBLAS and cuSOLVER
    handles, made by a matrix product, a batched one, a Cholesky
    factorization and its solve on ``side``, the capture's stream. Without
    them a thread's first capture of a solve is invalidated. The hand
    kernels need nothing here: a kernel's module loads at its first
    launch, inside a capture too."""
    made = getattr(_prepared, "devices", set())
    if device.index in made:
        return
    with torch.cuda.stream(side):
        a = torch.eye(2, device=device)
        L, _ = torch.linalg.cholesky_ex(a)
        torch.cholesky_solve(a @ a, L)
        torch.bmm(a[None], a[None])
    _prepared.devices = made | {device.index}


def _mark(span, mode):
    if span is not None:
        span.set("graph", mode)


def _shared(dev, stream):
    key = (dev.index, stream.stream_id)
    with _lock:
        shared = _streams.get(key)
        if shared is None:
            shared = _streams[key] = _Stream(dev)
    return shared


def _arena_views(owner, key, keys, args):
    """Static inputs for ``args`` as the leading rows of the owner's
    tensors for ``key``; where one is too small or of another kind, all
    are made anew at ``args``' sizes and every graph that read the old
    ones is dropped (``keys[k]`` back to ``SEEN``: it captures on its next
    call)."""
    with _lock:
        arenas = _arenas.setdefault(owner, {})
        held = arenas.get(key)
    fits = held is not None and all(
        t.dtype == a.dtype and t.shape[1:] == a.shape[1:]
        and (a.dim() == 0 or t.shape[0] >= a.shape[0])
        for t, a in zip(held, args))
    if not fits:
        # the old tensors and their graphs go first, then the new tensors
        # take their memory (replays still queued ran before, in stream
        # order)
        with _lock:
            arenas.pop(key, None)
            for k, g in keys.items():
                if g is not SEEN and (k[0], k[1:3]) == key:
                    keys[k] = SEEN
        del held
        held = [torch.empty_like(a, memory_format=torch.contiguous_format)
                for a in args]
        with _lock:
            arenas[key] = held
    return [t if a.dim() == 0 else t[:a.shape[0]]
            for t, a in zip(held, args)]


def _capture(fn, inputs, shared, stream):
    """Capture ``fn()`` on ``shared``'s side stream into its pool."""
    graph = torch.cuda.CUDAGraph()
    side = shared.side
    side.wait_stream(stream)
    with torch.cuda.stream(side), _kernels.tally_launches() as launches:
        graph.capture_begin(pool=shared.pool,
                            capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    stream.wait_stream(side)
    outputs, spec = tree_flatten(out)
    return Graph(graph, inputs, outputs, spec,
                 {k: n for k, n in launches.items() if n})
