"""CUDA graphs of the network's inference passes, one a call shape.

``mast3r.encode`` and ``mast3r.decode_pair`` (both decoders and both DPT
heads) run through ``run``. Eagerly, one call of either enqueues some
thousands of kernels one by one, and the device waits for the host while
it does; a CUDA graph of the call replays them all in one launch. The
graph replays the kernels that the eager call launches, at the same dtypes:
nothing is dropped, fused or lowered.

Which path a call takes is decided from what the call shows:

- **Eager**: CPU tensors, or grad enabled.
- **Key**: the kind of call, the device, the current stream, the
  configuration, and each input's shape and dtype. Each module has its own
  keys: they are held beside it in a weak map, so its graphs die with it
  and a copy of the module starts with none.
- **Lifecycle of a key**: the first call runs eagerly and returns its own
  result; it is also the warm-up that capture needs (cuBLAS handles, cuDNN
  plans, the hand kernels' libraries). The second call captures, then
  replays. Every later call replays.

A call with a graph copies its inputs into the graph's static input
tensors (allocated outside the graph pool), replays, and returns clones of
the static outputs, so no caller ever holds a buffer that the next replay
overwrites (the CLI keeps decoded maps in its keyframes). The copy-in, the
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

The graph reads the module's weights where they lay at capture: change
them in place (``load_state_dict`` copies in place), not by assigning new
tensors to the parameters.

The hand kernels launched while a graph is captured (``rope_qk``) are
tallied into the graph (``_kernels.tally_launches``) instead of
``_kernels.LAUNCHES``, and each replay adds the tally, so the launch counts
keep meaning kernels run.

Spans: the caller's outer span (``mast3r.encode`` / ``mono`` / ``asym`` /
``sym``) gets the attribute ``graph`` = ``eager`` / ``capture`` /
``replay``, and a capture runs inside the span ``mast3r.capture``
(attribute ``batch``). A replayed call runs no Python of the network, so it
has none of the eager call's inner spans.
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


class _Stream:
    """What the graphs of one (device, stream) share: the memory pool, the
    lock around their enqueues and captures, and the side stream that
    captures run on.

    A pool whose graphs have all died refuses a new capture, and a module's
    graphs die with it. So the pool is opened by a graph of one fill, never
    replayed, that lives as long as the process; a dead graph's memory
    stays in the pool for the next captures."""

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


_lock = threading.Lock()         # guards the two maps below
_modules = weakref.WeakKeyDictionary()   # module -> {key: None | Graph}
_streams: dict = {}              # (device index, stream id) -> _Stream

SEEN = None                      # a key's state after its eager call


def entries(model) -> dict:
    """The keys that ``model`` has been called with on CUDA, each with
    None (seen once, eagerly) or its ``Graph``."""
    with _lock:
        return dict(_modules.get(model, {}))


def run(model, kind, body, args, cfg, span=None):
    """``body(model, *args, cfg)`` for inference, through the CUDA graph
    of its key where the rules of this module give one. ``args`` are
    tensors; ``span``, the caller's span, gets the attribute ``graph``.
    Returns what ``body`` returns; where a graph ran, in fresh tensors."""
    dev = args[0].device
    first = True
    if dev.type == "cuda" and not torch.is_grad_enabled():
        stream = torch.cuda.current_stream(dev)
        key = (kind, dev.index, stream.stream_id, cfg,
               tuple((tuple(a.shape), a.dtype) for a in args))
        with _lock:
            keys = _modules.setdefault(model, {})
            first = key not in keys
            if first:
                keys[key] = SEEN
    if first:
        _mark(span, "eager")
        return body(model, *args, cfg)
    shared = _shared(dev, stream)
    with shared.lock:
        g = keys[key]
        if g is SEEN:
            _mark(span, "capture")
            with timing.span("mast3r.capture", batch=args[0].shape[0]):
                g = keys[key] = _capture(model, body, args, cfg, shared,
                                         stream)
        else:
            _mark(span, "replay")
        for static, a in zip(g.inputs, args):
            static.copy_(a)
        g.graph.replay()
        _kernels.add_launches(g.launches)
        return tree_unflatten([t.clone() for t in g.outputs], g.spec)


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


def _capture(model, body, args, cfg, shared, stream):
    """Capture ``body`` on ``shared``'s side stream into its pool; the
    static inputs are made on ``stream``, outside the pool."""
    inputs = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
              for a in args]
    graph = torch.cuda.CUDAGraph()
    side = shared.side
    side.wait_stream(stream)
    with torch.cuda.stream(side), _kernels.tally_launches() as launches:
        graph.capture_begin(pool=shared.pool,
                            capture_error_mode="thread_local")
        try:
            out = body(model, *inputs, cfg)
        finally:
            graph.capture_end()
    stream.wait_stream(side)
    outputs, spec = tree_flatten(out)
    return Graph(graph, inputs, outputs, spec,
                 {k: n for k, n in launches.items() if n})
