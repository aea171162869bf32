"""``net_graph_share.scan`` on synthetic spans of the program: the share
of the main thread's outer network spans begun in the traced part that
replayed a graph; other threads, inner spans and spans begun before the
traced part do not count; a program whose spans carry no ``graph``
attribute gives nothing."""

import math
import threading
import time

from gpubench import harness
from mast3r_slam_tpu_torch.utils import timing


class Ctx:
    def __init__(self, trace_t0, window_s):
        self.trace_t0 = trace_t0
        self.window_s = window_s
        self.t1 = None if trace_t0 is None else trace_t0 + window_s


def _call(name, mode=None, inner=()):
    with timing.span(name) as sp:
        if mode is not None:
            sp.set("graph", mode)
        for n in inner:
            with timing.span(n) as isp:
                isp.set("graph", "replay")


def _read(ctx):
    return harness.load_reader("net_graph_share.scan")(ctx)


def test_share_of_replayed_outer_spans():
    with timing.recording():
        _call("mast3r.encode", "eager")          # before the traced part
        time.sleep(0.002)
        t0 = time.perf_counter()
        _call("mast3r.encode", "replay", inner=("mast3r.capture",))
        _call("mast3r.asym", "capture", inner=("mast3r.capture",))
        _call("mast3r.sym", "replay", inner=("mast3r.decoder",))
        _call("mast3r.mono", "replay")
        _call("backend.step", "replay")          # not a network call
        other = threading.Thread(target=_call, args=("mast3r.sym", "eager"))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        ctx = Ctx(t0, time.perf_counter() - t0 + 1.0)
    assert math.isclose(_read(ctx), 75.0)


def test_nothing_without_the_attribute():
    with timing.recording():
        t0 = time.perf_counter()
        _call("mast3r.encode")
        _call("mast3r.asym")
        ctx = Ctx(t0, time.perf_counter() - t0 + 1.0)
    assert _read(ctx) is None
    assert _read(Ctx(None, 1.0)) is None


def test_all_eager_reads_zero():
    with timing.recording():
        t0 = time.perf_counter()
        _call("mast3r.encode", "eager")
        _call("mast3r.sym", "eager")
        ctx = Ctx(t0, time.perf_counter() - t0 + 1.0)
    assert _read(ctx) == 0.0
