"""Port gathers == the JAX package's: ``gather_rows`` against ``jnp.take``
and ``take_along`` against ``jnp.take_along_axis``, and both against the
XLA baseline of the Pallas gather probes on the probes' own shapes
(``scripts/probe_pallas_gather.py``; the Pallas variants themselves need a
TPU, ``baseline_xla`` is the function they are checked against there).
Copies of fp32 values: exactly equal."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu_torch.ops import gather

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_gather", REPO / "scripts" / "probe_pallas_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("R,C,N", [(4096, 256, 1024), (8 * 768, 4, 3000),
                                   (50, 7, 33)])
def test_gather_rows_equals_jnp_take(R, C, N):
    rng = np.random.default_rng(R + C)
    table = rng.standard_normal((R, C)).astype(np.float32)
    idx = rng.integers(0, R, N).astype(np.int32)
    ref = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    for fn in (gather.gather_rows, gather.gather_rows_plain):
        np.testing.assert_array_equal(fn(_t(table), _t(idx)).numpy(), ref)


def test_gather_rows_equals_probe_baseline(probe):
    """Variants A and B of the probe compute ``baseline_xla`` on a
    (4096, 256) table and 1024 indices."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((probe.R, probe.C)).astype(np.float32)
    idx = rng.integers(0, probe.R, probe.N).astype(np.int32)
    ref = np.asarray(probe.baseline_xla(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(
        gather.gather_rows(_t(table), _t(idx)).numpy(), ref)


@pytest.mark.parametrize("axis,tshape,ishape", [
    (0, (1024, 128), (1024, 128)), (0, (40, 9), (17, 9)),
    (1, (4, 768), (4, 768)), (1, (3, 50), (3, 21))])
def test_take_along_equals_jnp(axis, tshape, ishape):
    rng = np.random.default_rng(axis + tshape[0])
    t = rng.standard_normal(tshape).astype(np.float32)
    idx = rng.integers(0, tshape[axis], ishape).astype(np.int32)
    ref = np.asarray(jnp.take_along_axis(jnp.asarray(t), jnp.asarray(idx),
                                         axis=axis))
    for fn in (gather.take_along, gather.take_along_plain):
        np.testing.assert_array_equal(fn(_t(t), _t(idx), axis).numpy(), ref)


@pytest.mark.parametrize("axis,tshape,ishape", [
    (1, (2, 768), (2, 768)), (1, (1, 50), (1, 21)), (0, (40, 9), (17, 9))])
def test_take_along_pair_equals_two_jnp_calls(axis, tshape, ishape):
    """The edge gate's two directions (``factor_graph._gate_edges``) in one
    call: two ``take_along_axis`` problems of one shape."""
    rng = np.random.default_rng(7 + axis)
    ts = [rng.standard_normal(tshape).astype(np.float32) for _ in range(2)]
    idx = [rng.integers(0, tshape[axis], ishape).astype(np.int32)
           for _ in range(2)]
    refs = [np.asarray(jnp.take_along_axis(jnp.asarray(t), jnp.asarray(i),
                                           axis=axis))
            for t, i in zip(ts, idx)]
    args = (_t(ts[0]), _t(idx[0]), _t(ts[1]), _t(idx[1]), axis)
    for fn in (gather.take_along_pair, gather.take_along_pair_plain):
        outs = fn(*args)
        assert len(outs) == 2
        for got, ref in zip(outs, refs):
            np.testing.assert_array_equal(got.numpy(), ref)


def test_take_along_equals_probe_variant_c_function(probe):
    """Variant C: take_along_axis(table[:N, :128], idx broadcast over 128
    columns, axis=0), i.e. the baseline's rows cut to 128 columns."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((probe.R, probe.C)).astype(np.float32)
    idx = rng.integers(0, probe.N, probe.N).astype(np.int32)
    idx2d = np.ascontiguousarray(np.broadcast_to(idx[:, None],
                                                 (probe.N, 128)))
    ref = np.asarray(probe.baseline_xla(jnp.asarray(table[:probe.N, :128]),
                                        jnp.asarray(idx)))
    got = gather.take_along(_t(np.ascontiguousarray(table[:probe.N, :128])),
                            _t(idx2d), 0)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kernel_library_is_stale_per_source(tmp_path, monkeypatch):
    """A kernel's library is rebuilt when its own source or a shared header
    is newer than it, not when another kernel's source changed."""
    import os

    from mast3r_slam_tpu_torch.ops import _kernels

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    monkeypatch.setattr(_kernels, "BUILD_DIR", build)
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (csrc / name).write_text("")
    assert _kernels._stale("a")                    # never built

    def stamp(path, t):
        os.utime(path, (t, t))

    for f in csrc.iterdir():
        stamp(f, 1000)
    for name in ("a", "b"):
        (build / f"lib{name}.so").write_text("")
        stamp(build / f"lib{name}.so", 2000)
    assert not _kernels._stale("a") and not _kernels._stale("b")
    stamp(csrc / "b.cu", 3000)                     # another kernel's source
    assert not _kernels._stale("a") and _kernels._stale("b")
    stamp(csrc / "shared.cuh", 3000)               # a shared header
    assert _kernels._stale("a")
