"""Port configs == the JAX package's parse of the same YAML presets."""

import pathlib

import pytest
import torch

from mast3r_slam_tpu import config as jconfig
from mast3r_slam_tpu_torch import config as tconfig

# the suite runs several test processes side by side on a few cores;
# one intra-op thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("preset,builtin", [
    ("base", tconfig.base_config),
    ("tpu_fast", tconfig.tpu_fast_config),
])
def test_builtin_presets_equal_jax_yaml_parse(preset, builtin):
    ref = jconfig.load_config(REPO / "configs" / f"{preset}.yaml")
    assert builtin() == ref
    # the port's own YAML loader agrees too
    assert tconfig.load_config(REPO / "configs" / f"{preset}.yaml") == ref


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "configs").glob("*.yaml")))
def test_every_yaml_parses_equal(name):
    assert (tconfig.load_config(REPO / "configs" / name)
            == jconfig.load_config(REPO / "configs" / name))


@pytest.mark.parametrize("builtin", [tconfig.base_config,
                                     tconfig.tpu_fast_config])
def test_typed_configs_equal_field_by_field(builtin):
    cfg = builtin()
    cfg["tracking"]["kf_every"] = 4
    jt, tt = jconfig.make_tracker_config(cfg), tconfig.make_tracker_config(cfg)
    jm, tm = jconfig.make_matching_config(cfg), tconfig.make_matching_config(cfg)
    assert jt._fields == tt._fields and tuple(jt) == tuple(tt)
    assert jm._fields == tm._fields and tuple(jm) == tuple(tm)


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "configs").glob("*.yaml")))
def test_backend_configs_equal_field_by_field(name):
    """``make_ba_config`` / ``make_factor_graph_config`` on every preset
    that has a ``local_opt`` block (``intrinsics.yaml`` has none)."""
    cfg = tconfig.load_config(REPO / "configs" / name)
    if "local_opt" not in cfg:
        with pytest.raises(KeyError):
            tconfig.make_ba_config(cfg)
        return
    jb = jconfig.make_ba_config(cfg, point_chunk=4096)
    tb = tconfig.make_ba_config(cfg, point_chunk=4096)
    jf = jconfig.make_factor_graph_config(cfg, 64)
    tf = tconfig.make_factor_graph_config(cfg, 64)
    assert jb._fields == tb._fields and tuple(jb) == tuple(tb)
    assert jf._fields == tf._fields and tuple(jf) == tuple(tf)


def test_backend_config_defaults_match():
    from mast3r_slam_tpu.slam.ba import BAConfig
    from mast3r_slam_tpu.slam.factor_graph import FactorGraphConfig

    assert BAConfig._fields == tconfig.BAConfig._fields
    assert tuple(BAConfig()) == tuple(tconfig.BAConfig())
    assert FactorGraphConfig._fields == tconfig.FactorGraphConfig._fields
    assert tuple(FactorGraphConfig()) == tuple(tconfig.FactorGraphConfig())


def test_typed_config_defaults_match():
    from mast3r_slam_tpu.slam.factor_graph import MatchingConfig
    from mast3r_slam_tpu.slam.tracker import TrackerConfig

    assert tuple(TrackerConfig()) == tuple(tconfig.TrackerConfig())
    assert tuple(MatchingConfig()) == tuple(tconfig.MatchingConfig())
    assert TrackerConfig._fields == tconfig.TrackerConfig._fields
    assert MatchingConfig._fields == tconfig.MatchingConfig._fields


def test_port_imports_without_jax():
    """Every module of the port imports in a Python where ``jax`` and the
    JAX package cannot be imported."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['mast3r_slam_tpu'] = None\n"
        "import importlib, pkgutil, mast3r_slam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
