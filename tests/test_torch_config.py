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


@pytest.mark.parametrize("block", [
    {}, {"nfeat": 123, "ma_build": 2, "ma_query": 7, "alpha": 2.0,
         "similarity_threshold": 0.125}])
def test_retrieval_config_equals_jax(block):
    """``make_retrieval_config``: the ``retrieval`` block reaches the ASMK
    scoring settings; absent keys keep the defaults (nfeat 300, multiple
    assignment 1 / 5, alpha 3, threshold 0)."""
    from mast3r_slam_tpu.slam import retrieval as jretrieval

    cfg = tconfig.base_config()
    cfg["retrieval"] = dict(cfg["retrieval"], **block)
    jr, tr = jconfig.make_retrieval_config(cfg), tconfig.make_retrieval_config(cfg)
    assert jr._fields == tr._fields and tuple(jr) == tuple(tr)
    assert tconfig.RetrievalConfig() == tuple(jretrieval.RetrievalConfig())
    if block:
        assert (tr.nfeat, tr.ma_build, tr.ma_query) == (123, 2, 7)
        assert tr.alpha == 2.0 and tr.similarity_threshold == 0.125
    else:
        assert tr == tconfig.RetrievalConfig()
    assert (cfg["retrieval"]["k"], cfg["retrieval"]["min_thresh"]) == (3, 5e-3)


def test_reloc_block_and_system_wiring():
    """The ``reloc`` block as ``SLAMSystem`` reads it: ``min_match_frac``
    and ``strict`` from the preset, ``reinit_after`` 0 unless set; the
    retrieval settings reach the database."""
    from mast3r_slam_tpu_torch.models import mast3r as tmast3r
    from mast3r_slam_tpu_torch.slam import retrieval as tretrieval
    from mast3r_slam_tpu_torch.slam.system import SLAMSystem

    cfg = tconfig.tpu_fast_config()
    assert tconfig.make_reloc_config(cfg) == (0.3, True, 0)
    cfg["reloc"] = dict(cfg["reloc"], reinit_after=3, strict=False)
    assert tconfig.make_reloc_config(cfg) == tconfig.RelocConfig(0.3, False, 3)
    cfg["retrieval"] = dict(cfg["retrieval"], nfeat=17)
    cfg["runtime"]["tracking_window"] = 1
    mcfg = tmast3r.MASt3RConfig(img_size=(64, 96), enc_embed_dim=64,
                                desc_dim=8, dtype="float32")
    rparams = tretrieval.init_retrieval_params(
        torch.Generator().manual_seed(1), backbone_dim=64, proj_dim=32,
        codebook_size=64, device="cpu")
    system = SLAMSystem(None, mcfg, cfg, mcfg.img_size,
                        retrieval_params=rparams, keyframe_capacity=4,
                        edge_capacity=8, device="cpu")
    assert system.reinit_after == 3
    assert system.retrieval.cfg == tconfig.make_retrieval_config(cfg)
    assert system.retrieval.cfg.nfeat == 17
    assert system.factor_graph.cfg.matcher == "dense"
    assert system.factor_graph.query_stride == 4
