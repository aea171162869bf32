"""Configs: YAML loading with ``inherit:`` chaining, built-in presets, and
the typed tracker/matcher configs.

Counterpart of ``mast3r_slam_tpu/config.py``. The port keeps its own
``TrackerConfig``, ``MatchingConfig``, ``BAConfig``,
``FactorGraphConfig`` and ``RetrievalConfig`` (same fields and defaults as
``mast3r_slam_tpu/slam/tracker.py:31``,
``mast3r_slam_tpu/slam/factor_graph.py:261``,
``mast3r_slam_tpu/slam/ba.py:40``,
``mast3r_slam_tpu/slam/factor_graph.py:29`` and
``mast3r_slam_tpu/slam/retrieval.py:31``). ``yaml`` is imported inside
``load_config`` only: ``base_config()`` and ``tpu_fast_config()`` give the
two presets as Python dicts, so a machine without PyYAML runs the port.
"""

from __future__ import annotations

import copy
import pathlib
import re
from typing import NamedTuple

_FLOAT_RE = re.compile(
    """^(?:
        [-+]?(?:[0-9][0-9_]*)\\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\\.[0-9_]*
        |[-+]?\\.(?:inf|Inf|INF)
        |\\.(?:nan|NaN|NAN))$""",
    re.X,
)

_REPO_CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


class TrackerConfig(NamedTuple):
    """Tracking hyperparameters (the ``tracking`` block)."""

    max_iters: int = 50
    C_conf: float = 0.0
    Q_conf: float = 1.5
    rel_error: float = 1e-3
    delta_norm: float = 1e-3
    huber: float = 1.345
    min_match_frac: float = 0.05
    match_frac_thresh: float = 0.333
    kf_every: int = 0   # > 0: a keyframe every N frames (fixed cadence)
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    pixel_border: int = -10
    depth_eps: float = 1e-6


class MatchingConfig(NamedTuple):
    """Matcher hyperparameters (the ``matching`` block)."""

    max_iter: int = 10
    lambda_init: float = 1e-8
    convergence_thresh: float = 1e-6
    dist_thresh: float = 0.1
    radius: int = 3
    dilation_max: int = 5
    subpixel: bool = False
    coarse_iter: int = 0
    separable_refine: bool = False
    refine_dtype: str = "bfloat16"


class BAConfig(NamedTuple):
    """Global-optimization hyperparameters (the ``local_opt`` block)."""

    pin: int = 1
    max_iters: int = 10
    C_conf: float = 0.0
    Q_conf: float = 1.5
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    sigma_point: float = 0.05
    delta_norm: float = 1e-8
    pixel_border: int = -10
    depth_eps: float = 1e-6
    point_chunk: int = 8192   # the JAX scan's chunk; parsed, unused here
    solver: str = "fp32"      # "fp32": equilibrated Cholesky on the device;
                              # "fp64_host": fp64 Cholesky on the host
    point_stride: int = 1     # use every s-th measurement pixel per edge


class FactorGraphConfig(NamedTuple):
    """Edge-buffer and gating settings. ``edge_bucket_floor``,
    ``kf_bucket_floor`` and ``pad_edge_batch`` bound the JAX package's
    compiled shapes; they are parsed for parity and unused here."""

    edge_capacity: int = 256    # initial buffer size; doubles on demand
    max_edge_capacity: int = 0  # hard cap (0 = unbounded); beyond it new
                                # edges are dropped and counted
    edge_bucket_floor: int = 8
    kf_bucket_floor: int = 8
    pad_edge_batch: bool = True
    Q_conf: float = 1.5
    min_match_frac: float = 0.1
    matcher: str = "iter_proj"  # or "dense" (ops/dense_matcher.py)
    ba_backend: str = "dense"   # "edge_sharded" / "schur": sharded over
    #                             a mesh of several devices, else dense


class RetrievalConfig(NamedTuple):
    """ASMK scoring settings (the ``retrieval`` block, beside the query-time
    ``k`` / ``min_thresh`` the system reads directly)."""

    nfeat: int = 300
    ma_build: int = 1
    ma_query: int = 5
    alpha: float = 3.0
    similarity_threshold: float = 0.0


class RelocConfig(NamedTuple):
    """Relocalization settings (the ``reloc`` block). ``reinit_after`` > 0:
    after that many failed attempts in a row, tracking restarts from the
    current frame as a fresh keyframe; 0 keeps relocalizing forever."""

    min_match_frac: float = 0.3
    strict: bool = True
    reinit_after: int = 0


def _yaml_loader():
    import yaml

    class _Loader(yaml.SafeLoader):
        """SafeLoader that reads ``1e-8`` as a float (YAML 1.1 wants a dot)."""

    _Loader.add_implicit_resolver(
        "tag:yaml.org,2002:float", _FLOAT_RE, list("-+0123456789."))
    return _Loader


def _merge(parent: dict, child: dict) -> dict:
    out = copy.deepcopy(parent)
    for k, v in child.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _resolve(path) -> pathlib.Path:
    """As given (cwd or absolute), else the repo preset of the same name."""
    p = pathlib.Path(path)
    if p.exists():
        return p
    preset = _REPO_CONFIGS / p.name
    return preset if preset.exists() else p


def load_config(path) -> dict:
    """Load a YAML config, following ``inherit:`` parent chains."""
    import yaml

    path = _resolve(path)
    with open(path, "r") as f:
        cfg = yaml.load(f, Loader=_yaml_loader()) or {}
    inherit = cfg.pop("inherit", None)
    if inherit is not None:
        parent_path = pathlib.Path(inherit)
        if not parent_path.is_absolute() and not parent_path.exists():
            parent_path = path.parent / parent_path.name
        cfg = _merge(load_config(parent_path), cfg)
    return cfg


def default_config() -> dict:
    """The repo's ``configs/base.yaml``, loaded (``config.py:81``)."""
    return load_config(_REPO_CONFIGS / "base.yaml")


def base_config() -> dict:
    """``configs/base.yaml`` as parsed (reference-parity settings)."""
    return {
        "use_calib": False,
        "single_thread": False,
        "dataset": {"subsample": 1, "img_downsample": 1,
                    "center_principle_point": True},
        "matching": {"max_iter": 10, "lambda_init": 1e-08,
                     "convergence_thresh": 1e-06, "dist_thresh": 0.1,
                     "radius": 3, "dilation_max": 5},
        "tracking": {"min_match_frac": 0.05, "max_iters": 50, "C_conf": 0.0,
                     "Q_conf": 1.5, "rel_error": 0.001, "delta_norm": 0.001,
                     "huber": 1.345, "match_frac_thresh": 0.333,
                     "sigma_ray": 0.003, "sigma_dist": 10.0,
                     "sigma_pixel": 1.0, "sigma_depth": 10.0,
                     "sigma_point": 0.05, "pixel_border": -10,
                     "depth_eps": 1e-06,
                     "filtering_mode": "weighted_pointmap",
                     "filtering_score": "median"},
        "local_opt": {"matcher": "iter_proj", "pin": 1,
                      "window_size": 1000000.0, "C_conf": 0.0, "Q_conf": 1.5,
                      "min_match_frac": 0.1, "pixel_border": -10,
                      "depth_eps": 1e-06, "max_iters": 10, "sigma_ray": 0.003,
                      "sigma_dist": 10.0, "sigma_pixel": 1.0,
                      "sigma_depth": 10.0, "sigma_point": 0.05,
                      "delta_norm": 1e-08},
        "retrieval": {"k": 3, "min_thresh": 0.005},
        "reloc": {"min_match_frac": 0.3, "strict": True},
        "runtime": {"keyframe_capacity": 256, "edge_capacity": 256,
                    "point_chunk": 8192, "model_dtype": "bfloat16",
                    "backend_device": "none"},
    }


def tpu_fast_config() -> dict:
    """``configs/tpu_fast.yaml`` as parsed (inherits ``base.yaml``): the
    throughput matcher preset (radius 1, dilation 1, ``max_iter`` 0,
    ``coarse_iter`` 3) and a bf16 head."""
    return _merge(base_config(), {
        "single_thread": True,
        "matching": {"dilation_max": 1, "max_iter": 0, "coarse_iter": 3,
                     "radius": 1, "subpixel": False},
        "local_opt": {"matcher": "dense", "reuse_consec_edge": True,
                      "point_stride": 4},
        "runtime": {"model_dtype": "bfloat16", "head_dtype": "bfloat16",
                    "tracking_window": 8},
    })


def make_tracker_config(cfg: dict) -> TrackerConfig:
    t = cfg["tracking"]
    return TrackerConfig(
        max_iters=int(t["max_iters"]), C_conf=float(t["C_conf"]),
        Q_conf=float(t["Q_conf"]), rel_error=float(t["rel_error"]),
        delta_norm=float(t["delta_norm"]), huber=float(t["huber"]),
        min_match_frac=float(t["min_match_frac"]),
        match_frac_thresh=float(t["match_frac_thresh"]),
        kf_every=int(t.get("kf_every", 0)),
        sigma_ray=float(t["sigma_ray"]), sigma_dist=float(t["sigma_dist"]),
        sigma_pixel=float(t["sigma_pixel"]), sigma_depth=float(t["sigma_depth"]),
        pixel_border=int(t["pixel_border"]), depth_eps=float(t["depth_eps"]),
    )


def make_matching_config(cfg: dict) -> MatchingConfig:
    m = cfg["matching"]
    return MatchingConfig(
        max_iter=int(m["max_iter"]), lambda_init=float(m["lambda_init"]),
        convergence_thresh=float(m["convergence_thresh"]),
        dist_thresh=float(m["dist_thresh"]), radius=int(m["radius"]),
        dilation_max=int(m["dilation_max"]),
        subpixel=bool(m.get("subpixel", False)),
        coarse_iter=int(m.get("coarse_iter", 0)),
        separable_refine=bool(m.get("separable_refine", False)),
        refine_dtype=str(m.get("refine_dtype", "bfloat16")),
    )


def make_ba_config(cfg: dict, point_chunk: int = 8192) -> BAConfig:
    o = cfg["local_opt"]
    return BAConfig(
        pin=int(o["pin"]), max_iters=int(o["max_iters"]),
        C_conf=float(o["C_conf"]), Q_conf=float(o["Q_conf"]),
        sigma_ray=float(o["sigma_ray"]), sigma_dist=float(o["sigma_dist"]),
        sigma_pixel=float(o["sigma_pixel"]), sigma_depth=float(o["sigma_depth"]),
        delta_norm=float(o["delta_norm"]), pixel_border=int(o["pixel_border"]),
        depth_eps=float(o["depth_eps"]), point_chunk=point_chunk,
        solver=str(o.get("solver", "fp32")),
        point_stride=int(o.get("point_stride", 1)),
    )


def make_factor_graph_config(cfg: dict, edge_capacity: int = 256
                             ) -> FactorGraphConfig:
    o = cfg["local_opt"]
    rt = cfg.get("runtime", {})
    return FactorGraphConfig(
        edge_capacity=edge_capacity,
        max_edge_capacity=int(rt.get("max_edge_capacity", 0)),
        edge_bucket_floor=int(rt.get("edge_bucket_floor", 8)),
        kf_bucket_floor=int(rt.get("kf_bucket_floor", 8)),
        pad_edge_batch=bool(rt.get("pad_edge_batch", True)),
        Q_conf=float(o["Q_conf"]),
        min_match_frac=float(o["min_match_frac"]),
        matcher=str(o.get("matcher", "iter_proj")),
        ba_backend=str(cfg.get("parallel", {}).get("ba_backend", "dense")),
    )


def make_retrieval_config(cfg: dict) -> RetrievalConfig:
    r = cfg.get("retrieval", {})
    d = RetrievalConfig()
    return RetrievalConfig(
        nfeat=int(r.get("nfeat", d.nfeat)),
        ma_build=int(r.get("ma_build", d.ma_build)),
        ma_query=int(r.get("ma_query", d.ma_query)),
        alpha=float(r.get("alpha", d.alpha)),
        similarity_threshold=float(r.get("similarity_threshold",
                                         d.similarity_threshold)),
    )


def make_reloc_config(cfg: dict) -> RelocConfig:
    r = cfg.get("reloc", {})
    d = RelocConfig()
    return RelocConfig(
        min_match_frac=float(r.get("min_match_frac", d.min_match_frac)),
        strict=bool(r.get("strict", d.strict)),
        reinit_after=int(r.get("reinit_after", d.reinit_after)),
    )
