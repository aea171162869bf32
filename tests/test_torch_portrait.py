"""Portrait input and ``dataset.img_downsample`` through the port's whole
SLAM pipeline (frontend and backend, the oracle predictor, 8 frames),
against the JAX package: the counterparts of ``tests/test_portrait.py:34``
and ``tests/test_downsample.py:10``.

Each package runs its own oracle (the port's from the JAX oracle's
parameters). Held to the slice tolerances of ``tests/test_torch_slice.py``:
every stat, the keyframe ids and the edge count equal, keyframe poses
within 5e-4. The cases:

* portrait (96, 64) with ``default_config()``: 8 keyframes, 14 edges;
* ``img_downsample: 2`` at (64, 96) with ``default_config()`` and with
  ``configs/tpu_fast.yaml`` (frame by frame): the store at (32, 48);
* ``img_downsample: 2`` with ``configs/base.yaml`` at (96, 64): both
  packages skip frame 1 and keep the one keyframe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import config as jconfig
from mast3r_slam_tpu.lie import sim3 as jsim3
from mast3r_slam_tpu.models import mast3r as jmast3r
from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu.slam.system import SLAMSystem as JSystem
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import mast3r as tmast3r
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem

torch.set_num_threads(1)

N_FRAMES = 8
POSE_TOL = 5e-4


def _traj(n):
    """``tests/test_portrait.py::_gt_trajectory``."""
    Ts = [jsim3.identity()]
    for i in range(1, n):
        xi = jnp.array([0.18, 0.04 * np.sin(i / 3), 0.04,
                        0.0, 0.06, 0.008, 0.0])
        Ts.append(jsim3.mul(Ts[-1], jsim3.exp(xi)))
    return jnp.stack(Ts)


def _cfg(mod, preset, ds):
    cfg = (mod.default_config() if preset == "default"
           else mod.load_config(f"configs/{preset}.yaml"))
    cfg["tracking"] = dict(cfg["tracking"], match_frac_thresh=0.95)
    cfg["dataset"] = dict(cfg["dataset"], img_downsample=ds)
    cfg["runtime"] = dict(cfg.get("runtime", {}), tracking_window=1)
    cfg["single_thread"] = True
    return cfg


def _drive(system, h, w):
    for i in range(N_FRAMES):
        system.process_frame(system.make_frame(
            i, joracle.make_frame_image(i, h, w)
            if isinstance(system, JSystem)
            else toracle.make_frame_image(i, h, w)))
        while system.backend_step():
            pass
    system.factor_graph.flush()


@pytest.mark.parametrize("size,preset,ds,expect", [
    ((96, 64), "default", 1, {"keyframes": 8, "edges": 14}),
    ((64, 96), "default", 2, {}),
    ((64, 96), "tpu_fast", 2, {}),
    ((96, 64), "base", 2, {"keyframes": 1, "skipped_frame": 1}),
], ids=["portrait", "downsample", "downsample_tpu_fast",
        "downsample_base_portrait"])
def test_pipeline_matches_jax(size, preset, ds, expect):
    h, w = size
    kw = dict(img_size=size, enc_embed_dim=64, desc_dim=8, dtype="float32")
    jp = joracle.make_params(_traj(N_FRAMES), desc_dim=8)
    tp = convert.oracle_params_from_jax(jax.device_get(jp), device="cpu")
    sj = JSystem(jp, jmast3r.MASt3RConfig(**kw), _cfg(jconfig, preset, ds),
                 size, keyframe_capacity=16, edge_capacity=64,
                 model_module=joracle)
    st = TSystem(tp, tmast3r.MASt3RConfig(**kw), _cfg(tconfig, preset, ds),
                 size, keyframe_capacity=16, edge_capacity=64,
                 model_module=toracle, device="cpu")
    _drive(sj, h, w)
    _drive(st, h, w)

    assert st.stats == sj.stats and st.mode.name == sj.mode.name
    k = len(st.keyframes)
    assert k == len(sj.keyframes)
    assert st.factor_graph.n_edges == sj.factor_graph.n_edges
    kfs = st.keyframes
    assert kfs.X.shape[1] == (h // ds) * (w // ds)
    assert kfs.uimg.shape[1:] == (h // ds, w // ds, 3)
    np.testing.assert_array_equal(kfs.dataset_idx[:k].numpy(),
                                  np.asarray(sj.keyframes.dataset_idx[:k]))
    np.testing.assert_allclose(kfs.T_WC[:k].numpy(),
                               np.asarray(sj.keyframes.T_WC[:k]),
                               atol=POSE_TOL, rtol=0)
    assert np.all(np.isfinite(kfs.T_WC[:k].numpy()))
    if "keyframes" in expect:
        assert k == expect["keyframes"]
    if "edges" in expect:
        assert st.factor_graph.n_edges == expect["edges"]
    if "skipped_frame" in expect:
        assert st.stats["skipped"] >= 1 and st.current_frame.frame_id > 0
    else:
        assert st.stats["skipped"] == 0 and k >= 3
