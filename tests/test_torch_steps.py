"""The step-by-step tracker (``TrackerRunner._track_steps``, taken with
``tracker.fused = False``), as ``tests/test_system.py:178`` holds the JAX
package's: against the JAX step path on the JAX oracle's replayed outputs
(``tests/test_torch_slice.py``'s setting: every stat and keyframe id equal,
poses and keyframe maps within 1e-4, the frontend tolerance of that file),
and against the port's fused path (the same keyframes and stats, poses
within 1e-4 and maps within 1e-3, ``tests/test_system.py:207-214``'s
tolerances), in the uncalibrated (ray-distance) and the calibrated
(pixel + log-depth) mode. The step path leaves no consecutive-edge match
for the backend (``last_match`` None: the backend decodes the edge).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu import config as jconfig
from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu.slam.system import SLAMSystem as JSystem
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.models import oracle as toracle
from mast3r_slam_tpu_torch.slam.frame import Mode
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem
from test_torch_slice import (CFG_KW, JCFG, N_FRAMES, TCFG, _cfg, _compare,
                              _drive, _gt_trajectory, _replay_module)

torch.set_num_threads(1)

H, W = CFG_KW["img_size"]
F = 0.8 * W          # the oracle's pinhole (models/oracle.py::_intrinsics)
K = [[F, 0.0, W / 2.0], [0.0, F, H / 2.0], [0.0, 0.0, 1.0]]


@pytest.fixture(scope="module")
def jp():
    return joracle.make_params(_gt_trajectory(N_FRAMES),
                               desc_dim=CFG_KW["desc_dim"])


def _config(mod, calib):
    cfg = _cfg(mod, "base")
    cfg["use_calib"] = calib
    return cfg


def _port(jp, calib, fused):
    st = TSystem(None, TCFG, _config(tconfig, calib), (H, W),
                 K=K if calib else None, keyframe_capacity=16,
                 model_module=_replay_module(jp), device="cpu")
    st.tracker.fused = fused
    promoted = []
    track = st.tracker.track

    def spy(frame):
        out = track(frame)
        promoted.append(st.tracker.last_match is not None)
        return out

    st.tracker.track = spy
    poses = _drive(st, lambda i: toracle.make_frame_image(i, H, W), N_FRAMES)
    return st, poses, promoted


@pytest.mark.parametrize("calib", [False, True], ids=["rays", "calib"])
def test_step_path_matches_jax_step_path(jp, calib):
    sj = JSystem(jp, JCFG, _config(jconfig, calib), (H, W),
                 K=jnp.asarray(K) if calib else None, keyframe_capacity=16,
                 model_module=joracle)
    sj.tracker.fused = False
    pj = _drive(sj, lambda i: joracle.make_frame_image(i, H, W), N_FRAMES)
    st, pt, promoted = _port(jp, calib, fused=False)
    _compare(sj, pj, st, pt, pose_tol=1e-4, map_tol=1e-4)
    assert st.stats["keyframes"] >= 3
    assert not any(promoted)
    np.testing.assert_array_equal(st.keyframes.N[:len(st.keyframes)].numpy(),
                                  np.asarray(sj.keyframes.N[:len(
                                      sj.keyframes)]))


@pytest.mark.parametrize("calib", [False, True], ids=["rays", "calib"])
def test_step_path_matches_fused_path(jp, calib):
    sf, pf, promoted_f = _port(jp, calib, fused=True)
    ss, ps, promoted_s = _port(jp, calib, fused=False)
    assert ss.stats == sf.stats and ss.mode == sf.mode == Mode.TRACKING
    k = len(sf.keyframes)
    assert len(ss.keyframes) == k >= 3
    np.testing.assert_array_equal(ss.keyframes.dataset_idx[:k].numpy(),
                                  sf.keyframes.dataset_idx[:k].numpy())
    np.testing.assert_allclose(ps, pf, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ss.keyframes.T_WC[:k].numpy(),
                               sf.keyframes.T_WC[:k].numpy(), atol=1e-4)
    np.testing.assert_allclose(ss.keyframes.X[:k].numpy(),
                               sf.keyframes.X[:k].numpy(), atol=1e-3)
    np.testing.assert_allclose(ss.keyframes.C[:k].numpy(),
                               sf.keyframes.C[:k].numpy(), atol=1e-3)
    # the fused path hands the promoted frame's match to the backend
    assert any(promoted_f) and not any(promoted_s)
