"""Mid-run checkpoints of the port (``slam/checkpoint.py``) against the JAX
package's file format and resume.

* Crash and resume through ``run()``: a run checkpointed every N frames,
  killed after the checkpoint and resumed in a fresh system from
  ``resume_frame`` gives the uninterrupted run's keyframes, poses within
  1e-5 and maps within 1e-5 (``tests/test_e2e_oracle.py:136``'s bounds),
  per frame (W = 1) and at a window boundary (W = 4).
* The two packages' files: the same keys, shapes and dtypes; a JAX file
  resumed by the port and a port file resumed by JAX give what the other
  package's resume gives, on the JAX oracle's replayed outputs, with a
  retrieval database in the state (3 frames saved, 2 more after the
  resume: the JAX solver's shapes stay those of its first compile): every
  stat equal, poses within 2e-4 (the backend tolerance of
  ``tests/test_torch_slice.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from mast3r_slam_tpu import config as jconfig
from mast3r_slam_tpu.models import oracle as joracle
from mast3r_slam_tpu.slam import checkpoint as jcheckpoint
from mast3r_slam_tpu.slam.system import SLAMSystem as JSystem
from mast3r_slam_tpu_torch import config as tconfig
from mast3r_slam_tpu_torch.io import datasets as tdatasets
from mast3r_slam_tpu_torch.models import convert
from mast3r_slam_tpu_torch.models import oracle_timing as tot
from mast3r_slam_tpu_torch.slam import checkpoint
from mast3r_slam_tpu_torch.slam.frame import Mode
from mast3r_slam_tpu_torch.slam.system import SLAMSystem as TSystem
from test_torch_run import T_PNG_ORACLE, _dataset
from test_torch_slice import (JCFG, TCFG, _gt_trajectory, _replay_module,
                              _retrieval_params)
from test_torch_window import _cfg

torch.set_num_threads(1)

N_FRAMES = 9
H, W = TCFG.img_size
SAVED, RESUMED = 3, 5          # the file format tests' frame counts


@pytest.mark.parametrize("window,every", [(1, 5), (4, 4)])
def test_crash_resume_trajectory_equivalence(tmp_path, window, every):
    """``run(checkpoint_path=, checkpoint_every=)`` over 9 frames, killed
    after frame 4; at W = 4 the checkpoint falls after the first window
    (frame 0, then frames 1-4), with that window's keyframes still queued
    for the backend, and the resume runs the window 5-8."""
    jp = joracle.make_params(_gt_trajectory(N_FRAMES),
                             desc_dim=JCFG.desc_dim)
    params = convert.oracle_params_from_jax(jax.device_get(jp), device="cpu")
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(N_FRAMES):
        PIL.Image.fromarray(tot.make_frame_image(i, H, W)).save(
            frames / f"{i:04d}.png")

    def fresh():
        return TSystem(params, TCFG, _cfg(tconfig, window), (H, W),
                       keyframe_capacity=16, edge_capacity=64,
                       model_module=T_PNG_ORACLE, device="cpu")

    sys_a = fresh()
    sys_a.run(_dataset(tdatasets, frames))
    ck = tmp_path / "crash.npz"
    sys_b = fresh()
    # the crash: whatever the run does after the checkpoint is lost
    sys_b.run(_dataset(tdatasets, frames), max_frames=5,
              checkpoint_path=ck, checkpoint_every=every)
    del sys_b
    sys_c = fresh()
    checkpoint.load_state(ck, sys_c)
    assert sys_c.resume_frame == 5 and sys_c.mode == Mode.TRACKING
    if window > 1:
        assert sys_c.backend_queue == [1, 2, 3, 4]
    sys_c.run(_dataset(tdatasets, frames), start_frame=sys_c.resume_frame)

    na, nc = len(sys_a.keyframes), len(sys_c.keyframes)
    assert na == nc >= 4
    assert sys_c.factor_graph.n_edges == sys_a.factor_graph.n_edges
    ka, kc = sys_a.keyframes, sys_c.keyframes
    np.testing.assert_array_equal(ka.dataset_idx[:na].numpy(),
                                  kc.dataset_idx[:nc].numpy())
    np.testing.assert_allclose(ka.T_WC[:na].numpy(), kc.T_WC[:nc].numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ka.X[:na].numpy(), kc.X[:nc].numpy(),
                               atol=1e-5, rtol=0)


# -- the file format, both ways -------------------------------------------------


def _drive(system, frames):
    for i in frames:
        system.process_frame(system.make_frame(
            i, joracle.make_frame_image(i, H, W)))
        while system.backend_step():
            pass


def _jax_system(jp, jr):
    return JSystem(jp, JCFG, _cfg(jconfig, 1, "base"), (H, W),
                   retrieval_params=jr, keyframe_capacity=16,
                   edge_capacity=64, model_module=joracle)


def _port_system(jp, tr):
    return TSystem(None, TCFG, _cfg(tconfig, 1, "base"), (H, W),
                   retrieval_params=tr, keyframe_capacity=16,
                   edge_capacity=64, model_module=_replay_module(jp),
                   device="cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Both packages run ``SAVED`` base frames with retrieval and save
    their state; then each resumes its own file up to ``RESUMED``."""
    tmp = tmp_path_factory.mktemp("ckpt")
    jp = joracle.make_params(_gt_trajectory(N_FRAMES),
                             desc_dim=JCFG.desc_dim)
    jr, tr = _retrieval_params()
    out = {"jp": jp, "jr": jr, "tr": tr}
    for tag, make, save in (("jax", _jax_system, jcheckpoint.save_state),
                            ("port", _port_system, checkpoint.save_state)):
        s = make(jp, jr if tag == "jax" else tr)
        _drive(s, range(SAVED))
        out[tag] = save(tmp / f"{tag}.npz", s)
    sj = _jax_system(jp, jr)
    jcheckpoint.load_state(out["jax"], sj)
    _drive(sj, range(sj.resume_frame, RESUMED))
    sj.factor_graph.flush()
    st = _port_system(jp, tr)
    checkpoint.load_state(out["port"], st)
    _drive(st, range(st.resume_frame, RESUMED))
    out["resumed"] = {"jax": sj, "port": st}
    return out


def test_checkpoint_file_holds_the_jax_keys_shapes_and_dtypes(files):
    dj, dt = np.load(files["jax"]), np.load(files["port"])
    assert sorted(dt.files) == sorted(dj.files)
    assert any(k.startswith("ivf_") for k in dt.files)
    assert "current_T_WC" in dt.files
    for k in dj.files:
        assert dt[k].shape == dj[k].shape, k
        assert dt[k].dtype == dj[k].dtype, k
    for k in ("kf_n_size", "kf_dataset_idx", "fg_n_edges", "fg_ii", "fg_jj",
              "mode", "backend_queue", "last_frame_id",
              "retrieval_kf_counter"):
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    np.testing.assert_allclose(dt["kf_T_WC"], dj["kf_T_WC"], atol=2e-4)


def _compare(a, b):
    """a and b: a JAX and a port system, or two port systems."""
    assert a.stats == b.stats and a.mode.name == b.mode.name
    k = len(a.keyframes)
    assert k == len(b.keyframes) == RESUMED
    assert a.factor_graph.n_edges == b.factor_graph.n_edges > 0
    assert a.retrieval.kf_counter == b.retrieval.kf_counter
    np.testing.assert_array_equal(np.asarray(a.keyframes.dataset_idx[:k]),
                                  np.asarray(b.keyframes.dataset_idx[:k]))
    np.testing.assert_allclose(np.asarray(a.keyframes.T_WC[:k]),
                               np.asarray(b.keyframes.T_WC[:k]), atol=2e-4,
                               rtol=0)


def test_jax_checkpoint_resumes_in_the_port(files):
    st = _port_system(files["jp"], files["tr"])
    checkpoint.load_state(files["jax"], st)
    assert st.resume_frame == SAVED
    assert st.keyframes.pos.dtype == torch.int64
    _drive(st, range(st.resume_frame, RESUMED))
    st.factor_graph.flush()
    _compare(files["resumed"]["jax"], st)


def test_port_checkpoint_resumes_in_jax(files):
    sj = _jax_system(files["jp"], files["jr"])
    jcheckpoint.load_state(files["port"], sj)
    assert sj.resume_frame == SAVED
    _drive(sj, range(sj.resume_frame, RESUMED))
    sj.factor_graph.flush()
    st = files["resumed"]["port"]
    st.factor_graph.flush()
    _compare(sj, st)
    np.testing.assert_array_equal(np.asarray(sj.keyframes.pos[:1]),
                                  st.keyframes.pos[:1].numpy())
    assert jnp.asarray(sj.keyframes.feat).dtype == jnp.bfloat16
