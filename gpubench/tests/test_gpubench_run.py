"""Whole runs of the harness at the tiny size on the CPU (its look for a
CUDA device skipped): a sound run is correct, and each fault the cells can
have, planted under the timed path, makes ``correct`` false. The control
(the reference one precision step down) fails the network's limit. Without
a card the command fails and prints nothing."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from gpubench import calibrate, run
from gpubench.tests.tiny import SIZES

REPO = pathlib.Path(__file__).resolve().parents[2]
CELL = "tpu_fast.scan.w8"


def _run(capsys, seed, cell=CELL, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "3", "--trace", str(trace)], device="cpu", sizes=SIZES)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys):
    out = _run(capsys, 2 ** 31 + 99)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["metrics"]["fps"]["value"] > 0
    assert out["attempted"] > 0 and out["failed"] == 0


def test_traced_run_reports_layer_metrics(capsys):
    out = _run(capsys, 7, cell="tpu_fast.live.w1", trace=1)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"tracking_ms_per_frame.live",
                                   "backend_ms_per_kf.live"}


def _state_unchanged(monkeypatch):
    from mast3r_slam_tpu_torch.slam import tracker

    def gn_solve_plain(T_init, *a, **k):
        z = torch.zeros((), device=T_init.device)
        return tracker.TrackResult(T_init, z, z.int(), z.bool())

    monkeypatch.setattr(tracker, "gn_solve_plain", gn_solve_plain)


def _half_batch(monkeypatch):
    from mast3r_slam_tpu_torch.models import mast3r

    orig = mast3r.encode

    def encode(model, img, cfg):
        b = img.shape[0]
        if b < 2:
            return orig(model, img, cfg)
        feat, pos = orig(model, img[:b // 2], cfg)
        rest = feat.mean(0, keepdim=True).expand(b - b // 2, *feat.shape[1:])
        return torch.cat([feat, rest]), torch.cat([pos, pos[:1].expand(
            b - b // 2, *pos.shape[1:])])

    monkeypatch.setattr(mast3r, "encode", encode)


def _answer_altered(monkeypatch):
    from mast3r_slam_tpu_torch.models import mast3r

    orig = mast3r.decode_pair

    def decode_pair(*a, **k):
        res1, res2 = orig(*a, **k)
        res1 = dict(res1, pts3d=res1["pts3d"] * 2.0)
        return res1, res2

    monkeypatch.setattr(mast3r, "decode_pair", decode_pair)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_fault_makes_run_incorrect(capsys, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(capsys, 2 ** 31 + 99)
    assert not out["correct"], out["checks"]


def test_control_fails_the_network_limits():
    """The reference one precision step down (fp8 where the program is
    bf16) in the program's place fails the cell's network limits, at the
    tiny size; the program (float32 there) meets the tiny size's limits."""
    limits = json.loads((REPO / "gpubench" / "limits" /
                         f"{CELL}.json").read_text())
    net = [k for k in limits if k == "enc_err" or k.startswith("dec_")]
    assert net
    for seed in (1, 2, 2 ** 31 + 5):
        res = calibrate.one(CELL, seed, 2, device="cpu", sizes=SIZES)
        for k in ("enc_err", "asym_err", "sym_err"):
            assert res["program"][k] <= SIZES["limits"][k]
        assert any(res["control"][k] > limits[k] for k in net), res["control"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_bare_checkout_fails(tmp_path):
    """Only BENCHMARK.json and the files under ``paths``: no program to
    measure, so no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.argv = ['x']; from gpubench import run; "
            "sys.exit(run.main(['--workload', 'tpu_fast.scan.w8', "
            "'--seed', '1', '--seconds', '1', '--trace', '0'], "
            "device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
