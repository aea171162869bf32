"""What the benchmark loads: never JAX nor the JAX package (names
compared whole), and a reference that loads nothing of the program."""

import ast
import pathlib
import subprocess
import sys

from gpubench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPO = ROOT.parent


def test_top_level_names_compared_whole():
    assert harness.forbidden_modules(
        ["mast3r_slam_tpu_torch", "mast3r_slam_tpu_torch.models.mast3r",
         "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(
        ["mast3r_slam_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "mast3r_slam_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("mast3r_slam_tpu_torch", "mast3r_slam_tpu",
                               "jax", "jaxlib", "flax"), (path, name)
    code = ("import sys; import gpubench.reference.mast3r_plain, "
            "gpubench.reference.scene, gpubench.reference.poses, "
            "gpubench.reference.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mast3r_slam_tpu_torch', 'mast3r_slam_tpu', 'jax', 'jaxlib', "
            "'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_harness_sources_import_no_jax():
    for path in ROOT.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("mast3r_slam_tpu", "jax", "jaxlib", "flax"), (
                path, name)


def test_a_run_loads_no_jax():
    """A whole run at the tiny size, in its own process: the modules it
    loaded, by top-level name."""
    code = ("import sys; sys.argv = ['x']; "
            "from gpubench import run; from gpubench.tests.tiny import SIZES; "
            "rc = run.main(['--workload', 'tpu_fast.scan.w8', '--seed', "
            "'4000000001', '--seconds', '2', '--trace', '0'], device='cpu', "
            "sizes=SIZES); "
            "from gpubench import harness; "
            "print('FOUND', harness.forbidden_modules(), rc)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND [] 0" in out.stdout
