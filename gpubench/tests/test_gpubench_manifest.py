"""The manifest keeps to the benchmark contract's names and limits, and
every cell's files are found by name."""

import json
import pathlib
import re

import pytest

from gpubench import harness, traffic

REPO = pathlib.Path(__file__).resolve().parents[2]
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["gpubench"]
    assert len(json.dumps(MAN)) < 64 * 1024
    assert all(not w.startswith("/") and ".." not in w
               for w in MAN["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        for k in e.get("reduced", []):
            assert NAME.match(k)


def test_cells():
    configs = {c["name"] for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in MAN["workloads"]} == configs


def test_metrics_per_cell():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in MAN["workloads"]]
    for cell in cells:
        mine = [m["name"] for m in MAN["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in MAN["per_layer"]
                 if cell in m.get("workloads", cells)]
        assert layer
        for m in layer:
            assert m["moves"] in mine, (cell, m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    _, config, mix, per_layer, e2e = harness.cell_spec(cell, REPO)
    for key in ("model", "slam", "capacity", "control", "precision"):
        assert key in config
    limits = json.loads((REPO / "gpubench" / "limits" /
                         f"{cell}.json").read_text())
    assert "enc_err" in limits and all(
        isinstance(v, float) and v > 0 for v in limits.values())
    assert traffic.load(
        [w for w in MAN["workloads"] if w["name"] == cell][0]["traffic"])
    for m in per_layer:
        assert callable(harness.load_reader(m["name"]))
    assert mix["scan_frames"] >= mix["orbit_frames"] > 0


def test_config_files_under_paths():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("gpubench/") and (REPO / f).exists()
    # each cut the manifest lists is one the file explains, and no other
    for c in MAN["configs"]:
        assert sorted(c["reduced"]) == sorted(
            json.loads((REPO / c["file"]).read_text())["reduced"])
