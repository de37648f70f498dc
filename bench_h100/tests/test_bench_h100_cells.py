"""The harness finds every cell, configuration, traffic mix, check and
metric by name, and a new cell runs from new files and entries alone."""

import json
import os
import re

import pytest

from bench_h100.harness import cells
from bench_h100.tests import tiny

BENCH = cells.load_json(os.path.join(cells.REPO_DIR, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_from_data(workload):
    cell = cells.load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert "entry" in cell.traffic and "limits" in cell.check
    assert cells.driver(cell.config["entry"]).window
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "obs_rate"}
    assert cell.per_layer
    for m in cell.per_layer:
        if m["name"] not in ("setup_s", "obs_rate"):
            assert callable(cells.metric_reader(m["name"]))


def test_benchmark_file_keeps_to_its_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = cells.load_json(os.path.join(cells.REPO_DIR, c["file"]))
        for key in c["reduced"]:
            assert key in cfg and key in cfg["published"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.REPO_DIR,
                                        "BENCHMARK.json")) < 65536


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A mix and a cell added as a new traffic file, a new check file and
    a new ``workloads`` entry run with no existing file edited."""
    bench = tiny.make_root(tmp_path)
    base = bench["workloads"][0]
    traffic = cells.load_json(os.path.join(
        tmp_path, "bench_h100", "traffic", base["traffic"] + ".json"))
    traffic["data"].pop("impulses", None)
    with open(tmp_path / "bench_h100" / "traffic" / "quiet.json", "w") as f:
        json.dump(traffic, f)
    name = base["config"] + ".quiet"
    check = cells.load_json(os.path.join(
        tmp_path, "bench_h100", "checks", base["name"] + ".json"))
    with open(tmp_path / "bench_h100" / "checks" / f"{name}.json", "w") as f:
        json.dump(check, f)
    bench["workloads"].append(dict(base, name=name, traffic="quiet"))
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    result = tiny.run(tmp_path, name)
    assert result["correct"], result["checks"]
    assert result["metrics"]["obs_rate"]["value"] > 0
    assert list(result)[-1] == "checks"
