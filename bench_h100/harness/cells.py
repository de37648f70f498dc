"""A cell, found by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file, its check file (the limits of the
comparison that decides ``correct``) and its metrics.  Nothing here names
a configuration, a traffic mix or a metric: a later cell is files and
entries."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    run_seconds: int

    @property
    def name(self):
        return self.workload["name"]


def _applies(metric, workload, end_to_end_names):
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in end_to_end_names


def load_cell(workload, root=REPO_DIR, bench=None):
    """The :class:`Cell` of ``workload`` under ``root``."""
    bench = bench if bench is not None else load_json(
        os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    bench_dir = os.path.join(root, bench["paths"][0])
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     entry["traffic"] + ".json"))
    check = load_json(os.path.join(bench_dir, "checks", workload + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(entry, config, traffic, check, e2e, per_layer,
                int(bench["run_seconds"]))


def driver(entry):
    """The driver module of a configuration's program entry."""
    return importlib.import_module(f"bench_h100.drivers.{entry}")


def metric_reader(name, bench_dir=BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_h100_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
