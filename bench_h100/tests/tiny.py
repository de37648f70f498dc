"""A tiny copy of the benchmark's cells for the CPU: the same files and
entries, with fewer channels, a coarser sample time, a lower DM ceiling
and short pointings, so that a whole run takes seconds."""

from __future__ import annotations

import json
import os
import shutil
import sys

from bench_h100.harness import cells

#: per configuration: the keys a tiny copy changes
TINY = {
    "htru_hilat": {"nchans": 256, "foff": -1.5625, "tsamp": 1e-3,
                   "nsamples": 4096, "dmmax": 100.0},
    "pmps_13beam": {"nchans": 16, "foff": -18.0, "tsamp": 1e-3,
                    "nsamples": 4096, "dmmax": 60.0},
}

#: traffic keys a tiny copy changes (DMs within the tiny DM ceiling, fewer
#: events in the short pointing, the roll formulation the CPU resolves to)
TINY_PULSES = {"dm": [10.0, 50.0], "width_ms": [2.0, 8.0],
               "first_s": 1.8, "every_s": 3.0, "jitter_s": 0.2}
TINY_IMPULSES = {"first_s": 0.3, "every_s": 3.0, "jitter_s": 0.2}
TINY_KERNEL = {"gather": "roll"}

_ABSENT = object()


def make_root(dest, bench_dir=cells.BENCH_DIR):
    """A tiny benchmark under ``dest``: ``BENCHMARK.json`` and the
    configuration, traffic and check files of every cell."""
    bench = cells.load_json(os.path.join(os.path.dirname(bench_dir),
                                         "BENCHMARK.json"))
    for sub in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(dest, "bench_h100", sub), exist_ok=True)
    for c in bench["configs"]:
        cfg = cells.load_json(os.path.join(os.path.dirname(bench_dir),
                                           c["file"]))
        cfg.update(TINY.get(cfg["name"], {}))
        with open(os.path.join(dest, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(bench_dir, "traffic")):
        t = cells.load_json(os.path.join(bench_dir, "traffic", name))
        if "pulses" in t.get("data", {}):
            t["data"]["pulses"].update(TINY_PULSES)
        if "impulses" in t.get("data", {}):
            t["data"]["impulses"].update(TINY_IMPULSES)
        kern = t["entry"].get("kernel")
        t["entry"]["kernel"] = TINY_KERNEL.get(kern, kern)
        with open(os.path.join(dest, "bench_h100", "traffic", name), "w") as f:
            json.dump(t, f)
    for name in os.listdir(os.path.join(bench_dir, "checks")):
        shutil.copy(os.path.join(bench_dir, "checks", name),
                    os.path.join(dest, "bench_h100", "checks", name))
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


def run(root, workload, seed=2 ** 31 + 7, seconds=4.0, trace=0,
        control=False):
    """One CPU run of ``workload`` of the tiny benchmark under ``root``,
    without matplotlib, as on the card's machine (no diagnostic plots)."""
    import torch

    from bench_h100.harness import main

    cell = cells.load_cell(workload, root=str(root))
    saved = sys.modules.get("matplotlib", _ABSENT)
    sys.modules["matplotlib"] = None   # an import of it raises ImportError
    try:
        result, _ = main.run_cell(cell, seed, seconds, trace,
                                  torch.device("cpu"),
                                  os.path.join(str(root), "run"),
                                  control=control)
    finally:
        if saved is _ABSENT:
            del sys.modules["matplotlib"]
        else:
            sys.modules["matplotlib"] = saved
    return result
