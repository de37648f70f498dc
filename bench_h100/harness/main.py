"""One run of one cell: set up, make the inputs, warm up, measure, check,
print the result line.

``python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout.  The cell's configuration,
traffic, check and metrics are found by name (:mod:`.cells`); the
program's entry by the configuration's ``entry`` (``drivers/<entry>.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time
import types

from . import cells, guard

#: fixed cache directories inside the checkout, so that only the first
#: run of a checkout builds and compiles
CACHE_DIR = os.path.join(cells.BENCH_DIR, "cache")


def _env():
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["PUTPU_TUNE_CACHE"] = os.path.join(CACHE_DIR, "tune",
                                                  "tune_cache.json")
    os.makedirs(os.path.dirname(os.environ["PUTPU_TUNE_CACHE"]),
                exist_ok=True)
    os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_name(torch, device):
    if device.type == "cuda":
        return "gpu", torch.cuda.get_device_name(device)
    return "cpu", "cpu"


def _geometry(drv, ctx):
    """One beam's search geometry, as the reference plans it."""
    r = drv.reference(ctx)[0]
    return {"ndm": len(r.dms), "nchan": r.nchan,
            "nsamples": r.step // r.resample}


def run_cell(cell, seed, seconds, trace, device, root_dir, control=False,
             start=None):
    """Set up, measure and check one run of ``cell`` on ``device``;
    returns ``(result dict, check lines)``.  ``root_dir`` holds the run's
    files (emptied first, removed after).  The set-up
    is timed from ``start`` (``time.perf_counter()``; now by default).

    ``control``: True puts the reference at the next lower precision in
    the program's place for the comparison; ``"both"`` also adds that
    control's numbers to the result (``control_checks``), so one window
    gives the program's readings and the control's."""
    t_setup = time.perf_counter() if start is None else start
    import torch

    from pulsarutils_tpu_torch.utils.logging_utils import (BudgetAccountant,
                                                           compile_snapshot)

    from .checking import verdict
    from .generate import make_pointing

    drv = cells.driver(cell.config["entry"])
    shutil.rmtree(root_dir, ignore_errors=True)
    os.makedirs(root_dir)
    ctx = types.SimpleNamespace(cell=cell, device=device, seed=seed,
                                work_dir=os.path.join(root_dir, "out"))
    ctx.files, _, _ = make_pointing(cell.config, cell.traffic, seed,
                                    os.path.join(root_dir, "data"), device)
    drv.warm(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    builds, build_s = compile_snapshot()
    setup_s = time.perf_counter() - t_setup

    trace_dir = os.path.join(root_dir, "trace")
    factory = BudgetAccountant if trace else None
    if trace:
        from pulsarutils_tpu_torch.obs.trace import (DEVICE_TRACE_FILE,
                                                      trace_session)
        with trace_session(device_trace_dir=trace_dir):
            rec = drv.window(ctx, seconds, factory)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    else:
        rec = drv.window(ctx, seconds, factory)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0

    view = types.SimpleNamespace(
        cell=cell, rec=rec, window_s=rec["wall_s"], peak_bytes=peak,
        geometry=_geometry(drv, ctx), busy_s=None, kernels={},
        chunks=[c for b in rec["budgets"] for c in b.chunks],
        stage_totals={}, device_kind=device_name(torch, device)[1])
    for b in rec["budgets"]:
        for k, v in b.stage_seconds().items():
            view.stage_totals[k] = view.stage_totals.get(k, 0.0) + v
    breakdown = None
    if trace:
        from .devtrace import summarise

        path = os.path.join(trace_dir, DEVICE_TRACE_FILE)
        if os.path.exists(path):
            view.busy_s, view.kernels, breakdown = summarise(path)
            os.remove(path)

    # the program's device memory goes back before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.check(ctx, rec, seed, control=control is True)
    check_s = time.perf_counter() - t_check
    ok, checks = verdict(numbers, cell.check["limits"])
    control_checks = None
    if control == "both":
        control_checks = verdict(drv.check(ctx, rec, seed, control=True),
                                 cell.check["limits"])[1]

    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        if m["name"] == "setup_s":
            value = setup_s
        elif m["name"] == "obs_rate" and not trace:
            value = rec["obs_s"] / rec["wall_s"]
        else:
            value = cells.metric_reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    platform, kind = device_name(torch, device)
    dev = {"platform": platform, "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    if trace and view.busy_s:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = rec["wall_s"]
    result = {"correct": bool(ok and rec["units"] > 0),
              "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["timing"] = {"kernel_builds": builds, "build_s": build_s,
                        "window_s": rec["wall_s"], "check_s": check_s,
                        "units": rec["units"], "jobs": len(rec["jobs"])}
    if control_checks is not None:
        result["control_checks"] = control_checks
    result["checks"] = checks
    shutil.rmtree(root_dir, ignore_errors=True)
    return result, checks


def main(argv=None, start=None):
    args = parse(argv)
    _env()
    cell = cells.load_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA device for {args.workload} (needs {chips})",
              file=sys.stderr)
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds, args.trace,
                              torch.device("cuda:0"),
                              os.path.join(CACHE_DIR, "run"), start=start)
    found = guard.loaded_forbidden()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
