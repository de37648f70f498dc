"""Readings for the limits of the comparison that decides ``correct``:
for each seed, one run of a cell (set-up, window, the program's numbers)
and the control's numbers over the same window (the reference at the
next lower precision in the program's place).  One JSON line a seed.

    python3 bench_h100/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_h100.harness import cells, main  # noqa: E402


def run(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    main._env()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    for seed in args.seeds:
        result, _ = main.run_cell(cell, seed, args.seconds, 0,
                                  torch.device("cuda:0"),
                                  os.path.join(main.CACHE_DIR, "run"),
                                  control="both")
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "program": result["checks"],
                          "control": result["control_checks"],
                          "metrics": result["metrics"],
                          "timing": result["timing"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
