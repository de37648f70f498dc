"""The benchmark of pulsarutils_tpu_torch on one H100.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout; prints one JSON result line last.
"""

import os
import sys
import time

START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_h100.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(start=START))
