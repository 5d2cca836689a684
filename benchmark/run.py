"""Entry point of the benchmark: python3 benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>, from the checkout's root
(benchmark/harness.py says what a run does)."""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
