"""Runs the slab cell at its own size on the card with one of
benchmark/tests/slab_faults.py's faults planted (or "none"), and prints
the result's line, as benchmark/run.py would:

    python3 benchmark/tests/slab_card.py <fault> <seed> [seconds]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(fault, seed, seconds=1.0):
    from benchmark import harness
    from benchmark.tests import slab_faults
    from benchmark.tests.tiny_slab import CELL
    undo = slab_faults.plant(fault)
    try:
        out = harness.execute(CELL, int(seed), float(seconds), 0)
    finally:
        undo()
    print(json.dumps(dict(out, fault=fault, seed=int(seed))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
