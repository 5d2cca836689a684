"""Each fault a cell can have, planted under the timed path, turns
`correct` false: a pass that returns its tallies unchanged, half of the
packets left out, an answer altered where
it is produced (the A2E emission, the temperatures, the map), and over
processes the exchange left out."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests import faults, tiny

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("cell,fault", [
    ("soc_example.pipeline", "unchanged"),
    ("soc_example.pipeline", "half"),
    ("soc_example.pipeline", "altered_a2e"),
    ("soc_example.pipeline", "altered_map"),
    ("soc_example.rt", "unchanged"),
    ("soc_example.rt", "half"),
    ("soc_example.rt", "altered_temperature"),
    ("soc_example.rt", "altered_map")])
def test_fault_is_caught(cell, fault):
    undo = faults.plant(fault)
    try:
        out = tiny.run(cell)
    finally:
        undo()
    assert out["correct"] is False, out["checks"]


def test_exchange_left_out_is_caught():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.join(HERE, "ranks.py"),
                          "soc_example.rt-4card", "exchange"], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
