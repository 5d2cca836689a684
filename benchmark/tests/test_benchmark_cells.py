"""The one-card cells at a CPU size, end to end through the harness: the
window, the result's keys and the checks against the reference; and the
four-process cell's path on four CPU processes over gloo."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("cell", ["soc_example.pipeline", "soc_example.rt"])
def test_cell_is_correct(cell):
    out = tiny.run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"run_s", "packets_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    for v in out["checks"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("cell,metrics", [
    ("soc_example.pipeline", {"absorption.packets_per_s", "a2e.cells_per_s",
                              "maps.s", "driver.io_s.pipeline"}),
    ("soc_example.rt", {"background.packets_per_s", "driver.io_s.rt"})])
def test_traced_cell(cell, metrics):
    out = tiny.run(cell, trace=1)
    assert out["correct"]
    # on the CPU there is no device trace: its metrics are left out
    assert set(out["metrics"]) == metrics
    assert out["device"]["window_s"] > 0
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_four_processes():
    """soc_example.rt-4card's path: four ranks, one result from rank 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.join(HERE, "ranks.py"),
                          "soc_example.rt-4card", "none"], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4
