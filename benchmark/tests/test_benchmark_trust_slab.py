"""The slab cell's checks catch each fault planted under its timed path
(benchmark/tests/slab_faults.py: the star's deposits permuted among
every refined parent's children, half of the star's packets left out,
both passes' deposits moved one root cell along x, the cell pass
returning its tally unchanged, its self-absorbed deposits put in the
absorbed tally, one level's temperatures altered), and its control (benchmark/control_slab.py: the reference in
bfloat16 in the program's place) fails them: on the tiny slab on the
CPU, and at the cell's own size on the card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import control_slab, harness
from benchmark.tests import slab_faults, tiny_slab

# two threads a test process, as the tier-1 files take
torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FAULTS = ["children_permuted", "half", "shifted_x", "cell_unchanged",
          "self_to_tabs", "level_temperature"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught(fault):
    undo = slab_faults.plant(fault)
    try:
        out = tiny_slab.run()
    finally:
        undo()
    assert out["correct"] is False, out["checks"]


def test_control_fails_on_the_cpu():
    p = tiny_slab.parts()
    nums = control_slab.control(tiny_slab.CELL, 5, "cpu", p)
    limits = p[3]["limits"]
    assert set(nums) == set(limits)
    assert any(v > limits[k] for k, v in nums.items()), nums


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell at its own size")


@pytest.mark.gpu
def test_control_fails_on_the_card():
    _card()
    limits = harness.cell_spec(tiny_slab.CELL)[3]["limits"]
    for seed in (4400000001, 4400000002, 4400000003):
        nums = control_slab.control(tiny_slab.CELL, seed, "cuda")
        assert any(v > limits[k] for k, v in nums.items()), nums


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught_on_the_card(fault):
    _card()
    out = subprocess.run([sys.executable, os.path.join(HERE, "slab_card.py"),
                          fault, "5500000001"], capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
