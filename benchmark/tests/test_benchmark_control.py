"""The control (benchmark/control.py: the reference in the program's
place, in bfloat16) fails the cell's checks: at a size a CPU test run
holds, and on the card at the cell's own size on three seeds."""

import pytest

from benchmark import control, harness
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["soc_example.pipeline", "soc_example.rt"])
def test_control_fails_on_the_cpu(cell):
    # a 4^3 model with 49,152 packets a channel: each cell's bfloat16
    # tally takes thousands of deposits, as the cells' tallies do
    p = tiny.parts(cell, bgpackets=49152, root=4, nfreq=6)
    nums = control.control(cell, 5, "cpu", p)
    limits = p[3]["limits"]
    assert any(v > limits[k] for k, v in nums.items()), nums


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["soc_example.pipeline", "soc_example.rt"])
def test_control_fails_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size")
    limits = harness.cell_spec(cell)[3]["limits"]
    for seed in (4400000001, 4400000002, 4400000003):
        nums = control.control(cell, seed, "cuda")
        assert any(v > limits[k] for k, v in nums.items()), nums
