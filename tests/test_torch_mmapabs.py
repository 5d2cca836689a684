"""`mmapabs` and the SOC_TPU_TALLY_BYTES trigger: the per-frequency tally
in a host memmap, each pass run one pool per block of channels whose
device tally fits the budget, against the same run with the tally in
memory (the octree model of tests/test_torch_phase2.py: an 8^3 root, 640
cells, 10 channels, cell packets and two iterations), plain, with ALI and
with EMWEI.

Tolerances (soc_tpu's own, tests/test_ini_wiring.py): the same packets on
the same streams, but a block's pool adds its deposits in another order
than the one mixed pool: the integrated heating and the temperatures at
1e-6 relative, the absorbed file's entries (a cell's few deposits at one
channel, summed in another order) at 5e-6. Both tallies are scaled by the
same in-place function and written by the same writer, so the written
absorbed.data equals the run's own scaled tally bit for bit.
"""

import numpy as np
import pytest
import torch

from soc_tpu_torch.pipeline import driver as tdriver

from test_torch_phase2 import CELLS, LANES, NFREQ, octree_model

torch.set_num_threads(2)
CPU = torch.device("cpu")
BLOCK = 3                    # channels a device block in the budget runs


def _run(d, extra, budget=None, monkeypatch=None):
    if budget is not None:
        monkeypatch.setenv("SOC_TPU_TALLY_BYTES", str(budget))
    try:
        return tdriver.run(octree_model(d, iterations=2, extra=extra),
                           device=CPU, lanes=LANES)
    finally:
        if budget is not None:
            monkeypatch.delenv("SOC_TPU_TALLY_BYTES")


def _same(mm, mem, d):
    live = mem.absorbed > -1e19
    np.testing.assert_array_equal(mm.absorbed > -1e19, live)
    np.testing.assert_allclose(np.asarray(mm.absorbed)[live],
                               mem.absorbed[live], rtol=5e-6, atol=1e-30)
    np.testing.assert_allclose(mm.ctabs, mem.ctabs, rtol=1e-6)
    np.testing.assert_allclose(mm.temperature, mem.temperature, rtol=1e-6)
    raw = np.fromfile(d / "absorbed.data", np.float32)
    assert raw[:2].view(np.int32).tolist() == [CELLS, NFREQ]
    np.testing.assert_array_equal(raw[2:].reshape(CELLS, NFREQ),
                                  np.asarray(mm.absorbed))


@pytest.mark.parametrize("extra", ["", "ali 1\n", "emweight 1\n"],
                         ids=["plain", "ali", "emweight"])
def test_mmapabs_equals_the_in_memory_run(tmp_path, monkeypatch, extra):
    mem = _run(tmp_path / "mem", extra)
    mm = _run(tmp_path / "mm", extra + "mmapabs\n",
              budget=CELLS * 4 * BLOCK, monkeypatch=monkeypatch)
    _same(mm, mem, tmp_path / "mm")
    nblocks = -(-NFREQ // BLOCK)
    assert [st["pools"] for st in mm.source_passes] == [nblocks]
    # every route runs one mixed pool a block
    assert [st["pools"] for st in mm.cell_passes] == [nblocks]
    for st in mm.cell_passes:
        assert np.abs(tdriver.pass_balance(st)).max() < 1e-4


def test_mmapabs_alone_and_the_budget_trigger(tmp_path, monkeypatch):
    """`mmapabs` with no budget holds the whole tally in one device block;
    a budget below the tally's size moves it to the host without the
    keyword."""
    mem = _run(tmp_path / "mem", "")
    alone = _run(tmp_path / "alone", "mmapabs\n")
    assert [st["pools"] for st in alone.source_passes] == [1]
    _same(alone, mem, tmp_path / "alone")
    auto = _run(tmp_path / "auto", "", budget=1024,
                monkeypatch=monkeypatch)
    assert [st["pools"] for st in auto.source_passes] == [NFREQ]
    _same(auto, mem, tmp_path / "auto")
