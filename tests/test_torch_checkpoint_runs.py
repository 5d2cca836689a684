"""Checkpoint/resume of phase 2, of `devices 4` and of the `pipeline`
verb: runs stopped part-way (tests/test_torch_checkpoint.py's stop) and
run again until one completes, bit for bit against the uninterrupted run
on the CPU: the ALI route stopped inside an iteration's pass under
`mmapabs` (units "it%d/f%d", a block of channels each, with the partial
pass tally and XAB), EMWEI on a 3-level octree stopped the same way,
WITH_REFERENCE with ALI across iteration boundaries, `every 2`
with stops between records, `devices 4` (a unit a sharded pass, the
reduced tally restored into the dp-0 slabs) and the pipeline's absorption
stage (its A2E solve then runs once on the resumed tallies).
"""

import numpy as np
import torch

from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.parallel import product
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.pipeline import full as tfull

from test_torch_checkpoint import (CPU, LANES, resume_until_done,
                                   resumed_against_uninterrupted, same_run)

torch.set_num_threads(2)


def test_ali_resumes_inside_the_sweep(tmp_path, monkeypatch, capsys):
    """ALI runs one mixed pool a pass, under `mmapabs` one a block of 3
    channels (4 blocks of 10); stops after 5 pools land inside the
    iterations' passes, whose blocks are units of their own."""
    ref, res = resumed_against_uninterrupted(
        tmp_path, monkeypatch, 5, cellpackets=2160, iterations=3,
        extra="ali 1\nmmapabs\n", min_stops=2,
        env={"SOC_TPU_TALLY_BYTES": str(216 * 4 * 3)})
    err = capsys.readouterr().err
    assert "skipping completed unit it1/f" in err
    assert "skipping completed unit iter0" not in err   # jumped past it
    # the passes the resumed run jumped past come from the file
    assert res.cell_passes[0]["restored"] and \
        res.cell_passes[0]["seconds"] == 0.0


def test_emweight_octree_resumes(tmp_path, monkeypatch):
    """EMWEI's allocations come from a Philox keyed by (seed, iteration),
    drawn for every channel before the pass, so a pass resumed part-way
    (under `mmapabs`, after some of its 3 blocks) draws the same ones; on
    a 3-level octree (640 cells)."""
    resumed_against_uninterrupted(
        tmp_path, monkeypatch, 4, n=8, nfreq=8, octree=(2, 8, 3),
        cellpackets=1280, iterations=3,
        extra="emweight 1 0 100\nmmapabs\n", min_stops=2,
        env={"SOC_TPU_TALLY_BYTES": str(640 * 4 * 3)})


def test_reference_ali_across_iterations(tmp_path, monkeypatch):
    """WITH_REFERENCE with ALI: the iteration snapshots carry oemitted,
    otabs and oxab; a stop after each pool (a pass) crosses the iteration
    boundaries."""
    resumed_against_uninterrupted(
        tmp_path, monkeypatch, 1, cellpackets=2160, iterations=4,
        extra="ali 1\nreference 1\n", min_stops=2)


def test_every_two_with_stops_between_records(tmp_path, monkeypatch):
    """`checkpoint ck.npz 2`: the file is written at every second unit,
    so each stop loses the unit recorded since (its tallies held as a
    host copy, never written) and the rerun does it again."""
    kw = dict(n=6, nfreq=10, hpbg=2, diffuse=0.5, cellpackets=2160,
              iterations=2)
    one = write_model(str(tmp_path / "one"), kind="eqdust", **kw)
    ini = write_model(str(tmp_path / "ck"), kind="eqdust",
                      extra="checkpoint ck.npz 2\n", **kw)
    ref = tdriver.run(one, device=CPU, lanes=LANES)
    assert resume_until_done(monkeypatch, ini, 3) >= 1
    res = tdriver.run(ini, device=CPU, lanes=LANES)
    same_run(res, ref)


def test_devices_4_resumes(tmp_path, monkeypatch):
    """`devices 4` (dp 2 x freq 2) with cell emission and ALI: a unit a
    sharded pass (four transport_steps calls), the snapshot the folded
    slabs; the resumed run equals the uninterrupted `devices 4` run."""
    kw = dict(n=6, nfreq=10, hpbg=2, cellpackets=2160, iterations=3,
              extra="devices 4\nali 1\n")
    one = write_model(str(tmp_path / "one"), kind="eqdust", **kw)
    kw["extra"] += "checkpoint ck.npz\n"
    ini = write_model(str(tmp_path / "ck"), kind="eqdust", **kw)
    ref = tdriver.run(one, device=CPU, lanes=LANES)
    assert resume_until_done(monkeypatch, ini, 4, module=product,
                             name="transport_steps") >= 2
    res = tdriver.run(ini, device=CPU, lanes=LANES)
    assert res.devices == [CPU] * 4
    same_run(res, ref)


def test_pipeline_absorption_stage_resumes(tmp_path, monkeypatch):
    """The `pipeline` verb with `checkpoint`: the absorption stage goes
    through driver.run (the background, then the sky), is stopped and
    resumed; the A2E stage then solves the same absorptions."""
    kw = dict(kind="gset", nfreq=8, nsize=4, hpbg=2,
              extra="nenumber 16\n")
    one = write_model(str(tmp_path / "one"), 4, **kw)
    kw["extra"] += "checkpoint ck.npz\n"
    ini = write_model(str(tmp_path / "ck"), 4, **kw)
    run = (lambda p: tfull.run_pipeline(p, device=CPU, lanes=LANES))
    run(one)
    assert resume_until_done(monkeypatch, ini, 1, run=run) == 1
    run(ini)
    for name in ("emitted.data", "absorbed.data"):
        np.testing.assert_array_equal(
            np.fromfile(tmp_path / "ck" / name, np.float32),
            np.fromfile(tmp_path / "one" / name, np.float32))
