"""Mid-run checkpoint/resume (soc_tpu_torch.utils.checkpoint): the
RunCheckpoint file itself, then `rt` runs stopped part-way and run again
to completion, phase 1's sources (6^3 cells, 10 channels), against the
uninterrupted run of the same ini. The stop is an exception raised from
the transport_steps call that starts each pool (product.run_freqs runs
every pass of the driver, one device as a one-shard mesh) after k calls
(soc_tpu's tests stop their runs the same way); each rerun resumes from
the file and goes one unit further, until a run completes.

On the CPU index_add_ adds in a fixed order, so a resumed run equals the
uninterrupted one bit for bit: every output array, and the per-channel
escaped / launched / missed / injected vectors (float64) exactly.
Phase 2, `devices 4` and the pipeline: tests/test_torch_checkpoint_runs.py.
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu_torch.config import RunConfig
from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.parallel import product
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12
SOURCES = [(3.1, 2.9, 3.2, 0.3), (-2.0, 3.0, 3.0, 1.0)]
ARRAYS = ("absorbed", "emitted", "temperature", "ctabs", "roi_tally",
          "intensity")
VECTORS = ("escaped", "launched", "missed", "injected", "absorbed_photons")


class Stop(Exception):
    """The stand-in for a preemption."""


def stopped_run(monkeypatch, ini, after, module=product,
                name="transport_steps", run=None):
    """Run ``ini`` with module.name raising Stop after ``after`` calls;
    True when it was stopped."""
    real = getattr(module, name)
    calls = [0]

    def stub(*args, **kw):
        calls[0] += 1
        if calls[0] > after:
            raise Stop()
        return real(*args, **kw)

    monkeypatch.setattr(module, name, stub)
    try:
        (run or (lambda p: tdriver.run(p, device=CPU, lanes=LANES)))(ini)
        return False
    except Stop:
        return True
    finally:
        monkeypatch.setattr(module, name, real)


def resume_until_done(monkeypatch, ini, after, **kw):
    """Stop the run after ``after`` calls, again and again, until one
    completes; returns how often it was stopped."""
    stops = 0
    while stopped_run(monkeypatch, ini, after, **kw):
        stops += 1
        assert stops < 40, "the resumed runs make no progress"
    return stops


def same_run(a, b):
    """Two results, bit for bit."""
    for name in ARRAYS + VECTORS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)
    if 0 in b.maps:
        np.testing.assert_array_equal(a.maps[0], b.maps[0])
    # every cell pass, run or restored from the file: the same weights
    # (absorbed summed by column or channel by channel: 1e-12)
    assert len(a.cell_passes) == len(b.cell_passes)
    for p, q in zip(a.cell_passes, b.cell_passes):
        assert p["iteration"] == q["iteration"]
        for name in ("escaped", "injected", "injected_abs"):
            np.testing.assert_array_equal(p[name], q[name], err_msg=name)
        if q["absorbed"] is not None:
            np.testing.assert_allclose(p["absorbed"], q["absorbed"],
                                       rtol=1e-12, atol=1e-300)


def resumed_against_uninterrupted(tmp_path, monkeypatch, after, n=6,
                                  nfreq=10, extra="", min_stops=1, env=None,
                                  **kw):
    """The ini run uninterrupted, and with `checkpoint` stopped and rerun;
    the two results bit for bit. Returns (uninterrupted, resumed)."""
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    one = write_model(str(tmp_path / "one"), n, kind="eqdust", nfreq=nfreq,
                      extra=extra, **kw)
    ini = write_model(str(tmp_path / "ck"), n, kind="eqdust", nfreq=nfreq,
                      extra=extra + "checkpoint ck.npz\n", **kw)
    ref = tdriver.run(one, device=CPU, lanes=LANES)
    stops = resume_until_done(monkeypatch, ini, after)
    assert stops >= min_stops
    res = tdriver.run(ini, device=CPU, lanes=LANES)
    same_run(res, ref)
    return ref, res


# ---- the file


def _cfg(tmp_path, extra=""):
    return RunConfig(write_model(str(tmp_path), 4, kind="eqdust", nfreq=6,
                                 extra=extra))


def test_fingerprint_ignores_checkpoint_lines_only(tmp_path):
    a = ck.fingerprint_of(_cfg(tmp_path / "a", "checkpoint x.npz 3\n"))
    b = ck.fingerprint_of(_cfg(tmp_path / "b", "verbose 1\n"))
    c = ck.fingerprint_of(_cfg(tmp_path / "c", "seed 0.5\n"))
    assert a == b != c and a.startswith(ck.FORMAT + ":")
    assert ck.fingerprint_of(_cfg(tmp_path / "a"), "mesh") != a


def test_stale_file_starts_fresh(tmp_path, capsys):
    path = str(tmp_path / "c.npz")
    c = ck.RunCheckpoint(path, 1, "one", nfreq=3)
    c.record("bg", dict(escaped=np.ones(3)), tabs=torch.ones(4))
    c2 = ck.RunCheckpoint(path, 1, "one", nfreq=3)
    assert c2.completed("bg") and c2.vectors("bg")["escaped"].sum() == 3
    np.testing.assert_array_equal(c2.saved("tabs"), np.ones(4))
    tabs, intf = c2.restore(None, "fresh")
    np.testing.assert_array_equal(tabs, np.ones(4))
    assert intf is None and c2.restore_roi("fresh") == "fresh"
    c3 = ck.RunCheckpoint(path, 1, "two", nfreq=3)
    assert "configuration changed" in capsys.readouterr().err
    assert c3.done == [] and c3.saved("tabs") is None
    assert c3.restore("t", "i") == ("t", "i")


def test_every_n_and_record_many(tmp_path):
    path = str(tmp_path / "c.npz")
    c = ck.RunCheckpoint(path, 3, "f", nfreq=2)
    c.record("a", None, tabs=torch.zeros(2))
    c.record("b", None, tabs=torch.ones(2))
    assert not os.path.exists(path) and c.pending
    c.record_many(["c", "d"], [None, dict(missed=np.ones(2))],
                  tabs=torch.full((2,), 2.0))
    assert not c.pending
    r = ck.RunCheckpoint(path, 3, "f", nfreq=2)
    assert r.done == ["a", "b", "c", "d"]
    assert r.vectors("d")["missed"].tolist() == [1.0, 1.0]
    np.testing.assert_array_equal(r.saved("tabs"), [2.0, 2.0])
    assert len(c.flushes) == 1 and c.flushes[0][1] == os.path.getsize(path)


def test_held_unit_is_a_snapshot(tmp_path):
    """At every 2 a recorded tally that is then added to in place (as the
    transport's index_add_ does) is written as it was when recorded."""
    path = str(tmp_path / "c.npz")
    c = ck.RunCheckpoint(path, 2, "f", nfreq=1)
    tabs = torch.ones(5)
    host = np.ones((5, 1), np.float32)
    c.record("a", None, tabs=tabs, intf=host)
    tabs.add_(10.0)
    host += 10.0
    c.flush()
    r = ck.RunCheckpoint(path, 2, "f", nfreq=1)
    np.testing.assert_array_equal(r.saved("tabs"), np.ones(5))
    np.testing.assert_array_equal(r.saved("intf"), np.ones((5, 1)))


def test_kill_while_writing_keeps_the_last_file(tmp_path, monkeypatch):
    """Only os.replace makes a checkpoint visible: a write that dies
    part-way leaves the previous file readable."""
    path = str(tmp_path / "c.npz")
    c = ck.RunCheckpoint(path, 1, "f", nfreq=1)
    c.record("a", None, tabs=torch.ones(3))

    def dies(fp, **arrays):
        fp.write(b"PK\x03\x04 half a file")
        raise Stop()

    monkeypatch.setattr(ck.np, "savez", dies)
    with pytest.raises(Stop):
        c.record("b", None, tabs=torch.zeros(3))
    monkeypatch.undo()
    r = ck.RunCheckpoint(path, 1, "f", nfreq=1)
    assert r.done == ["a"]
    np.testing.assert_array_equal(r.saved("tabs"), np.ones(3))


# ---- phase 1, resumed bit for bit


def test_background_roi_save_resumes(tmp_path, monkeypatch, capsys):
    """The background and the sky with the ROI save's crossing tally:
    the resumed run skips the background by name and writes the same ROI
    tally."""
    ref, res = resumed_against_uninterrupted(
        tmp_path, monkeypatch, 1, hpbg=2,
        extra="roi 1 4 1 4 1 4\nroisave roi.bin 1\n")
    assert "skipping completed unit bg" in capsys.readouterr().err
    assert res.roi_tally.sum() > 0
    assert [st["restored"] for st in res.source_passes] == [True, True]
    assert [st["seconds"] for st in res.source_passes] == [0.0, 0.0]


def test_healpix_sky_reports_full_injected(tmp_path, monkeypatch):
    """soc_tpu's test_hpbg_resume_reports_full_injected: a skipped sky
    pass still reports its whole injected, escaped and launched."""
    ref, res = resumed_against_uninterrupted(
        tmp_path, monkeypatch, 1, hpbg=2, hpbg_weighted=True,
        point_sources=SOURCES, pspackets=400)
    sky = [st for st in res.source_passes if st["source"] == "hpbg"][0]
    assert sky["restored"] and sky["injected"].sum() > 0
    np.testing.assert_array_equal(sky["launched"],
                                  ref.source_passes[1]["launched"])


def test_point_sources_close_the_balance(tmp_path, monkeypatch):
    """Point sources (PS_METHOD 4 for the external one) after a resumed
    background: the balance with the born-outside weight closes as in the
    uninterrupted run."""
    ref, res = resumed_against_uninterrupted(
        tmp_path, monkeypatch, 1, point_sources=SOURCES, pspackets=600,
        ps_method=4)
    on = res.launched > 0
    bal = (res.absorbed_photons + res.escaped + res.missed)[on] \
        / res.launched[on] - 1
    assert np.abs(bal).max() < 1e-5 and res.missed.sum() > 0


def test_diffuse_field_resumes(tmp_path, monkeypatch):
    resumed_against_uninterrupted(tmp_path, monkeypatch, 1, diffuse=0.5,
                                  hpbg=2)


def test_mmapabs_blocks_resume(tmp_path, monkeypatch):
    """`mmapabs` in blocks of 4 channels (SOC_TPU_TALLY_BYTES): a unit a
    block, keyed by its first channel, with the memmap as the tally."""
    ref, res = resumed_against_uninterrupted(
        tmp_path, monkeypatch, 2, extra="mmapabs\n", hpbg=2, min_stops=2,
        env={"SOC_TPU_TALLY_BYTES": str(216 * 4 * 4)})
    assert res.checkpoint.completed("bg/f4") \
        and res.checkpoint.completed("hpbg/f8")
