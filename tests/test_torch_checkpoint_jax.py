"""Checkpoint/resume held to soc_tpu (6^3 cells, 6 channels, the
background and two cell-emission iterations): the port's resumed run
against soc_tpu's uninterrupted run of the same ini, and the two packages'
files refused both ways. soc_tpu's unit is one channel of one source run
as a pool a channel, the port's a mixed pool, so neither resumes the
other's file: each prints "configuration changed ... starting fresh" and
gives its own uninterrupted result.

Tolerances: against soc_tpu as tests/test_torch_phase2.py (XLA's
exp/log/cos/sin differ from torch's by ulps, so a rare packet takes
another path): per-frequency totals at 2e-3, 99% of the per-cell entries
at 1e-4, temperatures at 1e-4. A package against its own uninterrupted
run: bit for bit.
"""

import os
import shutil

import numpy as np
import torch

from soc_tpu.pipeline import driver as jdriver

from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.pipeline import driver as tdriver

from test_torch_checkpoint import (CPU, LANES, resume_until_done,
                                   same_run)
from test_torch_phase2 import NAMES, close_fields

torch.set_num_threads(2)
N, NFREQ = 6, 6
KW = dict(kind="eqdust", nfreq=NFREQ, cellpackets=2 * N ** 3, iterations=2)
CK = "checkpoint ck.npz\n"


def _files(d):
    return {n: np.fromfile(os.path.join(d, n), np.float32) for n in NAMES}


def _close(dt, dj):
    ft, fj = _files(dt), _files(dj)
    for n in NAMES:
        close_fields(ft[n], fj[n], n, N * N if n.startswith("map")
                     else NFREQ)


def test_resumed_port_matches_soc_tpu(tmp_path, monkeypatch, capsys):
    """The port stopped after its background and after the first cell
    pass, then resumed, against soc_tpu's uninterrupted run."""
    it = write_model(str(tmp_path / "t"), N, extra=CK, **KW)
    ij = write_model(str(tmp_path / "j"), N, **KW)
    assert resume_until_done(monkeypatch, it, 1) == 1
    res = tdriver.run(it, device=CPU, lanes=LANES)
    assert "skipping completed unit bg" in capsys.readouterr().err
    rj = jdriver.run(ij, lanes=LANES)
    _close(tmp_path / "t", tmp_path / "j")
    np.testing.assert_allclose(res.escaped, rj.escaped, rtol=2e-3)


def test_foreign_checkpoints_start_fresh(tmp_path, capsys):
    """soc_tpu's finished checkpoint of the same ini, given to the port,
    starts fresh and gives the port's uninterrupted result; the port's,
    given to soc_tpu's driver.run, starts fresh too and gives soc_tpu's
    result with a checkpoint of its own."""
    d = {k: str(tmp_path / k) for k in ("t", "t_foreign", "j",
                                        "j_foreign")}
    ini = {k: write_model(v, N, extra=CK, **KW) for k, v in d.items()}
    jdriver.run(ini["j"], lanes=LANES)          # soc_tpu's own file
    assert os.path.exists(os.path.join(d["j"], "ck.npz"))
    rt = tdriver.run(ini["t"], device=CPU, lanes=LANES)
    capsys.readouterr()
    # soc_tpu's file -> the port
    shutil.copy(os.path.join(d["j"], "ck.npz"), d["t_foreign"])
    rf = tdriver.run(ini["t_foreign"], device=CPU, lanes=LANES)
    assert "configuration changed" in capsys.readouterr().err
    same_run(rf, rt)
    assert "bg/f0" not in rf.checkpoint.done
    # the port's file -> soc_tpu
    shutil.copy(os.path.join(d["t"], "ck.npz"), d["j_foreign"])
    jdriver.run(ini["j_foreign"], lanes=LANES)
    assert "configuration changed" in capsys.readouterr().err
    fj, ff = _files(d["j"]), _files(d["j_foreign"])
    for n in NAMES:
        np.testing.assert_array_equal(ff[n], fj[n])
    with np.load(os.path.join(d["j_foreign"], "ck.npz")) as z:
        assert "bg/f0" in [str(k) for k in z["done"]]
