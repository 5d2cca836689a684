"""`sca` with `devices 8` over several processes on the CPU: two processes
of four CPU shards each run `python -m soc_tpu_torch sca` (cli.main,
through tests/_torch_mp_worker.py) under soc_tpu's variables, against one
process of eight shards (the same ini's `devices 8`) and against soc_tpu's
one-process `devices 8` `sca` (conftest's 8 JAX CPU devices), for
orthographic maps (two directions) and for the Healpix map of the
internal observer, on write_sca_model inputs (an 8^3 cloud, 8 channels,
`simum 0.05 3.0`: three channels simulated, a point source beside the
background).

Tolerances, each with its reason:
  * against one process: every shard traces the same packets and every
    process adds the eight shards' maps in shard order, with one torch
    thread a process, so the maps and outcoming.socs are equal bit for
    bit; process 1 writes no file;
  * against soc_tpu: tests/test_torch_sca_pipeline.py's (XLA's exp, log,
    cos and sin differ from torch's by a few ulps, so a rare packet takes
    another path): each channel's pixels within 1e-4 of its peak but for
    at most 3% of them, its sum within 1e-3.
"""

import os

import numpy as np
import pytest

from soc_tpu_torch.example_model import write_sca_model

from test_torch_multiprocess import LANES, collect, files, ok, start
from test_torch_sca_pipeline import NFREQ, SIMUM, _close_maps

CASES = {
    "ortho": dict(point_sources=[(4.1, 3.9, 4.2, 0.3)], pspackets=2000,
                  extra="directions 70.0 30.0\ndevices 8\n"),
    "healpix": dict(intobs=(4.3, 3.7, 4.1), outnside=4,
                    extra="devices 8\n"),
}


def _model(d, name):
    return write_sca_model(str(d), 8, nfreq=NFREQ, simum=SIMUM,
                           **CASES[name])


def _argv(ini):
    return ["sca", ini, "--device", "cpu", "--lanes", LANES]


@pytest.fixture(scope="module")
def sca_runs(tmp_path_factory):
    """Each case's `sca` in one process of eight CPU shards and in two
    processes of four (each process running both cases, from a directory
    of its own), while soc_tpu's `devices 8` runs in this one."""
    from soc_tpu.pipeline import scattering as jsca
    base = tmp_path_factory.mktemp("mp_sca")
    dirs = {(c, k): base / c / k for c in CASES
            for k in ("one", "r0", "r1", "j")}
    ini = {key: _model(d, key[0]) for key, d in dirs.items()}
    cwds = [base / "cwd0", base / "cwd1"]
    for d in cwds:
        d.mkdir()
    before = {c: files(dirs[(c, "r1")]) for c in CASES}
    procs = start([dict(runs=[_argv(ini[(c, "one")]) for c in CASES])],
                  [base]) \
        + start([dict(runs=[_argv(ini[(c, "r%d" % k)]) for c in CASES])
                 for k in (0, 1)], cwds, nproc=2)
    jmaps = {}
    try:
        for c in CASES:
            jmaps[c] = jsca.run(ini[(c, "j")], nlanes=int(LANES))
    finally:
        runs = ok(collect(procs))
    return dict(dirs=dirs, one=runs[0], ranks=runs[1:], before=before,
                cwd1=cwds[1], jmaps=jmaps)


def test_sca_devices_over_two_processes_equals_one_process(sca_runs):
    """Both processes return the one-process maps bit for bit (the same
    sha256), and process 0's outcoming.socs is the one process's byte for
    byte."""
    ref, ranks = sca_runs["one"], sca_runs["ranks"]
    assert [r["size"] for r in ranks] == [2, 2] and ref["size"] == 1
    for r in ranks:
        assert [x["digests"] for x in r["runs"]] \
            == [x["digests"] for x in ref["runs"]]
    for c in CASES:
        with open(sca_runs["dirs"][(c, "one")] / "outcoming.socs",
                  "rb") as a, \
                open(sca_runs["dirs"][(c, "r0")] / "outcoming.socs",
                     "rb") as b:
            assert a.read() == b.read(), c


def test_sca_devices_only_process_0_writes(sca_runs):
    for c in CASES:
        assert files(sca_runs["dirs"][(c, "r1")]) == sca_runs["before"][c]
        assert "outcoming.socs" in files(sca_runs["dirs"][(c, "r0")])
    assert not os.listdir(sca_runs["cwd1"])


@pytest.mark.parametrize("case", list(CASES))
def test_sca_devices_over_processes_matches_soc_tpu(sca_runs, case):
    """Process 0's outcoming.socs (the maps every process returned)
    against soc_tpu's `devices 8` run's: the header and frequencies
    equal, the three channels of the band lit, the maps within the
    bounds above."""
    raw = {}
    for k in ("r0", "j"):
        with open(sca_runs["dirs"][(case, k)] / "outcoming.socs",
                  "rb") as fp:
            raw[k] = fp.read()
    jmaps = np.asarray(sca_runs["jmaps"][case])
    nhead = 8 if case == "healpix" else 12
    assert raw["r0"][:nhead + 4 * NFREQ] == raw["j"][:nhead + 4 * NFREQ]
    got = np.frombuffer(raw["r0"][nhead + 4 * NFREQ:],
                        np.float32).reshape(jmaps.shape)
    assert np.isfinite(got).all() and (got >= 0).all()
    assert _close_maps(got, jmaps) == 3
