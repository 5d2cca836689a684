"""soc_tpu_torch's CLI verbs against soc_tpu's CLI on the same files:
a2e_pre, dust, a2e (nstoch / IFREQ / aalg, and the streamed solve against
the in-memory one), eqsolve, a2e_lib, mabu (ofreq, mapum, remit),
sampleini, --profile and the `bench` verb's dispatch. Inputs come from
example_model and numpy seeds.

Tolerances: a2e_pre, dust, eqsolve and sampleini are host NumPy copies
of soc_tpu's: their files are held bit for bit. The A2E solve on the CPU
is the plain twin of the CUDA kernel against soc_tpu's XLA solve, rtol
2e-5 as in tests/test_torch_a2e.py (over the entries above 1e-6 of the
maximum); the streamed solve equals the in-memory one bit for bit, as
soc_tpu's test_streaming_solve_matches_in_memory demands. The library's
files follow soc_tpu's test_a2e_lib_cli (tests/test_library.py:200-266).
"""

import os
import sys

import numpy as np
import pytest
import torch

from soc_tpu import cli as jcli
from soc_tpu.io.fields import read_cell_frequency_array, \
    write_cell_frequency_array
from soc_tpu.solve import stochastic as jsto
from soc_tpu.solve.solver_file import write_solver

from soc_tpu_torch import cli
from soc_tpu_torch.constants import um2f
from soc_tpu_torch.example_model import (GRAIN_LINE, _dustem_files,
                                         frequencies, write_model)
from soc_tpu_torch.solve import stochastic as tsto
from soc_tpu_torch.solve.solver_file import read_solver

sys.path.insert(0, "tests")
from test_a2e import random_solver  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
DEV = ["--device", "cpu"]


def _bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


def _a2e_close(got, want):
    sel = want > 1e-6 * want.max()
    np.testing.assert_allclose(got[sel], want[sel], rtol=2e-5)


@pytest.fixture()
def solver_files(tmp_path, monkeypatch):
    """soc_tpu's random solver written to d.solver, and an absorbed file;
    soc_tpu solves on its XLA path."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    sol = random_solver(ne=16, nfreq=8, nsize=3, seed=7)
    sol.size_a[:] = [1e-7, 1e-6, 1e-5]
    write_solver(tmp_path / "d.solver", sol)
    np.savetxt(tmp_path / "freq.dat", np.asarray(sol.freq, np.float64))
    rng = np.random.default_rng(4)
    absorbed = (10.0 ** rng.uniform(-2, 2, (400, 1))
                * rng.uniform(0.5, 1.5, (400, 8))).astype(np.float32)
    write_cell_frequency_array(tmp_path / "abs.bin", absorbed)
    return sol, absorbed


def test_a2e_pre_bit_equal(tmp_path, monkeypatch):
    write_model(str(tmp_path), 4, kind="gset", nfreq=8, nsize=4)
    monkeypatch.chdir(tmp_path)
    np.savetxt("freq.dat", frequencies(8))
    assert cli.main(["a2e_pre", "gs_TST.dust", "freq.dat", "t.solver",
                     "16"]) == 0
    assert jcli.main(["a2e_pre", "gs_TST.dust", "freq.dat", "j.solver",
                      "16"]) == 0
    assert _bytes("t.solver") == _bytes("j.solver")


def test_dust_bit_equal(tmp_path, monkeypatch):
    names = ("TST_simple.dust", "TST.dsc", "gs_TST.dust", "gs_TST.opt",
             "gs_TST.ent", "gs_TST.size", "TST.solver", "tmp.dust",
             "tmp.dsc")
    for d in ("t", "j"):
        os.makedirs(tmp_path / d)
        _dustem_files(str(tmp_path / d),
                      np.logspace(np.log10(0.1), np.log10(3000.0), 10))
        (tmp_path / d / "GRAIN.DAT").write_text(
            "# grains\n%s\n" % GRAIN_LINE.format(nsize=4))
        np.savetxt(tmp_path / d / "freq.dat", frequencies(10))
    monkeypatch.chdir(tmp_path / "t")
    assert cli.main(["dust", "GRAIN.DAT", "freq.dat", "16", "0.01"]) == 0
    monkeypatch.chdir(tmp_path / "j")
    assert jcli.main(["dust", "GRAIN.DAT", "freq.dat", "16", "0.01"]) == 0
    for n in names:
        assert _bytes(tmp_path / "t" / n) == _bytes(tmp_path / "j" / n), n


@pytest.mark.parametrize("rest", [[], ["0", "2"], ["GPU", "999", "5"],
                                  ["1", "999", "-1", "aalg"],
                                  ["0", "999", "3", "aalg"]])
def test_a2e_matches_soc_tpu(tmp_path, solver_files, rest):
    """The a2e verb's argument list (GPU ignored; nstoch; IFREQ, -1 for all
    columns; aalg with <emitted>.P) against soc_tpu's verb."""
    sol, absorbed = solver_files
    if "aalg" in rest:
        aalg = np.exp(np.random.default_rng(2).uniform(
            np.log(3e-8), np.log(3e-5), 400)).astype(np.float32)
        with open(tmp_path / "aalg.bin", "wb") as fp:
            np.int32(400).tofile(fp)
            aalg.tofile(fp)
        rest = rest[:-1] + [str(tmp_path / "aalg.bin")]
    files = [str(tmp_path / "d.solver"), str(tmp_path / "abs.bin")]
    assert cli.main(["a2e", *files, str(tmp_path / "t.bin"), *rest]
                    + DEV) == 0
    assert jcli.main(["a2e", *files, str(tmp_path / "j.bin"), *rest]) == 0
    outs = ["t.bin", "j.bin"]
    if len(rest) > 3:
        outs += ["t.bin.P", "j.bin.P"]
    for t, j in zip(outs[::2], outs[1::2]):
        got = read_cell_frequency_array(tmp_path / t)
        want = read_cell_frequency_array(tmp_path / j)
        ncol = 1 if len(rest) > 2 and int(rest[2]) >= 0 else 8
        assert got.shape == want.shape == (400, ncol)
        _a2e_close(got, want)


def test_a2e_aalg_count_mismatch_refused(tmp_path, solver_files):
    with open(tmp_path / "aalg.bin", "wb") as fp:
        np.int32(10).tofile(fp)
        np.ones(10, np.float32).tofile(fp)
    with pytest.raises(SystemExit, match="aalg file has 10 entries"):
        cli.main(["a2e", str(tmp_path / "d.solver"),
                  str(tmp_path / "abs.bin"), str(tmp_path / "t.bin"), "0",
                  "999", "-1", str(tmp_path / "aalg.bin")] + DEV)


@pytest.mark.parametrize("batch", [128, 256, 1 << 16])
def test_streamed_solve_equals_in_memory(tmp_path, solver_files, batch):
    """tests/test_a2e.py:176 on the port: the native reader/writer in
    chunks of ``batch`` rows, bit for bit the in-memory solve, with and
    without aalg."""
    _, absorbed = solver_files
    sol = read_solver(str(tmp_path / "d.solver"))
    ref = tsto.solve_emission(sol, absorbed, CPU)
    rows = tsto.solve_emission_streaming(
        sol, tmp_path / "abs.bin", tmp_path / "e.bin", CPU, batch=batch)
    assert rows == 400
    np.testing.assert_array_equal(
        read_cell_frequency_array(tmp_path / "e.bin"), ref)
    aalg = np.full(400, 3e-6, np.float32)
    em, pem = tsto.solve_emission(sol, absorbed, CPU, aalg=aalg)
    tsto.solve_emission_streaming(
        sol, tmp_path / "abs.bin", tmp_path / "e2.bin", CPU, batch=batch,
        aalg=aalg, pemitted_path=tmp_path / "e2.bin.P", ifreq=5)
    np.testing.assert_array_equal(
        read_cell_frequency_array(tmp_path / "e2.bin"), em[:, 5:6])
    np.testing.assert_array_equal(
        read_cell_frequency_array(tmp_path / "e2.bin.P"), pem[:, 5:6])


def test_streamed_solve_against_soc_tpu(tmp_path, solver_files):
    sol, absorbed = solver_files
    tsto.solve_emission_streaming(
        read_solver(str(tmp_path / "d.solver")), tmp_path / "abs.bin",
        tmp_path / "t.bin", CPU, batch=96)
    jsto.solve_emission_streaming(sol, tmp_path / "abs.bin",
                                  tmp_path / "j.bin", batch=96)
    _a2e_close(read_cell_frequency_array(tmp_path / "t.bin"),
               read_cell_frequency_array(tmp_path / "j.bin"))


def test_stream_reader_and_writer(tmp_path):
    """The native reader yields the file's rows in chunks; the writer's
    file reads back; a missing file raises."""
    from soc_tpu_torch.native import StreamReader, StreamWriter
    data = np.random.default_rng(0).random((1000, 7)).astype(np.float32)
    with StreamWriter(tmp_path / "x.bin", 1000, 7) as wr:
        for i in range(0, 1000, 300):
            wr.put(data[i:i + 300])
    with StreamReader(tmp_path / "x.bin", 256) as rd:
        assert (rd.rows, rd.cols) == (1000, 7)
        chunks = list(rd)
    assert [len(c) for c in chunks] == [256, 256, 256, 232]
    np.testing.assert_array_equal(np.concatenate(chunks), data)
    np.testing.assert_array_equal(read_cell_frequency_array(
        tmp_path / "x.bin"), data)
    with pytest.raises(IOError):
        StreamReader(tmp_path / "missing.bin", 16)


def test_eqsolve_bit_equal(tmp_path, monkeypatch):
    write_model(str(tmp_path), 4, kind="eqdust", nfreq=8)
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(1)
    write_cell_frequency_array("abs.bin", (10.0 ** rng.uniform(
        -3, 1, (64, 1)) * rng.uniform(0.5, 1.5, (64, 8))).astype(np.float32))
    assert cli.main(["eqsolve", "tst.dust", "abs.bin", "t.bin"]) == 0
    t_temp = _bytes("tst.dust.T")
    assert jcli.main(["eqsolve", "tst.dust", "abs.bin", "j.bin", "0"]) == 0
    assert _bytes("t.bin") == _bytes("j.bin")
    assert t_temp == _bytes("tst.dust.T")
    temp = np.fromfile("tst.dust.T", np.float32)
    assert temp.shape == (64,) and np.isfinite(temp).all()


def test_a2e_lib_matches_soc_tpu(tmp_path):
    """tests/test_library.py:200-266 on the port and against soc_tpu's
    verb: makelib equals the real solve; uselib answers from the library
    with all columns or only the 3 reference ones; ofreq selects
    columns."""
    sol = random_solver(ne=16, nfreq=8, nsize=1, seed=7)
    write_solver(tmp_path / "d.solver", sol)
    freq = np.asarray(sol.freq)
    np.savetxt(tmp_path / "freq.dat", freq)
    np.savetxt(tmp_path / "lfreq.dat", freq[[1, 4, 6]])
    np.savetxt(tmp_path / "ofreq.dat", freq[[2, 5]])
    rng = np.random.default_rng(4)
    absorbed = (10.0 ** rng.uniform(-2, 2, (400, 1))
                * rng.uniform(0.5, 1.5, (400, 8))).astype(np.float32)
    write_cell_frequency_array(tmp_path / "abs.bin", absorbed)
    write_cell_frequency_array(tmp_path / "abs_red.bin",
                               np.ascontiguousarray(absorbed[:, [1, 4, 6]]))
    p = lambda n: str(tmp_path / n)             # noqa: E731
    head = [p("d.solver")]
    tail = [p("freq.dat"), p("lfreq.dat")]
    for tag, main, extra in (("t", cli.main, DEV), ("j", jcli.main, [])):
        lib = p("%s.lib" % tag)
        assert main(["a2e_lib", *head, lib, *tail, p("abs.bin"),
                     p(tag + "_full.bin"), "makelib", "bins-45-25-15"]
                    + extra) == 0
        assert main(["a2e_lib", *head, lib, *tail, p("abs.bin"),
                     p(tag + "_lib.bin")] + extra) == 0
        assert main(["a2e_lib", *head, lib, *tail, p("abs_red.bin"),
                     p(tag + "_red.bin"), "0"] + extra) == 0
        assert main(["a2e_lib", *head, lib, *tail, p("abs.bin"),
                     p(tag + "_sel.bin"), p("ofreq.dat")] + extra) == 0
    read = lambda n: read_cell_frequency_array(p(n))   # noqa: E731
    ref = tsto.solve_emission(read_solver(p("d.solver")), absorbed, CPU)
    np.testing.assert_array_equal(read("t_full.bin"), ref)
    _a2e_close(read("t_full.bin"), read("j_full.bin"))
    lib_out = read("t_lib.bin")
    assert lib_out.shape == (400, 8)
    rel = np.abs(lib_out.sum(1) - ref.sum(1)) / ref.sum(1)
    assert np.median(rel) < 0.25
    np.testing.assert_allclose(read("t_red.bin"), lib_out, rtol=1e-6)
    np.testing.assert_allclose(read("t_sel.bin"), lib_out[:, [2, 5]],
                               rtol=1e-6)
    # the same bins as soc_tpu's library in at least 99% of the cells
    # (two float32 solves, one bin edge apart at most)
    for n in ("lib", "red"):
        same = np.all(np.isclose(read("t_%s.bin" % n), read("j_%s.bin" % n),
                                 rtol=2e-5), axis=1)
        assert same.mean() > 0.99, (n, same.mean())
    bad = [*head, p("t.lib"), p("freq.dat"), p("ofreq.dat"), p("abs.bin"),
           p("x.bin")]
    with pytest.raises(SystemExit, match="exactly 3"):
        cli.main(["a2e_lib", *bad] + DEV)


@pytest.mark.parametrize("extra,ofreq", [("", False), ("", True),
                                         ("mapum 100.0 250.0\n", False),
                                         ("remit 30.0 1000.0\n", False),
                                         ("polarisation\n", False)])
def test_mabu_matches_soc_tpu(tmp_path, monkeypatch, extra, ofreq):
    """The mabu verb on an absorbed file: two GSET dusts with abundances,
    the output columns from an ofreq file, `mapum` or `remit`, and with
    `polarisation` the <emitted>.P file."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    kw = dict(kind="gset", nfreq=8, nsize=4, abundance=True,
              polarisation=extra == "polarisation\n",
              extra="nenumber 16\n" + ("" if "polar" in extra else extra))
    write_model(str(tmp_path), 4, **kw)
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(6)
    absorbed = (10.0 ** rng.uniform(-2, 1, (64, 1))
                * rng.uniform(0.5, 1.5, (64, 8))).astype(np.float32)
    absorbed[5] = -1e20                       # a parent row stays zero
    write_cell_frequency_array("abs.bin", absorbed)
    args = ["run.ini", "abs.bin"]
    sel = []
    if ofreq:
        np.savetxt("ofreq.dat", frequencies(8)[[2, 5]])
        sel = ["ofreq.dat"]
    assert cli.main(["mabu", *args, "t.bin", *sel] + DEV) == 0
    assert jcli.main(["mabu", *args, "j.bin", *sel]) == 0
    got, want = read_cell_frequency_array("t.bin"), \
        read_cell_frequency_array("j.bin")
    ncol = {False: 8, True: 2}[ofreq]
    if "mapum" in extra:
        ncol = 2
    if "remit" in extra:
        ncol = int(((frequencies(8) >= um2f(1000.0))
                    & (frequencies(8) <= um2f(30.0))).sum())
    assert got.shape == want.shape == (64, ncol)
    assert (got[5] == 0).all()
    _a2e_close(got, want)
    if "polar" in extra:
        _a2e_close(read_cell_frequency_array("t.bin.P"),
                   read_cell_frequency_array("j.bin.P"))


def test_sampleini_identical(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["sampleini", "t.ini"]) == 0
    assert jcli.main(["sampleini", "j.ini"]) == 0
    assert _bytes("t.ini") == _bytes("j.ini")
    assert cli.main(["sampleini"]) == 0 and os.path.exists("sample.ini")


def test_profile_writes_a_trace(tmp_path, monkeypatch, solver_files):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["a2e", "d.solver", "abs.bin", "t.bin",
                     "--profile=prof"] + DEV) == 0
    trace = tmp_path / "prof" / "trace_a2e.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert cli.main(["--profile", "sampleini", "s.ini"]) == 0
    assert (tmp_path / "soc_profile" / "trace_sampleini.json").exists()


def test_bench_refused_and_usage(capsys, monkeypatch):
    """The `bench` verb, once refused, dispatches to
    soc_tpu_torch.bench.main (a stub here) with the --device given, its
    result in results['bench']; the usage text lists it; a verb the CLI
    does not know, or too few arguments, prints the usage and exits 1."""
    from soc_tpu_torch import bench
    calls = []

    def stub(device=None):
        calls.append(device)
        return {"metric": "stub"}
    monkeypatch.setattr(bench, "main", stub)
    results = {}
    assert cli.main(["bench", "--device", "cpu"], results) == 0
    assert [str(d) for d in calls] == ["cpu"]
    assert results["bench"] == {"metric": "stub"}
    capsys.readouterr()
    for argv in ([], ["nosuchverb"], ["a2e", "x"], ["a2e_lib", "a", "b"]):
        assert cli.main(argv) == 1
    assert "python -m soc_tpu_torch bench" in capsys.readouterr().out


def test_cuda_verbs_need_a_card(tmp_path, monkeypatch):
    """Without CUDA a verb that computes on tensors exits 2 under the
    default --device cuda; the host verbs do not ask for a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for verb in ("a2e", "a2e_lib", "mabu", "pipeline", "rt", "sca"):
        assert cli.main([verb] + ["x"] * 6) == 2, verb
    monkeypatch.chdir(tmp_path)
    assert cli.main(["sampleini", "s.ini"]) == 0
