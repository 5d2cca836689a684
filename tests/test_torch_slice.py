"""The whole slice through both packages on the same inputs: `rt` (an
equilibrium dust) and `pipeline` (a stochastic GSET dust: absorption run
-> A2E -> map), comparing absorbed.data, emitted.data, tmp.T and
map_dir_00.bin; plus the port's guarantees: no jax import, unsupported
keywords raise, other CLI verbs exit non-zero.

Tolerances: packets follow the same paths in both packages except for the
rare packet that XLA's own exp/log/cos/sin send across another boundary
(see test_torch_transport.py). Per-frequency totals are held at 2e-3,
per-cell fields at 1e-4 for 99% of the entries, temperatures at 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from soc_tpu.pipeline import driver as jdriver
from soc_tpu.pipeline import full as jfull

from soc_tpu_torch import cli
from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.pipeline import full as tfull

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    return np.fromfile(path, np.float32)


def _fields(d, names):
    return {n: _read(os.path.join(d, n)) for n in names}


def _close_fields(t, j, name, ncol):
    if name == "tmp.T":
        np.testing.assert_allclose(t, j, rtol=1e-4)
        return
    np.testing.assert_array_equal(t[:2], j[:2])      # int32 headers
    a, b = t[2:].reshape(-1, ncol), j[2:].reshape(-1, ncol)
    # atol: XLA rewrites a / b / c as a / (b * c), which underflows the
    # coldest channels' emission to 0 where torch keeps ~1e-18 of the peak
    np.testing.assert_allclose(a.sum(0), b.sum(0), rtol=2e-3,
                               atol=1e-12 * np.abs(b.sum(0)).max())
    close = np.isclose(a, b, rtol=1e-4, atol=1e-7 * np.abs(b).max())
    assert close.mean() > 0.99, (name, close.mean())


def test_rt_matches_soc_tpu(tmp_path):
    names = ("absorbed.data", "emitted.data", "tmp.T", "map_dir_00.bin")
    ini_t = write_model(str(tmp_path / "t"), 8, kind="eqdust", nfreq=12)
    ini_j = write_model(str(tmp_path / "j"), 8, kind="eqdust", nfreq=12)
    rt = tdriver.run(ini_t, device=CPU, lanes=LANES)
    rj = jdriver.run(ini_j, lanes=LANES)
    ft, fj = _fields(tmp_path / "t", names), _fields(tmp_path / "j", names)
    for n in names:
        _close_fields(ft[n], fj[n], n, 12 if n != "map_dir_00.bin" else 64)
    np.testing.assert_allclose(rt.escaped, rj.escaped, rtol=2e-3)
    np.testing.assert_array_equal(rt.injected, rj.injected)
    # energy balance of the port, per frequency
    np.testing.assert_allclose(rt.absorbed_photons + rt.escaped,
                               rt.injected, rtol=1e-4)
    assert 3.0 < rt.temperature.min() and rt.temperature.max() < 100.0


def test_pipeline_matches_soc_tpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    names = ("absorbed.data", "emitted.data", "map_dir_00.bin")
    kw = dict(kind="gset", nfreq=16, nsize=6, extra="nenumber 32\n")
    ini_t = write_model(str(tmp_path / "t"), 6, **kw)
    ini_j = write_model(str(tmp_path / "j"), 6, **kw)
    rt, em_t, rm = tfull.run_pipeline(ini_t, device=CPU, lanes=LANES)
    jfull.run_pipeline(ini_j, lanes=LANES)
    ft, fj = _fields(tmp_path / "t", names), _fields(tmp_path / "j", names)
    for n in names:
        _close_fields(ft[n], fj[n], n, 16 if n != "map_dir_00.bin" else 36)
    assert (tmp_path / "t" / "TST_simple.dust").exists()
    assert (tmp_path / "t" / "gs_TST.solver").exists()
    assert np.isfinite(em_t).all() and em_t.max() > 0
    assert rm.maps[0].shape == (16, 6, 6)


def test_cli_rt_on_cpu_and_verbs(tmp_path, capsys):
    ini = write_model(str(tmp_path), 6, kind="eqdust", nfreq=8)
    assert cli.main(["rt", ini, "--device", "cpu", "--lanes", "2048"]) == 0
    assert "soc_tpu_torch rt done" in capsys.readouterr().out
    assert (tmp_path / "tmp.T").exists()
    for verb in ("sca", "a2e", "mabu", "dust", "bench"):
        assert cli.main([verb, ini]) != 0
    assert cli.main([]) != 0


@pytest.mark.parametrize("extra,name", [
    ("mirror xX\n", "mirror"), ("ali 1\n", "ali"),
    ("reference 1\n", "WITH_REFERENCE"), ("SUBITERATIONS\n", "SUBITER"),
    ("savetau tau 250.0\n", "savetau"), ("mapint 1\n", "mapint"),
    ("perspective 4 4 4\n", "perspective"), ("yshear 1.0\n", "yshear"),
    ("pointsource 3 3 3 ps.bin\n", "pointsource"),
    ("cellpackets 100\niterations 2\n", "cellpackets"),
    ("stepweight 1 0.5\n", "stepweight"), ("split 8\n", "split"),
    ("checkpoint c.ckpt\n", "checkpoint"), ("nnsolve x\n", "nnsolve"),
    ("CR_HEATING 1\n", "CR_HEATING"), ("polmap 1\n", "polmap"),
    ("mmapabs\n", "mmapabs"), ("devices 2\n", "devices")])
def test_unsupported_keywords_raise(tmp_path, extra, name):
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=6, extra=extra)
    with pytest.raises(NotImplementedError, match=name):
        tdriver.run(ini, device=CPU, lanes=1024)


def test_octree_raises(tmp_path):
    from soc_tpu.grid import encode_link_np
    from soc_tpu_torch.io.cloud import write_hierarchy
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=6)
    root = np.ones(64, np.float32)
    root[0] = encode_link_np(0)
    write_hierarchy(tmp_path / "tmp.cloud", 4, 4, 4, [64, 8],
                    [root, np.ones(8, np.float32)])
    with pytest.raises(NotImplementedError, match="octree"):
        tdriver.run(ini, device=CPU, lanes=1024)
    with pytest.raises(NotImplementedError, match="makelib"):
        tfull.run_pipeline(ini, device=CPU, mode="makelib")


def test_port_runs_without_jax(tmp_path):
    """The port never imports jax: a subprocess with jax blocked imports
    every module of the package and runs a tiny `rt`."""
    code = """
import sys, pkgutil, importlib
sys.modules["jax"] = None
sys.path.insert(0, %r)
import soc_tpu_torch
for m in pkgutil.walk_packages(soc_tpu_torch.__path__, "soc_tpu_torch."):
    if m.name != "soc_tpu_torch.__main__":
        importlib.import_module(m.name)
from soc_tpu_torch.example_model import write_model
from soc_tpu_torch import cli
ini = write_model(%r, 4, kind="eqdust", nfreq=6)
sys.exit(cli.main(["rt", ini, "--device", "cpu", "--lanes", "1024"]))
""" % (ROOT, str(tmp_path))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "soc_tpu_torch rt done" in out.stdout
    assert (tmp_path / "map_dir_00.bin").exists()
