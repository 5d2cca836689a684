"""The whole slice through both packages on the same inputs: `rt` (an
equilibrium dust) and `pipeline` (a stochastic GSET dust: absorption run
-> A2E -> map), comparing absorbed.data, emitted.data, tmp.T and
map_dir_00.bin; plus the port's guarantees: no jax import, the keywords
it once refused run (`domains` held to the one-device run by soc_tpu's
rule for domain runs, test_torch_domain.held), other CLI verbs exit
non-zero.

Tolerances: packets follow the same paths in both packages except for the
rare packet that XLA's own exp/log/cos/sin send across another boundary
(see test_torch_transport.py). Per-frequency totals are held at 2e-3,
per-cell fields at 1e-4 for 99% of the entries, temperatures at 1e-4.
"""

import os
import subprocess
import sys
import warnings

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


def test_cli_rt_on_cpu_and_verbs(tmp_path, capsys, monkeypatch):
    """`rt` through the CLI on the CPU; the host verbs given too few
    arguments fail; `bench` (refused before it was ported) reaches
    soc_tpu_torch.bench.main, a stub here."""
    from soc_tpu_torch import bench
    ini = write_model(str(tmp_path), 6, kind="eqdust", nfreq=8)
    assert cli.main(["rt", ini, "--device", "cpu", "--lanes", "2048"]) == 0
    assert "soc_tpu_torch rt done" in capsys.readouterr().out
    assert (tmp_path / "tmp.T").exists()
    for verb in ("eqsolve", "a2e", "mabu", "dust"):
        assert cli.main([verb, ini]) != 0
    calls = []
    monkeypatch.setattr(bench, "main",
                        lambda device=None: calls.append(str(device)))
    assert cli.main(["bench", "--device", "cpu"]) == 0
    assert calls == ["cpu"]
    assert cli.main([]) != 0


def test_rt_absorbed_file_takes_no_tensor_array(tmp_path, monkeypatch):
    """`rt` with the absorbed file (noabsorbed 0) on the CPU turns the
    tally into a host array without Tensor.__array__ (np.array(tensor,
    dtype), which NumPy 2 warns about: its `copy` keyword), under
    DeprecationWarnings made errors."""
    ini = write_model(str(tmp_path), 6, kind="eqdust", nfreq=8)

    def no_array(self, *args, **kw):
        raise DeprecationWarning("Tensor.__array__ called")
    monkeypatch.setattr(torch.Tensor, "__array__", no_array)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        res = tdriver.run(ini, device=CPU, lanes=2048)
    assert res.absorbed.shape == (216, 8)
    assert (tmp_path / "absorbed.data").exists()


def test_unsupported_keywords_raise(tmp_path):
    """`domains 2`, which raised before parallel/domain.py was ported,
    runs over two CPU slabs and matches the one-device run."""
    from test_torch_domain import held
    one = tdriver.run(write_model(str(tmp_path / "one"), 4, kind="eqdust",
                                  nfreq=6), device=CPU, lanes=1024)
    ini = write_model(str(tmp_path / "dom"), 4, kind="eqdust", nfreq=6,
                      extra="domains 2\n")
    dom = tdriver.run(ini, device=CPU, lanes=1024)
    assert dom.domains == [CPU] * 2
    assert [st["route"] for st in dom.source_passes] == ["domains"]
    for name in ("ctabs", "absorbed", "temperature", "emitted"):
        held(getattr(dom, name), getattr(one, name), name)


@pytest.mark.parametrize("name,devices,kw", [
    ("hpbg", 2, dict(hpbg=2)),
    ("mirror", 2, dict(extra="mirror xy\n")),
    ("roi", 2, dict(extra="roi 1 2 1 2 1 2\nroisave roi.bin\n")),
    ("roiload", 2, dict(roiload=True)),
    ("pointsource", 2, dict(point_sources=[(2.1, 1.9, 2.2, 1.0)],
                            pspackets=100)),
    ("direweight", 2, dict(extra="direweight 0 0.5\n")),
    ("cell emission", 2, dict(cellpackets=640, iterations=2)),
    ("stepweight", 2, dict(extra="stepweight 1 0.5\n")),
    ("split", 2, dict(split=8)),
    ("checkpoint", None, dict(extra="checkpoint c.ckpt\n")),
    ("checkpoint devices", 2, dict(extra="checkpoint c.ckpt\n")),
    ("mmapabs", 2, dict(extra="mmapabs\n"))])
def test_formerly_refused_keywords_run(tmp_path, name, devices, kw):
    """Each keyword that raised before runs (under `devices 2` on CPU
    shards, `checkpoint` also on one device) and matches the one-device
    run without it (test_torch_product_features.mesh_vs_one)."""
    from test_torch_product_features import mesh_vs_one
    one, other = mesh_vs_one(tmp_path, devices=devices, **kw)
    if "checkpoint" in name:
        assert other.checkpoint is not None
        assert os.path.exists(tmp_path / "mesh" / "c.ckpt")
        if devices is None:
            # one device: the same tallies bit for bit
            np.testing.assert_array_equal(other.absorbed, one.absorbed)


@pytest.mark.parametrize("name,kw", [
    ("roisave", dict(extra="roi 1 2 1 2 1 2\nroisave roi.bin\n")),
    ("roiload", dict(roiload=True)),
    ("mirror", dict(extra="mirror xyz\n")),
    ("stepweight", dict(extra="stepweight 2 1.3 0.4\n")),
    ("direweight", dict(extra="direweight 1 0.5\n")),
    ("mmapabs", dict(extra="mmapabs\n")),
    ("together", dict(extra="stepweight 1 1.4\ndireweight 1 0.5\n"
                            "mirror x\nmmapabs\n")),
    # the maps render on the first shard's device
    ("maps", dict(extra="roi 1 2 1 2 1 2\nroimap\nsavetau t.bin 250.0\n"
                        "mapint 1\ninterpolate 2\nyshear 1.0\nFITS 1\n"
                        "perspective 4 4 4\npssavetau p.txt\n"
                        "mapping 4 0 1.0 999\n"))])
def test_mesh_runs_the_transport_keywords(tmp_path, name, kw):
    """Each transport keyword of the ROI / mirror / weighting / mmapabs
    slice runs under `devices 4` (dp 2 x freq 2) and matches the
    one-device run over the four devices, every pass on the mesh's route;
    with the map keywords the maps render."""
    from test_torch_product_features import mesh_vs_one
    one, mesh = mesh_vs_one(tmp_path, devices=4, **kw)
    assert len(mesh.devices) == 4 and one.devices is None
    assert mesh.source_passes
    assert all(st["route"] == "mesh" for st in mesh.source_passes)
    assert all(st["mesh"] for st in mesh.cell_passes)
    if name == "maps":
        assert mesh.render_passes and one.render_passes


def test_octree_raises(tmp_path):
    """A 2-level cloud runs (the octree is ported: tests/test_torch_phase2*
    hold it to soc_tpu); the pipeline's makelib mode with `domains 2`
    (which raised before parallel/domain.py was ported) runs over two CPU
    slabs and matches the one-device makelib run."""
    from test_torch_domain import held
    from soc_tpu.grid import encode_link_np
    from soc_tpu_torch.io.cloud import write_hierarchy
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=6)
    root = np.ones(64, np.float32)
    root[0] = encode_link_np(0)
    write_hierarchy(tmp_path / "tmp.cloud", 4, 4, 4, [64, 8],
                    [root, np.ones(8, np.float32)])
    res = tdriver.run(ini, device=CPU, lanes=1024)
    assert res.grid.levels == 2 and res.temperature.shape == (72,)
    assert np.isfinite(res.maps[0]).all() and res.maps[0].max() > 0
    runs = {}
    for name in ("one", "dom"):
        if name == "dom":
            with open(ini, "a") as fp:
                fp.write("domains 2\n")
        runs[name] = tfull.run_pipeline(ini, device=CPU, mode="makelib",
                                        lanes=1024)
    assert runs["dom"][0].domains == [CPU] * 2
    held(runs["dom"][1], runs["one"][1], "makelib emitted")


def test_port_runs_without_jax(tmp_path):
    """The port never imports jax (nor jaxlib, flax or optax): a subprocess
    with them blocked imports every module of the package and runs a tiny
    `rt`."""
    code = """
import sys, pkgutil, importlib
for m in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[m] = None
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
