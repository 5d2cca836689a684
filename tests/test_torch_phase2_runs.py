"""The octree and phase 2's other entry points, through both packages on
the same 3-level octree model as tests/test_torch_phase2.py (an 8^3 root,
640 cells, 10 channels): the `reference AABB` continuation, `threshold`,
`cload` / `csave`, `loadtemp`, the octree under a CPU `devices` mesh and
the octree `pipeline`. The runs are split from test_torch_phase2.py so
that the test workers take the two files in parallel.

Tolerances, each with its reason:
  * against soc_tpu: as tests/test_torch_phase2.py (a rare packet takes
    another path: per-frequency totals at 2e-3, 99% of the per-cell
    entries at 1e-4, temperatures at 1e-4);
  * a continued run against one longer run: 2%, soc_tpu's own bound
    (tests/test_iterations.py): the two draw other packets;
  * the port's `devices` mesh against its one-device run: the same
    packets on the same streams, the float32 additions in another order:
    1e-4 relative or 1e-6 of the maximum (tests/test_torch_product.py);
  * a field read back from a file the run wrote: bit for bit.
"""

import os

import numpy as np
import torch

from soc_tpu.pipeline import driver as jdriver
from soc_tpu.pipeline import full as jfull

from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.pipeline import full as tfull

from test_torch_phase2 import (CELLS, LANES, NAMES, NFREQ, OCTREE,
                               check_passes, close_arrays, close_fields,
                               octree_model)

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _file(d, name):
    return np.fromfile(os.path.join(d, name), np.float32)


def _rerun(ini, old, new):
    """The ini again with one line replaced, as a second run's ini."""
    path = os.path.join(os.path.dirname(ini), "run2.ini")
    with open(ini) as fp:
        text = fp.read()
    assert old in text
    with open(path, "w") as fp:
        fp.write(text.replace(old, new))
    return path


def test_reference_aabb_continuation(tmp_path):
    """`reference 400` for iterations 0-1, then `reference 402` for 2-3
    from OEMITTED.save / OTABS.save: against one `reference 402` run of
    four iterations (port against port), and against soc_tpu's chain."""
    full = tdriver.run(octree_model(tmp_path / "full", iterations=4,
                                    extra="reference 402\n"),
                       device=CPU, lanes=LANES)
    assert (tmp_path / "full" / "OEMITTED.save").exists()
    assert (tmp_path / "full" / "OTABS.save").exists()
    out = {}
    for pkg, drv, kw in (("t", tdriver, dict(device=CPU)), ("j", jdriver, {})):
        ini = octree_model(tmp_path / "chain" / pkg, iterations=2,
                           extra="reference 400\n")
        drv.run(ini, lanes=LANES, **kw)
        out[pkg] = drv.run(_rerun(ini, "reference 400", "reference 402"),
                           lanes=LANES, **kw)
    np.testing.assert_allclose(out["t"].temperature, full.temperature,
                               rtol=0.02)
    check_passes(out["t"], 1)
    np.testing.assert_allclose(out["t"].temperature,
                               np.asarray(out["j"].temperature), rtol=1e-4)
    for name, ncol in (("OTABS.save", 1), ("OEMITTED.save", NFREQ)):
        close_arrays(_file(tmp_path / "chain" / "t", name),
                     _file(tmp_path / "chain" / "j", name), name, ncol)


def test_threshold_maps(tmp_path):
    """`threshold 1`: the map takes no emission from the root level."""
    kw = dict(iterations=1, extra="threshold 1\n")
    rt = tdriver.run(octree_model(tmp_path / "thr" / "t", **kw), device=CPU,
                     lanes=LANES)
    jdriver.run(octree_model(tmp_path / "thr" / "j", **kw), lanes=LANES)
    for n in NAMES:
        close_fields(_file(tmp_path / "thr" / "t", n),
                     _file(tmp_path / "thr" / "j", n), n,
                     NFREQ if n != "map_dir_00.bin" else 64)
    full = tdriver.run(octree_model(tmp_path / "all", iterations=1),
                       device=CPU, lanes=LANES)
    # the root level emits most of the light; the refined block remains
    assert 0.0 < rt.maps[0].sum() < 0.5 * full.maps[0].sum()


def test_csave_cload_loadtemp(tmp_path):
    """`csave` writes the constant-source heating, `cload` reads it back
    in place of the background run, `loadtemp` (iterations 0) turns a
    stored tmp.T into the emission and the maps; the port against
    soc_tpu at each step."""
    res = {}
    for pkg, drv, kw in (("t", tdriver, dict(device=CPU)), ("j", jdriver, {})):
        d = tmp_path / pkg
        ini = octree_model(d, iterations=1, extra="csave ctabs.save\n")
        first = drv.run(ini, lanes=LANES, **kw)
        loaded = drv.run(_rerun(ini, "csave ctabs.save", "cload ctabs.save"),
                         lanes=LANES, **kw)
        os.remove(d / "emitted.data")
        os.remove(d / "map_dir_00.bin")
        frozen = drv.run(_rerun(ini, "csave ctabs.save", "loadtemp\n"
                                "iterations 0"), lanes=LANES, **kw)
        res[pkg] = (first, loaded, frozen)
    (first, loaded, frozen), jres = res["t"], res["j"]
    np.testing.assert_array_equal(_file(tmp_path / "t", "ctabs.save"),
                                  first.ctabs)
    np.testing.assert_array_equal(loaded.ctabs, first.ctabs)
    np.testing.assert_array_equal(loaded.temperature, first.temperature)
    assert loaded.packets == 0
    np.testing.assert_array_equal(frozen.temperature, first.temperature)
    np.testing.assert_array_equal(frozen.emitted, first.emitted)
    for got, ref in zip(res["t"], jres):
        np.testing.assert_allclose(got.temperature,
                                   np.asarray(ref.temperature), rtol=1e-4)
    close_arrays(_file(tmp_path / "t", "ctabs.save"),
                 _file(tmp_path / "j", "ctabs.save"), "ctabs.save", 1)
    for n in ("emitted.data", "map_dir_00.bin"):
        close_fields(_file(tmp_path / "t", n), _file(tmp_path / "j", n), n,
                     NFREQ if n != "map_dir_00.bin" else 64)


def test_octree_on_a_devices_mesh(tmp_path):
    """`rt` on the octree over four CPU shards (dp 2 x freq 2, the map's
    rows split) against the one-device run."""
    ini = octree_model(tmp_path, iterations=1)
    one = tdriver.run(ini, device=CPU, lanes=LANES)
    mesh = tdriver.run(ini, device=CPU, lanes=LANES, devices=[CPU] * 4)
    for a, b in ((mesh.absorbed, one.absorbed),
                 (mesh.temperature, one.temperature),
                 (mesh.emitted, one.emitted), (mesh.maps[0], one.maps[0])):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * np.abs(b).max())
    bal = (mesh.absorbed_photons + mesh.escaped) / mesh.injected - 1
    assert np.abs(bal).max() < 1e-4


def test_octree_pipeline_matches_soc_tpu(tmp_path, monkeypatch):
    """The `pipeline` verb on the octree with a GSET dust: absorption run
    -> A2E over every cell (the parent cells' rows masked) -> map."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    names = ("absorbed.data", "emitted.data", "map_dir_00.bin")
    kw = dict(kind="gset", nfreq=NFREQ, nsize=4, octree=OCTREE,
              extra="nenumber 32\n")
    ini_t = write_model(str(tmp_path / "t"), 8, **kw)
    ini_j = write_model(str(tmp_path / "j"), 8, **kw)
    rt, emitted, rm = tfull.run_pipeline(ini_t, device=CPU, lanes=LANES)
    jfull.run_pipeline(ini_j, lanes=LANES)
    for n in names:
        close_fields(_file(tmp_path / "t", n), _file(tmp_path / "j", n), n,
                     NFREQ if n != "map_dir_00.bin" else 64)
    parents = rt.absorbed[:, 0] < -1e19
    assert rt.grid.levels == 3 and parents.sum() == 16
    assert emitted.shape == (CELLS, NFREQ)
    assert (emitted[parents] == 0).all() and emitted[~parents].max() > 0
    assert np.isfinite(rm.maps[0]).all()
