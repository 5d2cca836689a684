"""The octree with splitting and the other constant sources, through both
packages: the `pipeline` verb on test_torch_phase2.py's 3-level octree
(an 8^3 root, 640 cells, 10 channels) with the split background, point
sources, a diffuse field and `saveint 2` (the A2E solve through its plain
twin); the `pipeline` verb with two GSET dusts and per-cell abundances
(mabu's split of the absorptions); and `rt` with the split Healpix sky.

Tolerances, each with its reason:
  * the pipeline runs: as tests/test_torch_phase2.py (per-frequency totals
    at 2e-3, 99% of the per-cell entries at 1e-4): the split background
    runs in one mixed pool in both packages, at the same lane count, so
    the same packets split;
  * the split sky: soc_tpu runs it one channel a pool, the port in one
    mixed pool, so other packets split (the lanes dead at each refill
    may differ); held statistically: per-channel absorbed totals within
    2% and temperatures within 2% (soc_tpu's bound for runs that draw
    other packets, tests/test_iterations.py). Measured worst case on this
    model: 1.2e-6 on the totals, 9.5e-7 on the temperatures (here nearly
    the same packets split in both).
"""

import os

import numpy as np
import torch

from soc_tpu.pipeline import driver as jdriver
from soc_tpu.pipeline import full as jfull

from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.pipeline import full as tfull

from test_torch_phase2 import CELLS, LANES, NFREQ, OCTREE, close_arrays, \
    close_fields

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _file(d, name):
    return np.fromfile(os.path.join(d, name), np.float32)


def _pipelines(tmp_path, monkeypatch, **kw):
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    ini_t = write_model(str(tmp_path / "t"), 8, kind="gset", nfreq=NFREQ,
                        nsize=4, octree=OCTREE, extra="nenumber 32\n", **kw)
    ini_j = write_model(str(tmp_path / "j"), 8, kind="gset", nfreq=NFREQ,
                        nsize=4, octree=OCTREE, extra="nenumber 32\n", **kw)
    out = tfull.run_pipeline(ini_t, device=CPU, lanes=LANES)
    jfull.run_pipeline(ini_j, lanes=LANES)
    for n in ("absorbed.data", "emitted.data", "map_dir_00.bin"):
        close_fields(_file(tmp_path / "t", n), _file(tmp_path / "j", n), n,
                     NFREQ if n != "map_dir_00.bin" else 64)
    return out


def test_octree_pipeline_split_and_sources_match_soc_tpu(tmp_path,
                                                         monkeypatch):
    rt, emitted, rm = _pipelines(
        tmp_path, monkeypatch, split=4,
        point_sources=[(4.3, 3.7, 4.1, 0.3), (3.6, 4.4, 13.0, 1.0)],
        ps_method=2, pspackets=500, diffuse=0.5, dfpackets=2 * CELLS,
        saveint=2)
    t, j = _file(tmp_path / "t", "ISRF.DAT"), _file(tmp_path / "j",
                                                    "ISRF.DAT")
    np.testing.assert_array_equal(t[:3], j[:3])
    close_arrays(t[3:], j[3:], "ISRF.DAT", 4 * NFREQ)
    passes = {st["source"]: st for st in rt.source_passes}
    assert sorted(passes) == ["bg", "diffuse", "ps"]
    assert passes["bg"]["clones"] > 0
    assert passes["ps"]["clones"] == passes["diffuse"]["clones"] == 0
    parents = rt.absorbed[:, 0] < -1e19
    assert (emitted[parents] == 0).all() and emitted[~parents].max() > 0
    assert np.isfinite(rm.maps[0]).all()


def test_pipeline_abundances_match_soc_tpu(tmp_path, monkeypatch):
    """Two GSET dusts with per-cell abundances: the absorption run with
    the per-cell cross sections and MSF, the emission split between the
    dusts by abundance (mabu), the map with each cell's extinction."""
    _pipelines(tmp_path, monkeypatch, abundance=True)


def test_rt_split_sky_statistically_equal(tmp_path):
    """`rt` with the weighted Healpix sky split on the octree."""
    kw = dict(kind="eqdust", nfreq=NFREQ, octree=OCTREE, hpbg=4,
              hpbg_weighted=True, split=4)
    rt = tdriver.run(write_model(str(tmp_path / "t"), 8, **kw), device=CPU,
                     lanes=LANES)
    rj = jdriver.run(write_model(str(tmp_path / "j"), 8, **kw),
                     lanes=LANES)
    sky = [st for st in rt.source_passes if st["source"] == "hpbg"][0]
    assert sky["clones"] > 0
    leaf = rt.grid.dens.numpy() > 0
    np.testing.assert_allclose(rt.absorbed[leaf].sum(0),
                               rj.absorbed[leaf].sum(0), rtol=0.02)
    np.testing.assert_allclose(rt.temperature, rj.temperature, rtol=0.02)
