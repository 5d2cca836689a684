"""TRUST I's slab (benchmark/configs/trust_slab_tau10.json) on the port:
the writer's octree and files, a tiny slab through the whole `rt` run on
the CPU against the benchmark's plain reference (the star's deposits per
level, depth layer and child slot, the cell pass's, the final
temperatures and both maps), the spans the run adds, read by the
benchmark's readers, and the aimed point-source direction that once
stepped to NaN."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.checks import _slab
from benchmark.reference.inputs import load_cloud, read_hierarchy
from benchmark.tests import tiny_slab
from benchmark.writers import trust_slab
from soc_tpu_torch.utils import trace

# two threads a test process: the tier-1 run holds several side by side
torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(
    REPO, "benchmark", "configs", "trust_slab_tau10.json")))


@pytest.fixture(autouse=True)
def tracer_off():
    trace.stop()
    yield
    trace.stop()


def test_octree_of_the_cell():
    """556,800 cells in 4 levels, 489,600 leaves; every link a block of 8
    children on the next level, each child of one parent; the refined
    cells exactly those within refine_pc of the lit face."""
    model = CONFIG["model"]
    lcells, values = trust_slab.octree(model)
    assert lcells == [19200, 25600, 102400, 409600]
    assert sum(int((v > 0).sum()) for v in values) == 489600
    for lvl in range(3):
        links = values[lvl] <= 0
        first = (-values[lvl][links]).view(np.int32)
        assert sorted(first) == list(range(0, lcells[lvl + 1], 8))
    assert (values[3] > 0).all()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The tiny slab written twice from one seed, and once from another."""
    model = dict(CONFIG["model"], **tiny_slab.MODEL)
    dirs = [str(tmp_path_factory.mktemp(n)) for n in ("a", "b", "c")]
    lines = [trust_slab.write(d, model, "eqdust", s)
             for d, s in zip(dirs, (7, 7, 8))]
    return model, dirs, lines


def test_writer_files(written):
    model, dirs, lines = written
    kw = dict(lines[0])
    names = ("tmp.cloud", "tmp.dust", "tmp.dsc", "star.bin")
    for name in names:
        blobs = [open(os.path.join(d, name), "rb").read() for d in dirs]
        assert blobs[0] == blobs[1] == blobs[2], name   # the seed draws
    nx, ny, nz, values = read_hierarchy(os.path.join(dirs[0], "tmp.cloud"))
    assert (nx, ny, nz) == (8, 8, 3) and len(values) == 3
    # tau(1 um) through the slab from the written density and the dust
    dust = trust_slab.grain_dust(dirs[0], model)
    tau = float(kw["density"]) * trust_slab.extinction_1um(dust, 1.0) * nz
    assert tau == pytest.approx(10.0, rel=1e-12)
    cloud = load_cloud(os.path.join(dirs[0], "tmp.cloud"),
                       float(kw["density"]))
    assert np.allclose(cloud.dens[cloud.dens > 0], float(kw["density"]))
    # the star above the lit face on the slab's axis, outside the grid
    x, y, z = (float(v) for v in kw["pointsource"][:3])
    assert (x, y, z) == (4.0, 4.0, 6.0) and z > nz
    assert kw["psmethod"] == 2 and kw["ali"] == 1
    assert [float(v) for v in kw["mapcentre"]] == [4.0, 4.125, 1.5]


def test_tiny_slab_against_the_reference():
    """The whole run through the benchmark's harness on the CPU: every
    number within the tiny size's limits (benchmark/tests/tiny_slab.py
    gives each limit's reason)."""
    out = tiny_slab.run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {
        "point.levels", "point.layers", "point.slots", "point.rings",
        "point.columns", "cell.levels", "cell.layers", "cell.self",
        "cell.rings", "cell.columns", "temperature.groups", "map.dir0",
        "map.dir1"}
    for v in out["checks"].values():
        assert v["value"] <= v["limit"]


def test_geometry_groups(tmp_path):
    """Depth layers of the tiny slab: one a leaf depth; child slots 0-7
    under every refined parent."""
    p = tiny_slab.parts()
    d = str(tmp_path)
    lines = trust_slab.write(d, p[1]["model"], "eqdust", 1)
    ctx = dict(workdir=d, ini=dict(lines), device="cpu")
    g = _slab.geometry(ctx)
    leaf_depths = np.unique(np.round(g["depth"][g["leaf"]], 9))
    # level 2 (h 1/4): 1/8, 3/8; level 1 (h 1/2): 3/4; root: 3/2, 5/2
    assert np.allclose(leaf_depths, [0.125, 0.375, 0.75, 1.5, 2.5])
    below = g["level"] > 0
    assert (g["slot"][below] >= 0).all() and (g["slot"][~below] == -1).all()
    assert np.bincount(g["slot"][below]).tolist() == [320] * 8


NEW_SPANS = {"sources.ps_tables", "driver.iteration", "ali.update"}


def _device_reads(monkeypatch):
    """Counts of the calls that wait on a device or read it back."""
    calls = {"n": 0}
    for owner, name in ((torch.Tensor, "item"), (torch.Tensor, "cpu"),
                        (torch.Tensor, "tolist"),
                        (torch.cuda, "synchronize")):
        orig = getattr(owner, name)

        def counted(*a, _orig=orig, **kw):
            calls["n"] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(owner, name, counted)
    return calls


def test_traced_slab_records_the_new_spans(tmp_path, monkeypatch):
    """A traced `rt` run of the tiny slab records the star's tables, each
    iteration, ALI's update and the passes' levels, with the untraced
    run's outputs and the same reads of the device, call for call."""
    from soc_tpu_torch.pipeline import driver
    p = tiny_slab.parts()
    c = harness.Cell(tiny_slab.CELL, 5, "cpu", p, str(tmp_path))
    c.write_model()
    c.write_ini(1)
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        calls = _device_reads(monkeypatch)
        plain = driver.run(c.ini_path, device="cpu", lanes=4096)
        untraced = calls["n"]
        trace.start()
        res = driver.run(c.ini_path, device="cpu", lanes=4096)
        rec = trace.stop()
        traced = calls["n"] - untraced
    finally:
        os.chdir(here)
    assert traced == untraced
    spans = rec["spans"]
    names = {r["name"] for r in spans}
    assert NEW_SPANS <= names
    its = [r for r in spans if r["name"] == "driver.iteration"]
    assert [r["attrs"]["iteration"] for r in its] == [0, 1]
    ali = [r for r in spans if r["name"] == "ali.update"]
    assert len(ali) == 1 and ali[0]["parent"] == its[1]["id"]
    tables = [r for r in spans if r["name"] == "sources.ps_tables"]
    assert len(tables) == 1 and tables[0]["attrs"] == {"method": 2}
    passes = [r for r in spans if r["name"] == "transport.pass"]
    assert [(r["attrs"]["source"], r["attrs"]["levels"]) for r in passes] \
        == [("ps", 3), ("cell", 3)]
    assert rec["counters"]["transport.blocks_eager"] > 0
    assert "transport.blocks_fused" not in rec["counters"]
    np.testing.assert_array_equal(plain.temperature, res.temperature)


def test_the_readers_read_the_new_spans(monkeypatch):
    """The harness's traced run of the tiny slab, its device trace stood
    in for by one interval over the window: every new per-layer metric of
    the cell is read (transport.fused_pct.octree 0: every octree block
    runs eager)."""
    monkeypatch.setattr(harness, "device_intervals",
                        lambda prof: [("kernel", 0, 1 << 62)])
    out = tiny_slab.run(trace=1)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for m in ("point.packets_per_s", "cell_emission.packets_per_s",
              "sources.ps_tables_s", "ali.s", "transport.fused_pct.octree",
              "device.idle_pct.octree", "driver.io_s.octree"):
        assert m in got, m
    assert got["transport.fused_pct.octree"]["value"] == 0.0
    assert got["point.packets_per_s"]["value"] > 0
    assert got["ali.s"]["value"] > 0


def test_aimed_direction_level_with_the_source(monkeypatch):
    """PS_METHOD 2: a face point level with the source in x and y (u = 1/2
    on a grid of even size) gives a direction with two components of
    exactly 0, which stepped to NaN; it takes the DEPS of isotropic
    draws, and its first step is finite."""
    from soc_tpu_torch.grid import grid_from_numpy
    from soc_tpu_torch.ops import traverse
    from soc_tpu_torch.transport import sources
    n = 8
    half = torch.full((4,), 0.5)
    monkeypatch.setattr(sources, "_uniforms",
                        lambda seed, s, hi: (half, half, half * 0.2, half,
                                             half, half))
    dens = np.ones(n ** 3, np.float32)
    grid = grid_from_numpy(n, n, n, dens, [n ** 3], [0], np.full(n ** 3, -1),
                           "cpu")
    side, area = np.zeros((1, 3), np.int32), np.zeros((1, 3), np.float32)
    nside, side[0, 0], area[0, 0] = np.ones(1, np.int32), 4, 1.0
    params = dict(ps_pos=torch.tensor([[4.0, 4.0, 20.0]]),
                  photons=torch.ones(1), xps_nside=torch.as_tensor(nside),
                  xps_side=torch.as_tensor(side),
                  xps_area=torch.as_tensor(area), ifreq=0, hi_base=0)
    b = sources.gen_point_source(grid, torch.arange(4), 1, params)
    assert torch.isfinite(b.dir).all() and (b.dir != 0).all()
    assert b.dir[0, 2] < -0.99 and torch.isfinite(b.photons).all()
    ds, pos = traverse.boundary_step(b.pos, b.dir)
    assert torch.isfinite(ds).all() and torch.isfinite(pos).all()
