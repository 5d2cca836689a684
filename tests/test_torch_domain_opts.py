"""`domains N` with its options, against the port's one-device runs on
the CPU (port only): the slab layout, ALI's XAB tally, `saveint 2`,
abundances with MSF, the weighting, `split` (statistically), `mirror zZ`
(reflected on the outer slabs only), thin slabs, the pending queue's
overflow, soc_tpu's refusals, and the `rt` and `pipeline` verbs.

Tolerances: soc_tpu's rule for domain runs (test_torch_domain.held and
its docstring); `split` as the mesh holds it
(test_torch_product_features: which clones a pool serves depends on its
lanes and refill order).
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu_torch import cli
from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.grid import encode_link_np, grid_from_arrays
from soc_tpu_torch.io.dust import hg_scattering_function
from soc_tpu_torch.parallel import domain
from soc_tpu_torch.pipeline import driver as tdriver

from test_torch_domain import held, source_balance

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12


def octree_grid(nx, ny, nz, refine_roots, seed=0):
    """Two-level grid: the listed root cells refined into octets."""
    rng = np.random.default_rng(seed)
    root = rng.uniform(0.5, 1.5, nx * ny * nz).astype(np.float32)
    child = []
    for j, r in enumerate(refine_roots):
        root[r] = encode_link_np(np.asarray([8 * j], np.int32))[0]
        child.extend(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    return grid_from_arrays(nx, ny, nz, [nx * ny * nz, len(child)],
                            [root, np.asarray(child, np.float32)], CPU)


@pytest.mark.parametrize("n_slabs", [2, 4, 8])
def test_split_grid_slabs_partitions_cells(n_slabs):
    """Every cell lies in one slab once, leaf densities intact; refined
    roots on both sides of each slab face (z 0-1 | 2-3 ...)."""
    grid = octree_grid(4, 4, 8, refine_roots=[5, 21, 40, 60, 100, 127])
    ds = domain.DomainSet(grid, [CPU] * n_slabs)
    sl = ds.slabs
    assert sl.n_slabs == n_slabs and sl.nz_local == 8 // n_slabs
    gidx = sl.gidx[sl.gidx >= 0]
    assert len(gidx) == grid.cells and len(np.unique(gidx)) == grid.cells
    dens = grid.dens.numpy()
    for s in range(n_slabs):
        m = sl.gidx[s] >= 0
        leaf = dens[sl.gidx[s][m]] > 0
        np.testing.assert_array_equal(sl.dens[s][m][leaf],
                                      dens[sl.gidx[s][m]][leaf])
        # padding reads as a tiny leaf, never as a link
        assert (sl.dens[s][~m] == np.float32(1e-30)).all()
        assert (ds.owner_of_cell.numpy()[sl.gidx[s][m]] == s).all()
    # the slab tallies map back through gidx, the padding dropped
    out = torch.zeros(grid.cells)
    for s in range(n_slabs):
        ds.assemble(s, torch.as_tensor(sl.gidx[s], dtype=torch.float32), out)
    np.testing.assert_array_equal(out.numpy(),
                                  np.arange(grid.cells, dtype=np.float32))


def pair(tmp_path, slabs=4, **kw):
    """write_model's eqdust model (8^3, 6 channels) with ``kw`` on one
    device and over ``slabs`` CPU slabs (run's domains list)."""
    ini = write_model(str(tmp_path / "m"), 8, kind="eqdust", nfreq=6, **kw)
    one = tdriver.run(ini, device=CPU, lanes=LANES)
    dom = tdriver.run(ini, device=CPU, lanes=LANES, domains=[CPU] * slabs)
    assert dom.domains == [CPU] * slabs
    return one, dom


@pytest.mark.parametrize("name,kw", [
    ("saveint 2", dict(saveint=2)),
    ("abundance msf", dict(abundance=True, cellpackets=1024, iterations=2)),
    ("weighting", dict(cellpackets=1024, iterations=2,
                       extra="stepweight 2 1.3 0.4\ndireweight 1 0.5\n")),
    ("ali reference", dict(cellpackets=1024, iterations=3,
                           extra="ali 1\nreference 1\n")),
    ("octree ali", dict(octree=(2, 8, 3), cellpackets=1280, iterations=2,
                        extra="ali 1\n"))])
def test_options_match_one_pool(tmp_path, name, kw):
    """Each option over 4 slabs against one pool, field for field."""
    one, dom = pair(tmp_path, **kw)
    for f in ("ctabs", "absorbed", "temperature", "emitted", "intensity"):
        if getattr(one, f) is not None:
            held(getattr(dom, f), getattr(one, f), f)
    for co, cd in zip(one.cell_passes, dom.cell_passes):
        assert cd["route"] == co["route"] and cd["slabs"] == 4
        np.testing.assert_allclose(tdriver.pass_balance(cd),
                                   tdriver.pass_balance(co), atol=1e-3)


def test_ali_xab_matches_one_pool(tmp_path):
    """ALI's self-absorption tally of one cell pass on the octree (its
    refined block cut by the slab face z = 4): the port's e_cell stays
    global while the slab's deposits are local."""
    ini = write_model(str(tmp_path / "m"), 8, kind="eqdust", nfreq=6,
                      octree=(2, 8, 3), cellpackets=1280, extra="ali 1\n")
    res = tdriver.run(ini, device=CPU, lanes=LANES)
    emitted = torch.as_tensor(res.emitted)
    cfg = tdriver.RunConfig(ini)
    cfg.freq, cfg.nfreq = res.freq, len(res.freq)
    ds = domain.DomainSet(res.grid, [CPU] * 4)
    out = {}
    for name, dset in (("one", None), ("dom", ds)):
        tabs = torch.zeros(res.grid.cells)
        intf = torch.zeros((res.grid.cells, len(res.freq)))
        out[name] = tdriver.simulate_cell_emission(
            res.grid, res.medium, cfg, emitted, tabs, intf, res.seed,
            LANES, True, iteration=1, pmesh=dset)
    held(out["dom"][0].numpy(), out["one"][0].numpy(), "tabs")
    held(out["dom"][3], out["one"][3], "xab")
    assert out["one"][3].sum() > 0
    assert out["dom"][4]["domain"]["emigrants"] > 0


def test_split_octree_statistically(tmp_path):
    """The split background on the 3-level octree over 4 slabs: clones
    served, the balance per channel (born outside included) closes, and
    the refined leaves' absorption agrees with one pool's within five
    times the spread of 16 cell groups' differences."""
    one, dom = pair(tmp_path, octree=(2, 8, 3), split=4)
    st = dom.source_passes[0]
    assert st["route"] == "domains" and st["clones"] > 0
    assert source_balance(dom).max() < 1e-5
    leaves = np.nonzero(dom.absorbed[:, 0] > -1e19)[0]
    leaves = leaves[leaves >= 512]          # below the root level
    a = dom.absorbed[leaves].sum(1).astype(np.float64)
    b = one.absorbed[leaves].sum(1).astype(np.float64)
    groups = np.array_split(np.arange(len(leaves)), 16)
    diffs = np.asarray([a[g].sum() - b[g].sum() for g in groups])
    assert abs(diffs.sum()) < 5.0 * diffs.std() * np.sqrt(len(groups)) \
        + 1e-6 * b.sum()
    np.testing.assert_allclose(a.sum(), b.sum(), rtol=0.05)


def test_mirror_zz_reflects_on_outer_slabs(tmp_path):
    """`mirror zZ` over 4 slabs against one pool's: the Z faces reflect on
    the bottom and top slabs only (interior faces hand packets over), so
    the fields agree; the mirrors change the run (it differs from one
    without them). The band is cut to the thick channels: a transparent
    channel's packet between two mirrors bounces for 1e5 steps."""
    kw = dict(simum=(0.1, 10.0), cellpackets=1024, iterations=2)
    one, dom = pair(tmp_path, extra="mirror zZ\n", **kw)
    for f in ("ctabs", "absorbed", "temperature", "emitted"):
        held(getattr(dom, f), getattr(one, f), f)
    phys = dict(kabs=torch.zeros(1), ksca=torch.zeros(1), tw=torch.zeros(1),
                csc=torch.zeros((1, 4)))
    masks = [domain.StepKit(g, phys, 1, False, mirror_mask=16 | 32,
                            domain=dict(rank=s, n_slabs=4, nz_local=2,
                                        gidx=None)).mirror_mask
             for s, g in enumerate(domain.DomainSet(dom.grid,
                                                    [CPU] * 4).grids)]
    assert masks == [16, 0, 0, 32]
    plain = tdriver.run(write_model(str(tmp_path / "p"), 8, kind="eqdust",
                                    nfreq=6, **kw), device=CPU, lanes=LANES)
    assert abs(plain.ctabs.sum() / one.ctabs.sum() - 1) > 1e-2


def test_thin_slabs_lose_nothing(tmp_path):
    """nz_local = 1 (8 slabs on 8 planes): most packets cross a face, and
    the balance of every channel closes to float64 rounding."""
    one, dom = pair(tmp_path, slabs=8, hpbg=2)
    for st in dom.source_passes:
        assert st["domain"]["emigrants"] > st["packets"]
    assert source_balance(dom).max() < 1e-6
    held(dom.ctabs, one.ctabs, "ctabs")


def test_queue_overflow_raises_naming_lanes():
    """A slab whose lanes stay busy (pure scattering, 20 scatterings a
    packet) under a transparent slab with two point sources: at 64 lanes
    its pending queue overflows and the pass raises, naming `lanes`; at
    512 it does not."""
    n = 12
    vals = np.full((8, n, n), 1e-6, np.float32)
    vals[:4] = 1.0
    grid = grid_from_arrays(n, n, 8, [8 * n * n], [vals.reshape(-1)], CPU)
    _, csc = hg_scattering_function([0.0], 64)
    phys = dict(kabs=torch.zeros(1), ksca=torch.tensor([30.0]),
                tw=torch.ones(1), csc=torch.tensor(csc, dtype=torch.float32))
    c = n / 2 + 0.1
    params = dict(ps_pos=torch.tensor([[c, c, 5.0], [c, c, 5.0],
                                       [c, c, 2.0]]),
                  photons=torch.ones(3, 1))
    ds = domain.DomainSet(grid, [CPU, CPU])

    def run(lanes):
        return domain.run_freqs(ds, grid, phys, "ps", params, [0], [3000],
                                torch.zeros(grid.cells), [None], 7, lanes,
                                False, 0)
    with pytest.raises(RuntimeError, match="raise `lanes` \\(64"):
        run(64)
    _, _, out = run(512)
    assert out["domain"]["queue_peak"] > 512
    np.testing.assert_allclose(out["escaped"], out["launched"], rtol=1e-6)


@pytest.mark.parametrize("extra,match", [
    ("roi 1 2 1 2 1 2\nroisave roi.bin\n", "`roi"),
    ("SUBITERATIONS\n", "`SUBITERATIONS"),
    ("checkpoint c.ckpt\n", "`checkpoint"),
    ("mmapabs\n", "mmapabs under `domains`"),
    ("devices 2\n", "mutually exclusive")])
def test_refusals(tmp_path, extra, match):
    """soc_tpu's refusals under `domains`, each with its words."""
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=6,
                      cellpackets=64, iterations=2,
                      extra=extra + "domains 2\n")
    with pytest.raises(ValueError, match=match):
        tdriver.run(ini, device=CPU, lanes=1024)


def test_refusals_of_lists(tmp_path):
    """An NZ the slab count does not divide, and a device list with a
    domains list, raise."""
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=6)
    with pytest.raises(ValueError, match="NZ=4 not divisible"):
        tdriver.run(ini, device=CPU, lanes=1024, domains=[CPU] * 3)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tdriver.run(ini, device=CPU, lanes=1024, domains=[CPU] * 2,
                    devices=[CPU] * 2)


def test_verbs_run_domains(tmp_path):
    """`rt` and `pipeline` through cli.main with `domains 2` on the CPU
    (--device cpu gives the CPU twice), held to the one-device runs."""
    out = {}
    for name, extra in (("one", ""), ("dom", "domains 2\n")):
        d = str(tmp_path / name)
        ini = write_model(d, 6, kind="gset", nfreq=8, nsize=4,
                          extra="nenumber 16\n" + extra)
        res = {}
        assert cli.main(["pipeline", ini, "--device", "cpu", "--lanes",
                         "4096"], res) == 0
        ini_rt = write_model(os.path.join(d, "rt"), 6, kind="eqdust",
                             nfreq=8, cellpackets=432, iterations=2,
                             extra=extra)
        assert cli.main(["rt", ini_rt, "--device", "cpu", "--lanes",
                         "4096"], res) == 0
        out[name] = res
    dom, one = out["dom"], out["one"]
    assert dom["absorption"].domains == [CPU] * 2
    assert dom["rt"].domains == [CPU] * 2
    held(dom["emitted"], one["emitted"], "pipeline emitted")
    held(dom["rt"].temperature, one["rt"].temperature, "rt temperature")
