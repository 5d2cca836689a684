"""`domains N` against soc_tpu's Z-slab path on the CPU (the 8-device CPU
mesh of tests/conftest.py, the same seeds, models from
soc_tpu_torch.example_model): split_grid_slabs array for array, the slab
runner against soc_tpu's domain_background_run, domain_cell_emission_run
and domain_generator_run (the Healpix sky, point sources), and `rt` with
`domains 4` through both drivers.

Tolerances: soc_tpu's own for its domain runs (tests/test_domain.py): the
same packets on the same streams (soc_tpu a pool a channel and slab, the
port one mixed pool a slab; XLA's exp/log/cos/sin differ from torch's by
a few ulps, and a packet near a slab face moves by up to PEPS), so totals
within 1e-3 and at least 98% of the cells within 1e-3 relative or 1e-6 of
the maximum (a point source piles its deposits into a few cells: there
soc_tpu's L1 rule, 1e-3, and 95% of the cells); the `rt` runs as
soc_tpu's _compare_domain_run holds them: each channel's absorption
within 2e-2 where above 1e-3 of the largest, the temperatures within
3e-3 on 97% of the cells; the split octree statistically.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soc_tpu.grid import grid_from_arrays as jgrid_from_arrays
from soc_tpu.io.dust import hg_scattering_function
from soc_tpu.parallel import domain as jdomain
from soc_tpu.parallel.mesh import make_mesh
from soc_tpu.pipeline import driver as jdriver
from soc_tpu.transport.sources import stream_hi_base

from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.grid import encode_link_np, grid_from_arrays
from soc_tpu_torch.parallel import domain
from soc_tpu_torch.pipeline import driver as tdriver

from test_torch_domain import held

torch.set_num_threads(2)
CPU = torch.device("cpu")
SEED = 7


def grids(nx, ny, nz, refine_roots=(), seed=0):
    """The same two-level grid in both packages (one level without
    refined roots)."""
    rng = np.random.default_rng(seed)
    root = rng.uniform(0.5, 1.5, nx * ny * nz).astype(np.float32)
    child = []
    for j, r in enumerate(refine_roots):
        root[r] = encode_link_np(np.asarray([8 * j], np.int32))[0]
        child.extend(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    lc = [nx * ny * nz] + ([len(child)] if child else [])
    vals = [root] + ([np.asarray(child, np.float32)] if child else [])
    return (grid_from_arrays(nx, ny, nz, lc, vals, CPU),
            jgrid_from_arrays(nx, ny, nz, lc, vals))


@pytest.mark.parametrize("n_slabs,roots", [(2, ()), (4, (5, 40, 100)),
                                           (8, (5, 21, 40, 60, 100, 127))])
def test_split_grid_slabs_bit_for_bit(n_slabs, roots):
    tg, jg = grids(4, 4, 8, roots)
    t = domain.split_grid_slabs(tg, n_slabs)
    j = jdomain.split_grid_slabs(jg, n_slabs)
    for f in ("dens", "lcells", "off", "par", "gidx"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f)
    for f in ("nx", "ny", "nz", "nz_local", "levels", "cells_pad",
              "n_slabs"):
        assert getattr(t, f) == getattr(j, f), f


def physics_pair():
    _, csc = hg_scattering_function([0.5], 128)
    jphys = dict(kabs=jnp.float32(0.12), ksca=jnp.float32(0.22),
                 csc=jnp.asarray(csc[0]), tw=jnp.float32(1.0))
    tphys = dict(kabs=torch.tensor([0.12]), ksca=torch.tensor([0.22]),
                 csc=torch.tensor(csc, dtype=torch.float32),
                 tw=torch.tensor([1.0]))
    return tphys, jphys


def port_run(grid, kind, params, n, hi0, phys):
    """The port's slab runner over 8 CPU slabs, one channel of n packets,
    512 lanes a slab."""
    ds = domain.DomainSet(grid, [CPU] * 8)
    tabs, _, out = domain.run_freqs(ds, grid, phys, kind, params, [0], [n],
                                    torch.zeros(grid.cells), [None], SEED,
                                    8 * 512, False, hi0)
    assert out["domain"]["emigrants"] > 0
    # only the external point source's misses are born outside
    assert (out["missed"][0] > 0) == (kind == "ps")
    return tabs.numpy(), float(out["escaped"][0])


def compare(tabs_t, esc_t, tabs_j, esc_j, point=False):
    assert tabs_j.sum() > 0
    assert abs(esc_t - esc_j) <= 1e-3 * abs(esc_j)
    if point:
        assert abs(tabs_t.sum() - tabs_j.sum()) <= 1e-3 * tabs_j.sum()
        assert np.abs(tabs_t - tabs_j).sum() <= 1e-3 * tabs_j.sum()
        ok = np.isclose(tabs_t, tabs_j, rtol=1e-3, atol=1e-6 * tabs_j.max())
        assert ok.mean() > 0.95
    else:
        held(tabs_t, tabs_j, "tabs")


@pytest.mark.parametrize("kind", ["bg", "cell", "hpbg", "ps"])
def test_slab_runner_matches_soc_tpu(kind):
    """The slab runner against soc_tpu's runner of the source kind on the
    6 x 6 x 8 octree over 8 slabs (soc_tpu's test_domain models)."""
    tg, jg = grids(6, 6, 8, (50, 130, 200))
    tphys, jphys = physics_pair()
    mesh = make_mesh(jax.devices(), freq_axis=1)      # dp = 8
    slabs = jdomain.split_grid_slabs(jg, 8)
    hi0 = stream_hi_base(kind)
    if kind == "bg":
        n = 8 * (2 * (36 + 48 + 48))
        tj, ej, lost, _ = jdomain.domain_background_run(
            slabs, jphys, jnp.float32(1.0), n, SEED, mesh, nlanes=512)
        params = dict(photons=torch.tensor([1.0]))
    elif kind == "cell":
        rng = np.random.default_rng(4)
        emit = rng.uniform(0.5, 1.5, tg.cells).astype(np.float32)
        emit[tg.dens.numpy() <= 0] = 0.0       # parent link cells
        per_cell = 4
        n = per_cell * tg.cells
        tj, ej, lost, _ = jdomain.domain_cell_emission_run(
            slabs, jphys, emit, per_cell, SEED, mesh, nlanes=512)
        params = dict(emit=torch.tensor(emit), per_cell=per_cell)
    else:
        n = 4096
        if kind == "ps":
            pos = np.asarray([[3.0, 3.0, 2.0], [-4.0, 3.0, 4.0]], np.float32)
            jparams = dict(ps_pos=jnp.asarray(pos),
                           photons=jnp.asarray([1.0, 2.0], jnp.float32))
            params = dict(ps_pos=torch.tensor(pos),
                          photons=torch.tensor([1.0, 2.0]))
        else:
            sky = np.random.default_rng(8).uniform(
                0.5, 1.5, 12 * 8 * 8).astype(np.float32)
            jparams = dict(hpbg=jnp.asarray(sky), cdf=None)
            params = dict(hpbg=torch.tensor(sky))
        tj, ej, lost, _ = jdomain.domain_generator_run(
            slabs, jphys, kind, jparams, n, SEED, mesh, nlanes=512,
            hi_base=hi0)
    assert lost == 0.0
    tt, et = port_run(tg, kind, params, n, hi0, tphys)
    compare(tt, et, np.asarray(tj), ej, point=kind == "ps")


def check_rt(tmp_path, extra, **kw):
    """`rt` with `domains 4` through both drivers (8^3, 8 channels, two
    iterations of cell packets), held as the module docstring says."""
    runs = {}
    for name in ("t", "j"):
        ini = write_model(str(tmp_path / name), 8, kind="eqdust", nfreq=8,
                          cellpackets=2 * 8 ** 3, iterations=2,
                          extra=extra + "domains 4\n", **kw)
        runs[name] = tdriver.run(ini, device=CPU, lanes=1 << 12) \
            if name == "t" else jdriver.run(ini, lanes=1 << 12)
    rt, rj = runs["t"], runs["j"]
    assert rt.domains == [CPU] * 4
    assert all(st["route"] == "domains" for st in rt.source_passes)
    s_col = rj.absorbed.sum(axis=0)
    t_col = rt.absorbed.sum(axis=0)
    m = s_col > 1e-3 * s_col.max()
    np.testing.assert_allclose(t_col[m], s_col[m], rtol=2e-2)
    assert abs(rt.ctabs.sum() / rj.ctabs.sum() - 1) < 2e-3
    good = np.isclose(rt.temperature, rj.temperature, rtol=3e-3)
    assert good.mean() > 0.97
    return rt, rj


def test_rt_domains_ali_emweight_mirror(tmp_path):
    """soc_tpu's test_domains_lifted_absorbed_ali_emweight_mirror on the
    port's model: ALI, EMWEI and `mirror xX` under `domains 4`."""
    rt, _ = check_rt(tmp_path, "ali 1\nemweight 1 0 100\nmirror xX\n")
    assert [p["route"] for p in rt.cell_passes] == ["emweight"]


def test_rt_domains_split_octree(tmp_path):
    """soc_tpu's test_domains_lifted_split_octree: `split` on the octree
    (its refined block cut by the face z = 4), held statistically: the
    refined leaves' absorption within five times the spread of 16 cell
    groups' differences, clones served."""
    rt, rj = check_rt(tmp_path, "", octree=(2, 8, 3), split=4)
    assert rt.source_passes[0]["clones"] > 0
    leaves = np.nonzero(rt.absorbed[:, 0] > -1e19)[0]
    leaves = leaves[leaves >= 512]
    a = rt.absorbed[leaves].sum(1).astype(np.float64)
    b = rj.absorbed[leaves].sum(1).astype(np.float64)
    groups = np.array_split(np.arange(len(leaves)), 16)
    diffs = np.asarray([a[g].sum() - b[g].sum() for g in groups])
    assert abs(diffs.sum()) < 5.0 * diffs.std() * np.sqrt(len(groups)) \
        + 1e-6 * b.sum()
