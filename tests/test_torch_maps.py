"""The render suite, the port against soc_tpu on the same inputs: the
orthographic map (plain, MAP_INTERPOLATION, the shearing-box
continuation), the all-sky Healpix map (each `interpolate` mode), the
perspective panorama, PSTau and the two MAP_HIER renders, on a 3-level
octree (an 8^3 root, 10 refined root cells, 8 of their children refined
again) with 4 channels.

Tolerance: 1e-5 of each output's peak. Both integrate the same steps in
float32; XLA's exp (and sin/cos for the sky directions) differ from
torch's by a few ulps, which moves an entry by ~1e-6 of the peak.
Within the port: the MAP_HIER planes sum to the plain map (1e-5 of the
peak: the same contributions added in another grouping), and on a uniform
cloud MAP_INTERPOLATION reproduces the plain map (its triangle weights sum
to one; 5e-3, soc_tpu's bound in tests/test_ini_wiring.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.grid import encode_link_np
from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
from soc_tpu.render import mapping as jm

from soc_tpu_torch.grid import grid_from_arrays as t_grid_from_arrays
from soc_tpu_torch.grid import uniform_grid as t_uniform_grid
from soc_tpu_torch.render import mapping as tm

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 8
NF = 4
TOL = 1e-5
INTOBS = (3.3, 4.1, 4.7)
CENTRE = (4.0, 4.0, 4.0)
NPIX = (12, 10)


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(11)
    root = rng.uniform(0.5, 2.0, N ** 3).astype(np.float32)
    ref0 = np.sort(rng.choice(N ** 3, 10, replace=False))
    root[ref0] = encode_link_np(8 * np.arange(len(ref0)))
    l1 = rng.uniform(0.5, 2.0, 8 * len(ref0)).astype(np.float32)
    ref1 = np.sort(rng.choice(len(l1), 8, replace=False))
    l1[ref1] = encode_link_np(8 * np.arange(len(ref1)))
    l2 = rng.uniform(0.5, 2.0, 8 * len(ref1)).astype(np.float32)
    lcells = [len(root), len(l1), len(l2)]
    values = [root, l1, l2]
    emit = rng.uniform(0, 1, (sum(lcells), NF)).astype(np.float32)
    ext = np.asarray([0.05, 0.2, 0.5, 1.0], np.float32)
    odir, ra, de = jm.observer_basis(np.radians(30.0), np.radians(20.0))
    return dict(
        jg=j_grid_from_arrays(N, N, N, lcells, values),
        tg=t_grid_from_arrays(N, N, N, lcells, values, CPU),
        je=jnp.asarray(emit), te=torch.as_tensor(emit),
        jx=jnp.asarray(ext), tx=torch.as_tensor(ext), basis=(odir, ra, de))


def _close(t, j, name):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape, name
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=TOL * max(np.abs(j).max(), 1e-30),
                               err_msg=name)


ORTHO = {"plain": {}, "mapint": dict(map_interp=2),
         "yshear": dict(use_shear=True, y_shear=2.0, maxlos=24.0)}


@pytest.mark.parametrize("case", list(ORTHO))
def test_render_ortho_matches_soc_tpu(model, case):
    odir, ra, de = model["basis"]
    kw = ORTHO[case]
    j = jm.render_ortho(model["jg"], model["je"], model["jx"],
                        jnp.asarray(odir), jnp.asarray(ra), jnp.asarray(de),
                        CENTRE, 0.5, NPIX, **kw)
    t = tm.render_ortho(model["tg"], model["te"], model["tx"], odir, ra, de,
                        CENTRE, 0.5, NPIX, **kw)
    for k, name in enumerate(("photons", "tau", "colden")):
        _close(t[k], j[k], "%s %s" % (case, name))
    if case == "yshear":
        # the continuation only adds path: every pixel at least the plain
        # map's column
        plain = tm.render_ortho(model["tg"], model["te"], model["tx"], odir,
                                ra, de, CENTRE, 0.5, NPIX)
        assert (t[2] >= plain[2] * (1 - 1e-6)).all()
        assert t[2].sum() > plain[2].sum()


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_render_healpix_matches_soc_tpu(model, mode):
    j = jm.render_healpix(model["jg"], model["je"], model["jx"], INTOBS, 4,
                          interpolate=mode)
    stats = {}
    t = tm.render_healpix(model["tg"], model["te"], model["tx"], INTOBS, 4,
                          interpolate=mode, stats=stats)
    for k, name in enumerate(("photons", "tau", "colden")):
        _close(t[k], j[k], "interpolate %d %s" % (mode, name))
    assert stats["rays"] == 12 * 16 and stats["steps"] > 0


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_interp_density_matches_soc_tpu(model, mode):
    """Each mode at random step midpoints inside (and a cell beyond) the
    grid, with the ray cells' own densities and levels."""
    rng = np.random.default_rng(mode)
    mid = rng.uniform(-0.5, N + 0.5, (4000, 3)).astype(np.float32)
    dens0 = rng.uniform(0.5, 2.0, 4000).astype(np.float32)
    lev = rng.integers(0, 3, 4000)
    j = jm._interp_density(model["jg"], jnp.asarray(mid),
                           jnp.asarray(dens0), jnp.asarray(lev, jnp.int32),
                           mode)
    t = tm._interp_density(model["tg"], torch.as_tensor(mid),
                           torch.as_tensor(dens0), torch.as_tensor(lev),
                           mode)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL)


def test_render_perspective_matches_soc_tpu(model):
    j = jm.render_perspective(model["jg"], model["je"], model["jx"], INTOBS,
                              (16, 8))
    t = tm.render_perspective(model["tg"], model["te"], model["tx"], INTOBS,
                              (16, 8))
    for k, name in enumerate(("photons", "tau", "colden")):
        _close(t[k], j[k], name)


def test_render_pstau_matches_soc_tpu(model):
    """Sources inside, on a refined cell and outside the grid; the
    medium's extinction and a per-cell one (WITH_ABU)."""
    odir = model["basis"][0]
    ps = np.asarray([[3.0, 4.0, 5.0], [1.0, 7.0, 2.0], [12.0, 4.0, 4.0]],
                    np.float32)
    cells = model["tg"].cells
    per_cell = np.linspace(0.5, 1.5, cells * NF).astype(np.float32).reshape(
        cells, NF)
    for jx, tx in ((model["jx"], model["tx"]),
                   (jnp.asarray(per_cell), torch.as_tensor(per_cell))):
        j = jm.render_pstau(model["jg"], jx, jnp.asarray(ps),
                            jnp.asarray(odir))
        t = tm.render_pstau(model["tg"], tx, ps, odir)
        _close(t[0], j[0], "tau")
        _close(t[1], j[1], "colden")


def test_render_ortho_hier_matches_soc_tpu(model):
    odir, ra, de = model["basis"]
    j = jm.render_ortho_hier(model["jg"], model["je"], model["jx"],
                             jnp.asarray(odir), jnp.asarray(ra),
                             jnp.asarray(de), CENTRE, 0.5, NPIX)
    t = tm.render_ortho_hier(model["tg"], model["te"], model["tx"], odir, ra,
                             de, CENTRE, 0.5, NPIX)
    _close(t, j, "hier")
    plain = tm.render_ortho(model["tg"], model["te"], model["tx"], odir, ra,
                            de, CENTRE, 0.5, NPIX)[0]
    np.testing.assert_allclose(t.sum(0).numpy(), plain.numpy(), rtol=0,
                               atol=TOL * plain.max().item())
    assert (t[1:].sum((1, 2, 3)) > 0).all()      # the levels are split


def test_render_healpix_hier_matches_soc_tpu(model):
    j = jm.render_healpix_hier(model["jg"], model["je"], model["jx"], INTOBS,
                               4)
    t = tm.render_healpix_hier(model["tg"], model["te"], model["tx"], INTOBS,
                               4)
    for k, name in enumerate(("photons", "tau", "colden")):
        _close(t[k], j[k], name)
    plain = tm.render_healpix(model["tg"], model["te"], model["tx"], INTOBS,
                              4)[0]
    np.testing.assert_allclose(t[0].sum(0).numpy(), plain.numpy(), rtol=0,
                               atol=TOL * plain.max().item())


def test_map_interpolation_uniform_invariant():
    """On a uniform cloud with uniform emission the triangle weights
    reproduce the plain map."""
    grid = t_uniform_grid(N, N, N, CPU)
    emit = torch.ones((grid.cells, 2))
    ext = torch.tensor([0.1, 1.0])
    odir, ra, de = tm.observer_basis(np.radians(20.0), np.radians(35.0))
    plain = tm.render_ortho(grid, emit, ext, odir, ra, de, CENTRE, 0.5,
                            NPIX)[0]
    interp = tm.render_ortho(grid, emit, ext, odir, ra, de, CENTRE, 0.5,
                             NPIX, map_interp=2)[0]
    np.testing.assert_allclose(interp.numpy(), plain.numpy(), rtol=5e-3)
