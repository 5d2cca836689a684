"""The polarization maps, the port against soc_tpu on the same inputs:
render_pol (plain, `polred`, `polrhoweight`, the `minlos`/`maxlos` window,
the shearing continuation of POLSTAT 2), render_pol_healpix (each
`interpolate` mode), render_polstat (without and with the `threshold`
mask) and render_polstat_healpix (without and with the shear), on
tests/test_torch_maps.py's 3-level octree (an 8^3 root, 4 channels) with
a seeded random B field; then soc_tpu's tests/test_polarization.py
physics on the port.

Tolerances, each with its reason:
  * Stokes planes, optical depth and column density: 1e-5 of each
    plane's peak (the same float32 steps; XLA's exp, sin, cos and atan2
    are a few ulps off torch's);
  * rT and jT: 1e-4 rad absolute; a pixel whose Psi lies within an ulp
    of the pi/2 fold of the angle difference may land on the other side
    of it, so up to 1% of the pixels may differ by more (counted);
  * rI and jI: compared as cos^2 of the angle (the mean cos^2 gamma the
    angle comes from) at 1e-5, since arccos is ill-conditioned near 0;
  * B, B_LOS, B_POS: 1e-5 of the plane's peak (the same weighted means);
  * under the `threshold` mask a ray that crosses a face between a masked
    and an unmasked cell within an ulp may give that sliver of path to
    the other cell (the plain maps' march does the same: one pixel of
    this model carries 1.5e-5 more masked weight in soc_tpu's render_ortho
    than in the port's), so there the density-weighted planes (rI, B,
    B_LOS, B_POS) may differ by more on up to 1% of the pixels (counted),
    none by more than ten times the tolerance.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.grid import encode_link_np
from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
from soc_tpu.render import mapping as jm
from soc_tpu.render import polarization as jp

from soc_tpu_torch.grid import grid_from_arrays as t_grid_from_arrays
from soc_tpu_torch.grid import uniform_grid as t_uniform_grid
from soc_tpu_torch.render import mapping as tm
from soc_tpu_torch.render import polarization as tp

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 8
NF = 4
TOL = 1e-5
ANGLE_TOL = 1e-4
FOLD_SHARE = 0.01
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
    cells = sum(lcells)
    emit = rng.uniform(0, 1, (cells, NF)).astype(np.float32)
    ext = np.asarray([0.05, 0.2, 0.5, 1.0], np.float32)
    # a mean field along +Y plus a tangled part, |B| <= 1 (polred)
    b = np.asarray([0.1, 0.5, 0.2]) + rng.normal(0.0, 0.25, (cells, 3))
    b = (b / np.maximum(1.0, np.linalg.norm(b, axis=1))[:, None]).astype(
        np.float32)
    levels = np.repeat(np.arange(3), lcells)
    cell_w = (levels >= 1).astype(np.float32)
    odir, ra, de = jm.observer_basis(np.radians(30.0), np.radians(20.0))
    return dict(
        jg=j_grid_from_arrays(N, N, N, lcells, values),
        tg=t_grid_from_arrays(N, N, N, lcells, values, CPU),
        je=jnp.asarray(emit), te=torch.as_tensor(emit),
        jx=jnp.asarray(ext), tx=torch.as_tensor(ext),
        jb=jnp.asarray(b), tb=torch.as_tensor(b),
        jw=jnp.asarray(cell_w), tw=torch.as_tensor(cell_w),
        basis=(odir, ra, de))


def _close(t, j, name, channels=False):
    """Within TOL of the peak of each plane: of each channel's plane when
    ``channels`` (the first axis), else of the whole array."""
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape, name
    assert np.isfinite(t).all(), name
    for k, (tk, jk) in enumerate(zip(t, j) if channels else [(t, j)]):
        np.testing.assert_allclose(
            tk, jk, rtol=0, atol=TOL * max(np.abs(jk).max(), 1e-30),
            err_msg="%s plane %d" % (name, k))


def _angles(t, j, name):
    """rT / jT at ANGLE_TOL, all but FOLD_SHARE of the pixels."""
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape and np.isfinite(t).all(), name
    far = np.abs(t - j) > ANGLE_TOL
    assert far.mean() <= FOLD_SHARE, (name, int(far.sum()), t.size)


def _counted(t, j, name, atol):
    """Within atol on all but FOLD_SHARE of the entries, within 10 atol on
    all (the masked case, see the module docstring)."""
    assert (np.abs(t - j) > atol).mean() <= FOLD_SHARE, name
    np.testing.assert_allclose(t, j, rtol=0, atol=10 * atol, err_msg=name)


def _incl(t, j, name, counted=False):
    """rI / jI as cos^2 of the angle, at TOL."""
    t, j = np.cos(t.numpy()) ** 2, np.cos(np.asarray(j)) ** 2
    assert t.shape == j.shape and np.isfinite(t).all(), name
    if counted:
        _counted(t, j, name, TOL)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL, err_msg=name)


POL = {"plain": {}, "polred": dict(polred=True),
       "rho_weight": dict(rho_weight=True),
       "window": dict(minlos=2.0, maxlos=6.5),
       "shear": dict(use_shear=True, y_shear=2.0, maxlos=2.0 * N)}


@pytest.mark.parametrize("case", list(POL))
def test_render_pol_matches_soc_tpu(model, case):
    odir, ra, de = model["basis"]
    kw = POL[case]
    j = jp.render_pol(model["jg"], model["je"], model["jx"], model["jb"],
                      0.2, jnp.asarray(odir), jnp.asarray(ra),
                      jnp.asarray(de), CENTRE, 0.5, NPIX, **kw)
    stats = {}
    t = tp.render_pol(model["tg"], model["te"], model["tx"], model["tb"],
                      0.2, odir, ra, de, CENTRE, 0.5, NPIX, stats=stats,
                      **kw)
    for k, name in enumerate(("I", "Q", "U", "colden")):
        _close(t[k], j[k], "%s %s" % (case, name), channels=k < 3)
    assert stats["rays"] == NPIX[0] * NPIX[1] and stats["steps"] > 0
    if case == "shear":
        plain = tp.render_pol(model["tg"], model["te"], model["tx"],
                              model["tb"], 0.2, odir, ra, de, CENTRE, 0.5,
                              NPIX)
        assert (t[0] >= plain[0] * (1 - 1e-6)).all()
        assert t[3].sum() > plain[3].sum()


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_render_pol_healpix_matches_soc_tpu(model, mode):
    j = jp.render_pol_healpix(model["jg"], model["je"], model["jx"],
                              model["jb"], 0.2, jnp.asarray(INTOBS), 4,
                              interpolate=mode)
    stats = {}
    t = tp.render_pol_healpix(model["tg"], model["te"], model["tx"],
                              model["tb"], 0.2, INTOBS, 4, interpolate=mode,
                              stats=stats)
    for k, name in enumerate(("I", "Q", "U", "colden")):
        _close(t[k], j[k], "interpolate %d %s" % (mode, name),
               channels=k < 3)
    assert stats["rays"] == 12 * 16


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "cell_w"])
def test_render_polstat_matches_soc_tpu(model, masked):
    odir, ra, de = model["basis"]
    j = jp.render_polstat(model["jg"], model["je"], model["jx"], model["jb"],
                          jnp.asarray(odir), jnp.asarray(ra),
                          jnp.asarray(de), CENTRE, 0.5, NPIX,
                          cell_w=model["jw"] if masked else None)
    stats = {}
    t = tp.render_polstat(model["tg"], model["te"], model["tx"], model["tb"],
                          odir, ra, de, CENTRE, 0.5, NPIX,
                          cell_w=model["tw"] if masked else None,
                          stats=stats)
    assert set(t) == set(j)
    for key in ("rT", "jT"):
        _angles(t[key], j[key], key)
    _incl(t["rI"], j["rI"], "rI", counted=masked)
    _incl(t["jI"], j["jI"], "jI")
    for key in ("B", "B_LOS", "B_POS"):
        if masked:
            jk = np.asarray(j[key])
            _counted(t[key].numpy(), jk, key, TOL * np.abs(jk).max())
        else:
            _close(t[key], j[key], key)
    for key in ("tau", "colden"):
        _close(t[key], j[key], key)
    # two marches over the same rays
    assert stats["rays"] == 2 * NPIX[0] * NPIX[1]
    if masked:
        # the mask leaves the column density alone
        full = tp.render_polstat(model["tg"], model["te"], model["tx"],
                                 model["tb"], odir, ra, de, CENTRE, 0.5,
                                 NPIX)
        np.testing.assert_array_equal(t["colden"].numpy(),
                                      full["colden"].numpy())
        assert not np.allclose(t["B"].numpy(), full["B"].numpy())


@pytest.mark.parametrize("shear", [False, True], ids=["plain", "shear"])
def test_render_polstat_healpix_matches_soc_tpu(model, shear):
    kw = dict(use_shear=True, y_shear=2.0, maxlos=2.0 * N) if shear \
        else dict(maxlos=5.0)
    j = jp.render_polstat_healpix(model["jg"], model["je"], model["jx"],
                                  model["jb"], jnp.asarray(INTOBS), 4, **kw)
    t = tp.render_polstat_healpix(model["tg"], model["te"], model["tx"],
                                  model["tb"], INTOBS, 4, **kw)
    assert set(t) == set(j)
    for key in ("rT", "jT"):
        _angles(t[key], j[key], key)
    for key in ("rI", "jI"):
        _incl(t[key], j[key], key)


@pytest.mark.parametrize("mean,psi", [(0.3, 0.2), (1.5, -1.4), (-1.2, 1.4),
                                      (0.0, math.pi / 2)])
def test_wrap_psi_dev_matches_soc_tpu(mean, psi):
    """The folded angle difference: a floored mod (torch.remainder)."""
    rng = np.random.default_rng(3)
    m = (mean + rng.normal(0, 1, 64)).astype(np.float32)
    p = (psi + rng.normal(0, 1, 64)).astype(np.float32)
    j = np.asarray(jp._wrap_psi_dev(jnp.asarray(m), jnp.asarray(p)))
    t = tp._wrap_psi_dev(torch.as_tensor(m), torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert (t >= 0).all() and (t <= math.pi / 2 + 1e-6).all()


# ---- soc_tpu's tests/test_polarization.py physics, on the port


def _uniform(bvec, nx=8):
    grid = t_uniform_grid(nx, nx, nx, CPU)
    emit = torch.ones((grid.cells, 1))
    ext = torch.tensor([1e-4])
    b = torch.as_tensor(np.asarray(bvec, np.float32)).expand(grid.cells, 3)
    return grid, emit, ext, b.contiguous()


def _centre_pixel(bvec, p0=0.2, nx=8):
    grid, emit, ext, b = _uniform(bvec, nx)
    odir, ra, de = tm.observer_basis(0.0, 0.0)
    i, q, u, _ = tp.render_pol(grid, emit, ext, b, p0, odir, ra, de,
                               (nx / 2,) * 3, 1.0, (nx, nx))
    c = nx // 2
    return float(i[0, c, c]), float(q[0, c, c]), float(u[0, c, c])


def _physics_los():
    """B along the line of sight: Q = U ~ 0, I raised by p0 2/3."""
    i, q, u = _centre_pixel((0.0, 0.0, 1.0))
    assert abs(q) < 2e-5 * i and abs(u) < 2e-5 * i
    i0, _, _ = _centre_pixel((0.0, 0.0, 1.0), p0=0.0)
    np.testing.assert_allclose(i / i0, 1.0 + 0.2 * 2.0 / 3.0, rtol=1e-3)


def _physics_in_plane():
    """B in the plane of the sky: the largest fraction; along DE Psi = pi/2
    (Q < 0), along RA Psi = pi (Q > 0), U ~ 0 in both."""
    _, ra, de = tm.observer_basis(0.0, 0.0)
    i, q, u = _centre_pixel(tuple(de))
    assert np.hypot(q, u) / i > 0.15 and q < 0 and abs(u) < 2e-4 * abs(q)
    i, q, u = _centre_pixel(tuple(ra))
    assert q > 0 and abs(u) < 2e-4 * abs(q)


def _physics_rotation():
    """Rotating B in the sky plane by a rotates (Q, U) by 2a."""
    _, ra, de = tm.observer_basis(0.0, 0.0)
    angles = [0.0, np.pi / 6, np.pi / 4, np.pi / 3]
    chis = []
    for a in angles:
        _, q, u = _centre_pixel(tuple(np.cos(a) * de + np.sin(a) * ra))
        chis.append(0.5 * np.arctan2(u, q))
    dchi = np.diff(np.unwrap(np.asarray(chis) * 2.0)) / 2.0
    np.testing.assert_allclose(np.abs(dchi), np.diff(angles), atol=0.01)


def _stat(b):
    grid, emit, ext, _ = _uniform((0.0, 1.0, 0.0))
    odir, ra, de = tm.observer_basis(0.0, 0.0)
    return tp.render_polstat(grid, emit, ext, b, odir, ra, de, (4.0,) * 3,
                             1.0, (8, 8))


def _physics_uniform_stat():
    """A uniform field: rT ~ 0, <|B|> its strength, the LOS / POS split
    by the geometry (observer at +Z, B = (0, 3, 4))."""
    out = _stat(_uniform((0.0, 3.0, 4.0))[3])
    assert abs(float(out["rT"][4, 4])) < 1e-3
    np.testing.assert_allclose(float(out["B"][4, 4]), 5.0, rtol=1e-4)
    np.testing.assert_allclose(float(out["B_LOS"][4, 4]), 4.0, rtol=1e-3)
    np.testing.assert_allclose(float(out["B_POS"][4, 4]), 3.0, rtol=1e-3)
    np.testing.assert_allclose(float(out["colden"][4, 4]), 8.0, rtol=1e-3)


def _physics_tangled_stat():
    """A tangled field disperses the angle."""
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.normal(size=(512, 3)).astype(np.float32))
    assert float(_stat(b)["rT"].mean()) > 0.3


@pytest.mark.parametrize("check", [_physics_los, _physics_in_plane,
                                   _physics_rotation, _physics_uniform_stat,
                                   _physics_tangled_stat],
                         ids=["los", "in_plane", "rotation", "uniform",
                              "tangled"])
def test_polarization_physics(check):
    check()
