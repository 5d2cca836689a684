"""The polarization keywords through `rt` end to end, the port against
soc_tpu: a 3-level octree (an 8^3 root, 640 cells, 10 channels) with a
tangled B field in the map-only mode (one stored emission file -> the
maps, no packets): `polmap Bx By Bz minlos maxlos`, `polstat 1`, `2`
(with `yshear` and a `maxlos` of twice the box) and `3`, `polrhoweight`,
`polred`, `p0`, `threshold` and the all-sky maps (Stokes and POLSTAT,
`mapping NSIDE 0|-1` with `perspective`'s observer); `abundance`'s
per-cell extinction in a run without packets heated by `CR_HEATING`
alone; the bare `polmap 1` with `Bfiles` through the CLI; and the maps
over a 2-device CPU mesh against one device. Every file is compared with
soc_tpu's.

Tolerances, each with its reason (tests/test_torch_polarization.py):
  * Stokes planes and column densities: 1e-5 of each channel's plane's
    peak (the same float32 steps, XLA's exp/sin/cos/atan2 a few ulps off
    torch's);
  * POLSTAT planes: rT and jT 1e-4 rad on all but 1% of the pixels (a Psi
    within an ulp of the pi/2 fold); rI and jI as cos^2 at 1e-5 (under
    `threshold` on all but 1% of the pixels, none beyond 1e-4: a ray's
    sliver of path at an ulp of a masked face); B, B_LOS, B_POS, tau and
    N 1e-5 of the plane's peak (`threshold`: counted as rI);
  * int32 headers and file names: equal; FITS files: read back bit for
    bit equal to their planes, their headers equal to soc_tpu's;
  * the mesh's maps: equal bit for bit to one device's (the same renders
    on the first shard's device).
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu.io.fits import read_fits_image as j_read_fits
from soc_tpu.io.fits import read_healpix_map as j_read_healpix
from soc_tpu.pipeline import driver as jdriver

from soc_tpu_torch import cli
from soc_tpu_torch.example_model import octree_cloud, write_model
from soc_tpu_torch.io.fields import write_cell_frequency_array
from soc_tpu_torch.io.fits import read_fits_image, read_healpix_map
from soc_tpu_torch.pipeline import driver as tdriver

torch.set_num_threads(2)
CPU = torch.device("cpu")
NFREQ = 10
OCTREE = (2, 8, 3)
TOL = 1e-5
ANGLE_TOL = 1e-4
SHARE = 0.01
POLMAP = "polmap          Bx.bin By.bin Bz.bin"
VIEW = "directions      0.0 0.0"


def _model(d, extra, view=None, emission=True, **kw):
    """The octree with the tangled field and a stored emission file
    (1e-20-2e-20 photons a cell and channel, a seed); ``view`` replaces
    the model's direction line."""
    os.makedirs(d, exist_ok=True)
    ini = write_model(str(d), 8, kind="eqdust", nfreq=NFREQ, octree=OCTREE,
                      iterations=0 if emission else 1, npix=8,
                      bfield="tangled", extra=extra, **kw)
    if view is not None:
        with open(ini) as fp:
            text = fp.read().replace(VIEW, "directions      " + view, 1)
        with open(ini, "w") as fp:
            fp.write(text)
    if emission:
        cells = int(np.sum(octree_cloud(8, *OCTREE)[0]))
        rng = np.random.default_rng(4)
        write_cell_frequency_array(
            os.path.join(str(d), "emitted.data"),
            rng.uniform(1e-20, 2e-20, (cells, NFREQ)).astype(np.float32))
    return ini


def _both(tmp_path, extra, **kw):
    dt, dj = tmp_path / "t", tmp_path / "j"
    rt = tdriver.run(_model(dt, extra, **kw), device=CPU, lanes=4096)
    rj = jdriver.run(_model(dj, extra, **kw), lanes=4096)
    return rt, rj, dt, dj


def _close(t, j, name):
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=TOL * max(np.abs(j).max(), 1e-30),
                               err_msg=name)


def _counted(t, j, name, atol):
    assert (np.abs(t - j) > atol).mean() <= SHARE, name
    np.testing.assert_allclose(t, j, rtol=0, atol=10 * atol, err_msg=name)


def _stokes(t, j, name):
    """[4, NF, ...] stacks: I, Q, U per channel plane, N whole."""
    assert t.shape == j.shape and np.isfinite(t).all(), name
    for k in range(3):
        for f in range(t.shape[1]):
            _close(t[k, f], j[k, f], "%s %s %d" % (name, "IQU"[k], f))
    _close(t[3], j[3], name + " N")
    assert t[0].max() > 0


def _angles(t, j, name):
    assert t.shape == j.shape and np.isfinite(t).all(), name
    assert (np.abs(t - j) > ANGLE_TOL).mean() <= SHARE, name


def _incl(t, j, name, counted=False):
    t, j = np.cos(t) ** 2, np.cos(j) ** 2
    if counted:
        _counted(t, j, name, TOL)
    else:
        _close(t, j, name)


def _statistics(t, j, name, counted=False):
    """[4, NF, ...] stacks: rT, rI, jT, jI."""
    assert t.shape == j.shape and np.isfinite(t).all(), name
    _angles(t[0], j[0], name + " rT")
    _angles(t[2], j[2], name + " jT")
    _incl(t[1], j[1], name + " rI", counted)
    _incl(t[3], j[3], name + " jI")


def _payload(d, name, head):
    raw = np.fromfile(d / name, np.float32)
    return raw[:head].view(np.int32), raw[head:]


def _same_fits(dt, dj, expect):
    """Every FITS file of both runs: the same names, headers equal, the
    port's data bit for bit equal to one of ``expect``'s planes. Returns
    the names."""
    names = sorted(f for f in os.listdir(dt) if ".fits" in f)
    assert names == sorted(f for f in os.listdir(dj) if ".fits" in f)
    for name in names:
        if name.startswith("pol_healpix"):
            data, hdr = read_healpix_map(str(dt / name))
            jdata, jhdr = j_read_healpix(str(dj / name))
        else:
            data, hdr = read_fits_image(str(dt / name))
            jdata, jhdr = j_read_fits(str(dj / name))
        assert hdr == jhdr, name
        assert any(np.array_equal(data, e) for e in expect), name
        assert data.shape == jdata.shape, name
    return names


CASES = {
    "window": POLMAP + " 1.0 6.0\n",
    "polstat1": POLMAP + "\npolstat 1\n",
    "polstat2": POLMAP + " 0.0 16.0\npolstat 2\nyshear 2.0\n",
    "polstat3": POLMAP + "\npolstat 3\n",
    "rhoweight": POLMAP + "\npolrhoweight\n",
    "polred": POLMAP + "\npolred R.bin\n",
    "p0": POLMAP + "\np0 0.1\n",
    "threshold": POLMAP + "\npolstat 1\nthreshold 1\n",
}


@pytest.mark.parametrize("case", list(CASES))
def test_orthographic_keywords(tmp_path, case):
    """One direction (theta 70 deg for POLSTAT 2, so a sheared ray leaves
    through a Z face): polmap_dir_00.bin [4, NF, NY, NX] or
    polstat_dir_00.bin (NPIX + [7, NY, NX]) and the polmap FITS files of
    POLSTAT 0-2."""
    view = "70.0 10.0" if case == "polstat2" else None
    rt, rj, dt, dj = _both(tmp_path, CASES[case] + "distance 100.0\n",
                           view=view)
    passes = [p for p in rt.render_passes if p["render"].startswith("pol")]
    assert len(passes) == 1 and passes[0]["rays"] > 0
    if case in ("polstat1", "polstat3", "threshold"):
        head, t = _payload(dt, "polstat_dir_00.bin", 2)
        jhead, j = _payload(dj, "polstat_dir_00.bin", 2)
        np.testing.assert_array_equal(head, jhead)
        t, j = t.reshape(7, 8, 8), j.reshape(7, 8, 8)
        counted = case == "threshold"
        _angles(t[0], j[0], "rT")
        _incl(t[1], j[1], "rI", counted)
        for k, name in ((2, "B"), (3, "B_LOS"), (4, "B_POS")):
            if counted:
                _counted(t[k], j[k], name, TOL * np.abs(j[k]).max())
            else:
                _close(t[k], j[k], name)
        _close(t[5], j[5], "tau")
        _close(t[6], j[6], "N")
        four = rt.maps[("polstat4", 0)]
        _statistics(four, np.asarray(rj.maps[("polstat4", 0)]), "four",
                    counted)
        np.testing.assert_array_equal(t, rt.maps[("polstat", 0)])
        fits = _same_fits(dt, dj, [four[:, f] for f in range(NFREQ)])
        assert len(fits) == (NFREQ if case != "polstat3" else 0)
        return
    t = np.fromfile(dt / "polmap_dir_00.bin", np.float32).reshape(
        4, NFREQ, 8, 8)
    j = np.fromfile(dj / "polmap_dir_00.bin", np.float32).reshape(
        4, NFREQ, 8, 8)
    _stokes(t, j, case)
    fits = _same_fits(dt, dj, [t[:, f] for f in range(NFREQ)])
    assert len(fits) == NFREQ
    if case == "polstat2":
        plain = tdriver.run(_model(tmp_path / "plain", POLMAP + "\n",
                                   view="70.0 10.0"), device=CPU)
        assert (rt.maps[("pol", 0)][0]
                >= plain.maps[("pol", 0)][0] * (1 - 1e-6)).all()
        assert rt.maps[("pol", 0)][3].sum() \
            > 1.5 * plain.maps[("pol", 0)][3].sum()


@pytest.mark.parametrize("stat", [False, True], ids=["stokes", "polstat"])
def test_healpix_keywords(tmp_path, stat):
    """The all-sky maps from `perspective`'s observer (`mapping 4 0` for
    I/Q/U/N, `mapping 4 -1` + `polstat 1` for rhoTheta, rhoGamma,
    jTheta, jGamma): pol_healpix.bin [NSIDE, NF] + [4, NF, 192] and one
    pol_healpix.fits.%d a channel."""
    extra = (POLMAP + "\nperspective 3.3 4.1 4.7\n"
             + ("mapping 4 -1 1.0\npolstat 1\n" if stat
                else "mapping 4 0 1.0\n"))
    rt, rj, dt, dj = _both(tmp_path, extra)
    head, t = _payload(dt, "pol_healpix.bin", 2)
    jhead, j = _payload(dj, "pol_healpix.bin", 2)
    np.testing.assert_array_equal(head, [4, NFREQ])
    np.testing.assert_array_equal(head, jhead)
    t, j = t.reshape(4, NFREQ, 192), j.reshape(4, NFREQ, 192)
    (_statistics if stat else _stokes)(t, j, "pol_healpix")
    key = ("polstat_hp", 0) if stat else ("pol_hp", 0)
    assert key in rt.maps and key in rj.maps
    fits = _same_fits(dt, dj, [t[:, f] for f in range(NFREQ)])
    assert fits == sorted("pol_healpix.fits.%d" % f for f in range(NFREQ))


def test_abundance_extinction(tmp_path):
    """`abundance` (two dusts): the maps take WITH_ABU's per-cell
    extinction, in a run of no packets heated by `CR_HEATING 1000` alone
    (a thousand times the cosmic-ray rate, to lift the cells off the 3 K
    floor). Each package computes the emission from its own temperatures,
    which differ by an ulp (1.2e-7 relative); the Wien tail turns that
    into up to 8e-6 relative in the emission, and the short channels'
    emission is 1e-30 and below, where XLA flushes subnormal
    intermediates to zero and torch does not. So here each Stokes
    parameter is held to 1e-5 of I's peak over all channels (Q and U are
    signed sums bounded by p0 I)."""
    extra = POLMAP + "\nCR_HEATING 1000.0\n"
    dt, dj = tmp_path / "t", tmp_path / "j"
    kw = dict(emission=False, abundance=True, bgpac=0)
    rt = tdriver.run(_model(dt, extra, **kw), device=CPU, lanes=4096)
    rj = jdriver.run(_model(dj, extra, **kw), lanes=4096)
    np.testing.assert_allclose(rt.temperature, np.asarray(rj.temperature),
                               rtol=1e-6)
    assert rt.temperature[rt.grid.dens.numpy() > 0].min() > 3.0
    t = np.fromfile(dt / "polmap_dir_00.bin", np.float32).reshape(
        4, NFREQ, 8, 8)
    j = np.fromfile(dj / "polmap_dir_00.bin", np.float32).reshape(
        4, NFREQ, 8, 8)
    assert np.isfinite(t).all() and t[0].max() > 0
    peak = np.abs(j[0]).max()
    for k in range(3):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=TOL * peak,
                                   err_msg="abundance " + "IQU"[k])
    _close(t[3], j[3], "abundance N")
    # the medium's extinction gives other maps
    one = tdriver.run(_model(tmp_path / "one", extra, emission=False,
                             bgpac=0), device=CPU, lanes=4096)
    assert not np.allclose(one.maps[("pol", 0)][0], rt.maps[("pol", 0)][0])


def test_cli_bare_polmap_with_bfiles(tmp_path):
    """`python -m soc_tpu_torch rt` with the bare `polmap 1` and a
    `Bfiles` line: the same maps as the `polmap Bx By Bz` form."""
    ini = _model(tmp_path / "bare", "polmap 1\nBfiles Bx.bin By.bin "
                 "Bz.bin\n")
    assert cli.main(["rt", ini, "--device", "cpu", "--lanes", "1024"]) == 0
    full = tdriver.run(_model(tmp_path / "full", POLMAP + "\n"), device=CPU)
    got = np.fromfile(tmp_path / "bare" / "polmap_dir_00.bin", np.float32)
    want = np.fromfile(tmp_path / "full" / "polmap_dir_00.bin", np.float32)
    np.testing.assert_array_equal(got, want)
    assert got.size == 4 * NFREQ * 64


@pytest.mark.parametrize("extra", [POLMAP + " 1.0 6.0\n",
                                   POLMAP + "\npolstat 3\n",
                                   POLMAP + "\nmapping 4 0 1.0\n"],
                         ids=["stokes", "polstat", "healpix"])
def test_polarization_over_a_devices_mesh(tmp_path, extra):
    """Under `devices 2` (two CPU shards) the polarization maps render on
    the first shard's device: the same maps as one device, bit for bit."""
    one = tdriver.run(_model(tmp_path / "one", extra), device=CPU)
    two = tdriver.run(_model(tmp_path / "two", extra + "devices 2\n"),
                      device=CPU)
    assert two.devices is not None and len(two.devices) == 2
    keys = [k for k in one.maps if isinstance(k, tuple)
            and str(k[0]).startswith("pol")]
    assert keys
    for key in keys:
        a, b = two.maps[key], one.maps[key]
        for x, y in zip(a, b) if isinstance(b, tuple) else [(a, b)]:
            np.testing.assert_array_equal(x, y)
