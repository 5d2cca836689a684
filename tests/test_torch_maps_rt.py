"""The map keywords through `rt` end to end, the port against soc_tpu: a
3-level octree (an 8^3 root, 640 cells, 10 channels) in the `loadtemp`
mode (a stored temperature field -> the emission -> the maps, no packets)
and the map-only mode (a stored emission file), with the Healpix map
(`mapping NSIDE 0`, `interpolate 3`), MAP_HIER ortho and Healpix
(`mapping ... 999`), the perspective panorama (`perspective`), `mapint 2`,
`yshear`, `FITS`, `savetau` (two wavelengths, one outside the map band,
and column density), `pssavetau` and `roimap` (with a NaN emission outside
the box). Every file is compared with soc_tpu's.

Tolerances, each with its reason:
  * maps, optical depths and column densities: 1e-5 of each file's peak
    (tests/test_torch_maps.py: the same float32 steps, XLA's exp and
    sin/cos a few ulps off torch's); with `interpolate 3` a lookup point
    within an ulp of a cell face may fall into the neighbouring cell, as
    a packet diverges in the transport tests: up to 0.5% of the entries
    may differ by more (counted), none by more than 1e-3 of the peak;
  * int32 headers, file names and the PSTau text's source column: equal;
    the text's numbers (4 significant digits) at 1e-3 relative;
  * FITS files: read back bit for bit equal to the map they hold, their
    headers equal to soc_tpu's;
  * the MAP_HIER planes summed against the plain map of the same run
    kind: 1e-5 of the peak (the same steps, grouped by level);
  * the sheared map at least the plain one in every pixel, to 1e-6
    relative (the continuation only adds path).
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu.io.fits import read_fits_image as j_read_fits
from soc_tpu.pipeline import driver as jdriver

from soc_tpu_torch import cli
from soc_tpu_torch.example_model import octree_cloud, write_model
from soc_tpu_torch.io.cloud import write_hierarchy
from soc_tpu_torch.io.fields import write_cell_frequency_array
from soc_tpu_torch.io.fits import read_fits_image
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.transport.roi import roi_cell_mask

torch.set_num_threads(2)
CPU = torch.device("cpu")
NFREQ = 10
OCTREE = (2, 8, 3)
TOL = 1e-5
BOX = (1, 6, 1, 2, 1, 6)


def _model(d, extra, iterations=0, loadtemp=True):
    """The octree model with a stored temperature field (10-25 K); a
    `directions` line in extra replaces the model's (the keyword adds
    directions)."""
    ini = write_model(str(d), 8, kind="eqdust", nfreq=NFREQ, octree=OCTREE,
                      iterations=iterations, npix=8,
                      extra=("loadtemp\n" if loadtemp else "") + extra)
    if "directions" in extra:
        with open(ini) as fp:
            text = fp.read().replace("directions      0.0 0.0\n", "", 1)
        with open(ini, "w") as fp:
            fp.write(text)
    lcells, _ = octree_cloud(8, *OCTREE)
    rng = np.random.default_rng(4)
    temps = [rng.uniform(10.0, 25.0, n).astype(np.float32) for n in lcells]
    write_hierarchy(os.path.join(str(d), "tmp.T"), 8, 8, 8, lcells, temps)
    return ini


def _both(tmp_path, extra, name="run", **kw):
    """The same model and keywords through both packages: (port result,
    soc_tpu result, port dir, soc_tpu dir)."""
    dt, dj = tmp_path / (name + "_t"), tmp_path / (name + "_j")
    rt = tdriver.run(_model(dt, extra, **kw), device=CPU)
    rj = jdriver.run(_model(dj, extra, **kw))
    return rt, rj, dt, dj


def _close(t, j, name):
    assert t.shape == j.shape, name
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=TOL * max(np.abs(j).max(), 1e-30),
                               err_msg=name)


def _close_counted(t, j, name):
    """_close, but for 0.5% of the entries, which stay within 1e-3 of the
    peak (the module docstring's `interpolate 3` case)."""
    peak = max(np.abs(j).max(), 1e-30)
    far = np.abs(t - j) > TOL * peak
    assert far.mean() <= 0.005, (name, int(far.sum()))
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-3 * peak, err_msg=name)


def _same_files(dt, dj, name, head=0, counted=False):
    """A file of both runs: its int32 header words equal, its float32
    payload within TOL of the peak. Returns the port's payload."""
    t = np.fromfile(dt / name, np.float32)
    j = np.fromfile(dj / name, np.float32)
    np.testing.assert_array_equal(t[:head].view(np.int32),
                                  j[:head].view(np.int32))
    (_close_counted if counted else _close)(t[head:], j[head:], name)
    assert np.isfinite(t[head:]).all() and t[head:].max() > 0
    return t[head:]


@pytest.mark.parametrize("mode", [0, 3])
def test_healpix_map(tmp_path, mode):
    """`mapping 4 0`: the all-sky map from the cloud's centre, raw
    map.healpix [NF, 12 NSIDE^2]."""
    rt, rj, dt, dj = _both(tmp_path, "mapping 4 0 1.0\ninterpolate %d\n"
                           % mode)
    _same_files(dt, dj, "map.healpix", counted=mode == 3)
    (_close_counted if mode == 3 else _close)(
        rt.tau_maps[0], np.asarray(rj.tau_maps[0]), "tau")
    assert [p["render"] for p in rt.render_passes] == ["healpix"]
    assert rt.render_passes[0]["rays"] == 192


def test_healpix_hier(tmp_path):
    """`mapping 4 -1 1.0 999`: map_dir_00_H.bin, [NSIDE, NY] + [NF,
    LEVELS] headers, the level planes summing to the plain all-sky map."""
    rt, rj, dt, dj = _both(tmp_path, "mapping 4 -1 1.0 999\n")
    hier = _same_files(dt, dj, "map_dir_00_H.bin", head=4)
    head = np.fromfile(dt / "map_dir_00_H.bin", np.int32, 4)
    np.testing.assert_array_equal(head, [4, -1, NFREQ, 3])
    plain = tdriver.run(_model(tmp_path / "plain", "mapping 4 0 1.0\n"),
                        device=CPU).maps[0]
    hier = hier.reshape(NFREQ, 3, -1)
    assert (hier[:, 1:].sum((0, 2)) > 0).all()
    _close(hier.sum(1), plain, "levels summed")


def test_ortho_hier(tmp_path):
    """`mapping 8 8 1.0 999`: per-level orthographic maps."""
    rt, rj, dt, dj = _both(tmp_path, "mapping 8 8 1.0 999\n")
    hier = _same_files(dt, dj, "map_dir_00_H.bin", head=4)
    plain = tdriver.run(_model(tmp_path / "plain", ""), device=CPU).maps[0]
    _close(hier.reshape(NFREQ, 3, 8, 8).sum(1), plain, "levels summed")


def test_perspective(tmp_path):
    """`perspective x y z` with a 16 x 8 map: the panorama."""
    rt, rj, dt, dj = _both(tmp_path, "perspective 3.3 4.1 4.7\n"
                           "mapping 16 8 1.0\n")
    _same_files(dt, dj, "map_dir_00.bin", head=2)


@pytest.mark.parametrize("extra", ["mapint 2\n", "yshear 2.0\n"],
                         ids=["mapint", "yshear"])
def test_ortho_modes(tmp_path, extra):
    """MAP_INTERPOLATION and the shearing-box continuation; the observer
    at theta 70 deg, so a sheared ray leaves through a Z face after about
    three box lengths."""
    extra = "directions 70.0 10.0\n" + extra
    rt, rj, dt, dj = _both(tmp_path, extra)
    _same_files(dt, dj, "map_dir_00.bin", head=2)
    _close(rt.maps[("colden", 0)], np.asarray(rj.maps[("colden", 0)]),
           "colden")
    if "yshear" in extra:
        plain = tdriver.run(_model(tmp_path / "plain",
                                   "directions 70.0 10.0\n"), device=CPU)
        assert (rt.maps[0] >= plain.maps[0] * (1 - 1e-6)).all()
        assert rt.maps[("colden", 0)].sum() \
            > 1.5 * plain.maps[("colden", 0)].sum()


def test_fits_and_savetau(tmp_path):
    """`FITS` (one file a map frequency) and `savetau` at 100 um (outside
    the `wavelength` band, so rendered but kept out of map_dir_00.bin),
    850 um and column density (-1), with their FITS companions."""
    extra = ("wavelength 500.0 3000.0\nFITS 1\ndistance 200.0\n"
             "savetau tau.bin 100.0 850.0 -1\n")
    rt, rj, dt, dj = _both(tmp_path, extra)
    band = _same_files(dt, dj, "map_dir_00.bin", head=2)
    nband = len(band) // 64
    assert 0 < nband < NFREQ
    names = sorted(f for f in os.listdir(dt) if f.endswith(".fits"))
    assert names == sorted(f for f in os.listdir(dj) if f.endswith(".fits"))
    assert len(names) == nband + 3
    maps = rt.maps[0]
    for name in names:
        data, hdr = read_fits_image(str(dt / name))
        jdata, jhdr = j_read_fits(str(dj / name))
        assert hdr == jhdr, name
        _close(data, jdata, name)
        if name.startswith("map_"):
            assert any(np.array_equal(data, m) for m in maps), name
    for k in range(3):
        payload = _same_files(dt, dj, "tau.bin_%d.0" % k, head=2)
        np.testing.assert_array_equal(
            payload, np.asarray(rt.maps[("savetau", 0, k)], np.float32)
            .ravel())
    fits = read_fits_image(str(dt / "tau.bin_colden.fits"))[0]
    np.testing.assert_array_equal(
        fits, np.asarray(rt.maps[("savetau", 0, 2)], np.float32))


def test_pssavetau(tmp_path):
    """`pssavetau` for two point sources (one outside the cloud), two
    directions: one text file a direction."""
    extra = ("pointsource 3.1 2.9 3.2 ps.bin\npointsource 2.8 3.3 14.0 "
             "ps.bin\npssavetau pstau 250.0\ndirections 0.0 0.0 90.0 "
             "30.0\n")
    for d in (tmp_path / "run_t", tmp_path / "run_j"):
        os.makedirs(d)
        np.ones(NFREQ, np.float32).tofile(d / "ps.bin")
    rt, rj, dt, dj = _both(tmp_path, extra)
    for idir in range(2):
        t = np.loadtxt(dt / ("pstau_%d.dat" % idir))
        j = np.loadtxt(dj / ("pstau_%d.dat" % idir))
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
        np.testing.assert_allclose(t[:, 1:], j[:, 1:], rtol=1e-3)
        # the source outside the cloud starts no ray: 0, in both
        assert t[0, 1] > 0 and t[1, 1] == 0


def test_roimap_keeps_nan_out(tmp_path):
    """`roimap` in the map-only mode with an emission file holding NaN in
    a cell outside the box: the map is finite, and soc_tpu's (which zeroes
    those rows on this path) agrees; without `roimap` the NaN shows."""
    lcells, _ = octree_cloud(8, *OCTREE)
    cells = int(np.sum(lcells))
    rng = np.random.default_rng(2)
    emit = rng.uniform(1e-20, 2e-20, (cells, NFREQ)).astype(np.float32)
    from soc_tpu_torch.grid import grid_from_arrays
    grid = grid_from_arrays(8, 8, 8, *octree_cloud(8, *OCTREE), CPU)
    outside = np.nonzero(~roi_cell_mask(grid, BOX))[0]
    emit[outside[len(outside) // 2]] = np.nan
    extra = "roi %d %d %d %d %d %d\nroimap\n" % BOX
    for d in (tmp_path / "run_t", tmp_path / "run_j", tmp_path / "open"):
        os.makedirs(d)
        write_cell_frequency_array(str(d / "emitted.data"), emit)
    rt, rj, dt, dj = _both(tmp_path, extra, loadtemp=False)
    maps = _same_files(dt, dj, "map_dir_00.bin", head=2)
    assert np.isfinite(maps).all()
    gated = tdriver.run(_model(tmp_path / "open", "", loadtemp=False),
                        device=CPU)
    assert not np.isfinite(gated.maps[0]).all()


def test_cli_rt_maps(tmp_path):
    """`python -m soc_tpu_torch rt` renders the Healpix map with packets
    (iterations 1): the maps' keywords pass pipeline/driver.py's checks."""
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=4,
                      extra="mapping 2 0 1.0\ninterpolate 1\n")
    assert cli.main(["rt", ini, "--device", "cpu", "--lanes", "1024"]) == 0
    assert os.path.getsize(tmp_path / "map.healpix") == 4 * 4 * 48


@pytest.mark.parametrize("extra", ["mapping 4 0 1.0\ninterpolate 1\n",
                                   "mapint 2\n", "mapping 8 8 1.0 999\n"],
                         ids=["healpix", "mapint", "ortho_hier"])
def test_maps_over_a_devices_mesh(tmp_path, extra):
    """Under `devices 2` (two CPU shards) these maps render on the first
    shard's device, as soc_tpu falls back: the same map as one device,
    bit for bit."""
    one = tdriver.run(_model(tmp_path / "one", extra), device=CPU)
    two = tdriver.run(_model(tmp_path / "two", extra + "devices 2\n"),
                      device=CPU)
    assert two.devices is not None and len(two.devices) == 2
    for key in one.maps:
        np.testing.assert_array_equal(two.maps[key], one.maps[key])
