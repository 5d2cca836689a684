"""soc_tpu_torch against soc_tpu: the scattered-light pipeline
(pipeline/scattering.py, the `sca` verb) on example_model inputs: a 16^3
uniform cloud and a 3-level octree (an 8^3 root), the equilibrium dust at
8 channels with `simum 0.05 3.0` (three channels simulated), every source
of soc_tpu's scattering.run alone and all together, WITH_MSF with
abundances, the internal observer, `fits 1` and `ffs 0`.

soc_tpu runs a pool a channel and source, the port one mixed pool a
source, on the same packet streams. Tolerances and why:
  * the container's int32 header and its frequencies: equal;
  * the maps, channel by channel: every pixel within 1e-4 of the
    channel's peak but for at most 3% of the pixels (those that a packet
    reaches whose path an ulp of XLA's exp/log turned elsewhere: one of
    64 pixels in the octree runs), and the channel's sum within 1e-3;
  * FITS planes: bit for bit the returned array (the same float32 values
    written and read back);
  * _hpbg_projected_area: 1e-6 relative (the same float32 Healpix
    centres);
  * `devices 2` on the CPU against one device: soc_tpu's own bound for
    its sharded run (tests/test_sca_pipeline.py: rtol 2e-4, atol 1e-6 of
    the peak); the shards trace the same packets, the deposits add in
    another order.
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu.grid import uniform_grid as juniform_grid
from soc_tpu.pipeline import scattering as jsca

from soc_tpu_torch import cli
from soc_tpu_torch.example_model import write_sca_model
from soc_tpu_torch.grid import uniform_grid
from soc_tpu_torch.io.fits import read_fits_image
from soc_tpu_torch.pipeline import scattering as tsca

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 4096
NFREQ = 8
SIMUM = (0.05, 3.0)
OCTREE = (2, 8, 3)
PS = [(8.1, 7.9, 8.2, 0.3), (7.5, 8.3, 30.0, 1.0)]

CASES = {
    "bg": dict(n=16),
    "hpbg": dict(n=16, hpbg=4, background=False),
    "ps": dict(n=16, bgpac=0, point_sources=PS, pspackets=3000),
    "cell": dict(n=16, bgpac=0, emitted=0.5, cellpackets=2 * 4096),
    "roi": dict(n=16, bgpac=0, roiload=(0.5, 30000)),
    "diffuse": dict(n=16, bgpac=0, diffuse=0.5, dfpackets=2 * 4096),
    "all_octree": dict(n=8, octree=OCTREE, hpbg=4,
                       point_sources=[(4.1, 3.9, 4.2, 0.3)], pspackets=2000,
                       emitted=0.3, cellpackets=1280, diffuse=0.3,
                       dfpackets=1280),
    "msf_octree": dict(n=8, octree=OCTREE, abundance=True),
    "intobs": dict(n=16, intobs=(8.3, 7.7, 8.1), outnside=8),
    "fits": dict(n=16, fits=True, extra="scattering scat\n"
                                        "distance 100.0\n"),
    "ffs0": dict(n=16, ffs=0),
}


def _model(tmp_path, name, **more):
    kw = dict(CASES[name], **more)
    n = kw.pop("n")
    return write_sca_model(str(tmp_path), n, nfreq=NFREQ, simum=SIMUM, **kw)


def _container(path):
    with open(path, "rb") as fp:
        raw = fp.read()
    return raw


def _close_maps(got, ref):
    assert got.shape == ref.shape
    lit = 0
    for f in range(ref.shape[0]):
        a, b = got[f], ref[f]
        if not b.any():
            assert not a.any(), f
            continue
        lit += 1
        diff = np.abs(a - b)
        assert (diff > 1e-4 * b.max()).mean() <= 0.03, (f, diff.max())
        assert abs(a.sum() / b.sum() - 1) < 1e-3, f
    return lit


@pytest.mark.parametrize("name", list(CASES))
def test_scattering_run_matches_soc_tpu(tmp_path, name):
    """scattering.run of one ini, port against soc_tpu (each writing its
    outputs into its own copy of the model): the three channels of the
    band lit and the others empty, the maps within the bounds above, the
    outcoming.socs header and frequencies equal, or with `fits 1` the
    FITS cube bit for bit the returned array's direction 0."""
    ini_t = _model(tmp_path / "t", name)
    ini_j = _model(tmp_path / "j", name)
    passes = []
    out_t = tsca.run(ini_t, device=CPU, lanes=LANES, passes=passes)
    out_j = jsca.run(ini_j, nlanes=LANES)
    assert np.isfinite(out_t).all() and (out_t >= 0).all()
    assert _close_maps(out_t, out_j) == 3
    assert all(p["rays"] == p["events"] * out_t.shape[1]
               if out_t.ndim == 4 else p["rays"] == p["events"]
               for p in passes)
    assert all(p["pools"] == 1 and p["channels"] == 3 for p in passes)
    if name == "fits":
        for d in ("t", "j"):
            assert not (tmp_path / d / "outcoming.socs").exists()
        data, _ = read_fits_image(str(tmp_path / "t" / "scat.fits"))
        np.testing.assert_array_equal(data, out_t[:, 0])
        ref, _ = read_fits_image(str(tmp_path / "j" / "scat.fits"))
        _close_maps(data, ref)
        return
    raw_t = _container(tmp_path / "t" / "outcoming.socs")
    raw_j = _container(tmp_path / "j" / "outcoming.socs")
    nhead = 8 if name == "intobs" else 12
    assert raw_t[:nhead + 4 * NFREQ] == raw_j[:nhead + 4 * NFREQ]
    head = np.frombuffer(raw_t[:nhead], np.int32)
    maps = np.frombuffer(raw_t[nhead + 4 * NFREQ:], np.float32)
    np.testing.assert_array_equal(maps.reshape(out_t.shape), out_t)
    if name == "intobs":
        assert head.tolist() == [8, NFREQ]
        assert out_t.shape == (NFREQ, 12 * 8 * 8)
    else:
        assert head.tolist() == [out_t.shape[2], out_t.shape[3], NFREQ]


def test_pools_a_channel_equal_the_mixed_pool(tmp_path):
    """per_channel=True runs soc_tpu's schedule, a pool a channel and
    source: the maps equal the mixed pool's to the order of the deposits
    (1e-5 of each channel's peak), three pools against one, on the octree
    with the point source, the cell emission and MSF."""
    ini = _model(tmp_path, "msf_octree", bgpac=0, emitted=0.3,
                 cellpackets=1280, point_sources=[(4.1, 3.9, 4.2, 0.3)],
                 pspackets=2000)
    mixed, chans = [], []
    out_m = tsca.run(ini, device=CPU, lanes=LANES, passes=mixed)
    out_c = tsca.run(ini, device=CPU, lanes=LANES, per_channel=True,
                     passes=chans)
    for f in range(NFREQ):
        np.testing.assert_allclose(out_c[f], out_m[f], rtol=0,
                                   atol=1e-5 * max(out_m[f].max(), 1e-30))
    assert [p["pools"] for p in mixed] == [1] * 2
    assert [p["pools"] for p in chans] == [3] * 2
    assert [p["events"] for p in mixed] == [p["events"] for p in chans]


def test_missing_emitted_file_raises(tmp_path):
    """`cellpackets` with no emitted file raises FileNotFoundError in both
    packages rather than drop the dust-emission source."""
    for d, run in (("t", lambda ini: tsca.run(ini, device=CPU)),
                   ("j", jsca.run)):
        ini = write_sca_model(str(tmp_path / d), 8, nfreq=NFREQ, bgpac=0,
                              cellpackets=1024)
        with pytest.raises(FileNotFoundError, match="emitted"):
            run(ini)


def test_hpbg_projected_area():
    """The Healpix sky's per-pixel projected-area weights, soc_tpu's at
    1e-6: mean 1 over the sphere, the long faces weighted up on a 16x4x4
    cloud, at most sqrt(3) anisotropy on a cube."""
    for dims, npix in (((16, 4, 4), 12 * 16 * 16), ((8, 8, 8), 12 * 4 * 4)):
        got = tsca._hpbg_projected_area(uniform_grid(*dims, CPU), npix)
        ref = jsca._hpbg_projected_area(juniform_grid(*dims), npix)
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        np.testing.assert_allclose(got.mean(), 1.0, rtol=1e-3)
    assert got.max() / got.min() < np.sqrt(3) + 0.01


@pytest.mark.parametrize("name", ["bg", "intobs"])
def test_devices_two_on_cpu_match_one(tmp_path, name):
    """`devices 2` with --device cpu: each source's budget split over two
    CPU shards by id range (simulate_scattering_sharded), the maps summed:
    equal to the one-device run within soc_tpu's bound for its sharded run
    (rtol 2e-4, atol 1e-6 of the peak), orthographic and Healpix."""
    ini = _model(tmp_path, name)
    one = tsca.run(ini, device=CPU, lanes=LANES)
    with open(ini, "a") as fp:
        fp.write("devices 2\n")
    passes = []
    two = tsca.run(ini, device=CPU, lanes=LANES, passes=passes)
    assert one.sum() > 0
    np.testing.assert_allclose(two, one, rtol=2e-4, atol=1e-6 * one.max())
    assert passes[0]["events"] > 0


def test_sca_verb(tmp_path, capsys):
    """python -m soc_tpu_torch sca: with --device cpu it runs and writes
    outcoming.socs (exit 0, the container's shape printed); with no
    --device it asks for the card, and where there is none exits 2."""
    ini = _model(tmp_path, "ffs0")
    res = {}
    assert cli.main(["sca", ini, "--device", "cpu", "--lanes", "2048"],
                    results=res) == 0
    assert "soc_tpu_torch sca done" in capsys.readouterr().out
    assert res["sca"].shape == (NFREQ, 1, 16, 16)
    assert os.path.exists(tmp_path / "outcoming.socs")
    if not torch.cuda.is_available():
        assert cli.main(["sca", ini]) == 2
