"""The ROI coupling (`roi`, `roisave`, `roinside`, `roiload`,
`roipackets`): Healpix pixels of directions, the ROI module, the ROI
boundary source, the crossing tally and the two-stage round trip, the port
against soc_tpu.

Tolerances, each with its reason:
  * ang2pix_ring: bit for bit but for directions within an ulp of a pixel
    edge, where XLA's cos differs from torch's: at most 1e-4 of the
    directions may land in another pixel (counted);
  * the ROI cell mask, the element index (float32 comparisons and
    truncations in the same order) and the ROI file: bit for bit;
  * gen_roi: integers, weights and positions bit for bit, directions
    through sin/cos at 2e-6;
  * pipeline/driver.py's ROI tally and absorbed file against soc_tpu's
    per-channel pools: a rare packet takes another path where XLA's
    exp/log/cos/sin differ from torch's (tests/test_torch_transport.py):
    99% of the entries at 1e-4 (of the entry, or 1e-7 of the maximum),
    per-channel totals at 2e-3; the entries that differ are counted;
  * the round trip at soc_tpu's bounds (tests/test_roi.py): the sub-model
    absorbs and lets escape the injected weight within 1% a channel, and
    absorbs within 10% of what the first run absorbed inside the box.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
from soc_tpu.grid import uniform_grid as j_uniform_grid
from soc_tpu.pipeline import driver as jdriver
from soc_tpu.render import healpix as jhp
from soc_tpu.transport import roi as jroi
from soc_tpu.transport import sources as jsrc

from soc_tpu_torch import cli
from soc_tpu_torch.example_model import octree_cloud, write_model
from soc_tpu_torch.grid import grid_from_arrays as t_grid_from_arrays
from soc_tpu_torch.grid import uniform_grid as t_uniform_grid
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.render import healpix as thp
from soc_tpu_torch.transport import roi as troi
from soc_tpu_torch.transport import sources as tsrc

from test_torch_phase2 import close_arrays, close_fields

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12
NFREQ = 6
OCTREE = (2, 8, 3)          # an 8^3 root, its central 2^3 refined: 640 cells
# a 6 x 2 x 6 box of root cells inside the cloud, clear of its refined
# block (3..4 on every axis) and of its faces (where background packets
# are born inside the box, never crossing into it)
BOX = (1, 6, 1, 2, 1, 6)
ROI_NSIDE = 2
NELEM = 2 * 6 + 6 * 6 + 6 * 2
ROI_PACKETS = 8 * NELEM * 48   # 8 a (element, pixel) pair


def _octree():
    lcells, values = octree_cloud(8, *OCTREE)
    return (j_grid_from_arrays(8, 8, 8, lcells, values),
            t_grid_from_arrays(8, 8, 8, lcells, values, CPU))


@pytest.mark.parametrize("nside", [1, 2, 8, 64])
def test_ang2pix_ring_matches_soc_tpu(nside):
    """Random directions and every pixel's centre, in torch and NumPy."""
    rng = np.random.default_rng(nside)
    d = rng.normal(size=(100000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    theta = np.arccos(np.clip(d[:, 2], -1, 1)).astype(np.float32)
    phi = np.arctan2(d[:, 1], d[:, 0]).astype(np.float32)
    centre_t, centre_p = jhp.pix2ang_ring(
        nside, jnp.arange(12 * nside * nside))
    theta = np.concatenate([theta, np.asarray(centre_t)])
    phi = np.concatenate([phi, np.asarray(centre_p)])
    ref = np.asarray(jhp.ang2pix_ring(nside, jnp.asarray(theta),
                                      jnp.asarray(phi)))
    got = thp.ang2pix_ring(nside, torch.as_tensor(theta),
                           torch.as_tensor(phi)).numpy()
    got_np = thp.ang2pix_ring_np(nside, theta, phi)
    for g in (got, got_np):
        edge = int((g != ref).sum())
        assert edge <= 1e-4 * len(ref), edge
    assert got.min() >= 0 and got.max() < 12 * nside * nside
    np.testing.assert_array_equal(got[-12 * nside * nside:],
                                  np.arange(12 * nside * nside))


@pytest.mark.parametrize("box", [(2, 5, 3, 4, 1, 6), BOX, (0, 7, 0, 7, 0, 7)])
def test_roi_cell_mask_matches_soc_tpu(box):
    """On the octree (the first box holds the refined block: its children
    inherit the mask) and on a uniform grid."""
    jg, tg = _octree()
    np.testing.assert_array_equal(troi.roi_cell_mask(tg, box),
                                  jroi.roi_cell_mask(jg, box))
    ju, tu = j_uniform_grid(8, 8, 8), t_uniform_grid(8, 8, 8, CPU)
    np.testing.assert_array_equal(troi.roi_cell_mask(tu, box),
                                  jroi.roi_cell_mask(ju, box))


@pytest.mark.parametrize("step", [1, 2])
def test_roi_element_index_matches_soc_tpu(step):
    """Root positions on and near every face of the box (and its edges
    and corners, where the later checks override the earlier ones)."""
    box = (2, 5, 3, 4, 1, 6)
    rnx, rny, rnz = 4 * step, 2 * step, 6 * step
    rng = np.random.default_rng(step)
    lo = np.asarray([2, 3, 1], np.float32)
    hi = np.asarray([6, 5, 7], np.float32)
    rp = rng.uniform(lo - 0.01, hi + 0.01, (20000, 3)).astype(np.float32)
    # snap a share of the coordinates onto the faces
    for ax in range(3):
        pick = rng.random(len(rp)) < 0.3
        rp[pick, ax] = np.where(rng.random(pick.sum()) < 0.5,
                                lo[ax] + 2e-4, hi[ax] - 2e-4)
    ref = np.asarray(jroi.roi_element_index(
        jnp.asarray(rp), None, box, rnx, rny, rnz, float(step)))
    got = troi.roi_element_index(torch.as_tensor(rp), box, rnx, rny, rnz,
                                 float(step)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) > 0.9 * troi.roi_nelem(rnx, rny, rnz)


def test_roi_file_matches_soc_tpu(tmp_path):
    """Written byte for byte, read back equal."""
    rng = np.random.default_rng(0)
    data = rng.random((3, troi.roi_nelem(4, 3, 2) * 48)).astype(np.float32)
    troi.write_roi_file(tmp_path / "t.bin", 4, 3, 2, 2, data)
    jroi.write_roi_file(tmp_path / "j.bin", 4, 3, 2, 2, data)
    assert (tmp_path / "t.bin").read_bytes() \
        == (tmp_path / "j.bin").read_bytes()
    back = troi.read_roi_file(tmp_path / "j.bin")
    assert back[:4] == (4, 3, 2, 2)
    np.testing.assert_array_equal(back[4], data)


def test_gen_roi_per_packet():
    """The mixed pool's ROI packets lane by lane against soc_tpu's
    per-channel generator: every (element, pixel) pair, three channels."""
    rng = np.random.default_rng(1)
    dims, nelem, npx, reps = (4, 3, 5), 3 * 5 + 4 * 5 + 4 * 3, 48, 2
    load = rng.random((3, nelem, npx)).astype(np.float32)
    jg, tg = j_uniform_grid(4, 3, 5), t_uniform_grid(4, 3, 5, CPU)
    pf = reps * nelem * npx
    hi = int(jsrc.stream_hi_base("roi"))
    ids = np.arange(pf)
    tb = tsrc.gen_roi(tg, torch.arange(3 * pf), 77,
                      dict(roi_load=torch.as_tensor(load), roi_dim=dims,
                           reps=reps, per_freq=pf, hi_base=hi))
    for f in range(3):
        jb = jsrc.gen_roi(jg, jnp.asarray(ids, jnp.int32), 77, dict(
            roi_load=jnp.asarray(load[f]), roi_dim=dims,
            reps=jnp.int32(reps), ifreq=jnp.int32(f),
            per_freq=jnp.int32(pf), hi_base=jnp.uint32(hi)))
        lanes = slice(f * pf, (f + 1) * pf)
        for k in ("level", "ind", "ifreq", "stream", "hi", "counter"):
            np.testing.assert_array_equal(
                getattr(tb, k)[lanes].numpy(),
                np.asarray(getattr(jb, k)).astype(np.int64), err_msg=k)
        for k in ("pos", "photons"):
            np.testing.assert_array_equal(getattr(tb, k)[lanes].numpy(),
                                          np.asarray(getattr(jb, k)))
        np.testing.assert_allclose(tb.dir[lanes].numpy(),
                                   np.asarray(jb.dir), rtol=0, atol=2e-6)


def _stage_a(d, extra=""):
    """rt on the octree with the ROI save of BOX."""
    return write_model(str(d), 8, kind="eqdust", nfreq=NFREQ, octree=OCTREE,
                       bgpac=4 * 8 * 6 * 64,
                       extra="roi %d %d %d %d %d %d\nroisave roi.bin 1\n"
                             "roinside %d\n" % (BOX + (ROI_NSIDE,)) + extra)


def _stage_b(d, roi_file):
    """rt on BOX's sub-model, loading the ROI file."""
    return write_model(str(d), 8, kind="eqdust", nfreq=NFREQ, octree=OCTREE,
                       roi_box=BOX, bgpac=0, npix=3,
                       extra="roiload %s\nroipackets %d\n"
                             % (roi_file, ROI_PACKETS))


@pytest.fixture(scope="module")
def two_stage(tmp_path_factory):
    """Both stages through both packages; soc_tpu's second stage loads
    the port's ROI file, so the two second stages trace the same
    packets."""
    base = tmp_path_factory.mktemp("roi")
    out = {}
    for pkg, drv, kw in (("t", tdriver, dict(device=CPU)), ("j", jdriver,
                                                            {})):
        a = _stage_a(base / ("a_" + pkg))
        out["a_" + pkg] = drv.run(a, lanes=LANES, **kw)
    roi_file = str(base / "a_t" / "roi.bin")
    for pkg, drv, kw in (("t", tdriver, dict(device=CPU)), ("j", jdriver,
                                                            {})):
        b = _stage_b(base / ("b_" + pkg), roi_file)
        out["b_" + pkg] = drv.run(b, lanes=LANES, **kw)
    out["dir"] = base
    return out


def test_roisave_matches_soc_tpu(two_stage):
    """The ROI file (header bit for bit, the tally as stated) and the
    absorbed file of the run that saved it."""
    base = two_stage["dir"]
    t = np.fromfile(base / "a_t" / "roi.bin", np.float32)
    j = np.fromfile(base / "a_j" / "roi.bin", np.float32)
    np.testing.assert_array_equal(t[:5].view(np.int32), [6, 2, 6, 2,
                                                         NFREQ])
    np.testing.assert_array_equal(t[:5], j[:5])
    tally_t, tally_j = t[5:].reshape(NFREQ, -1), j[5:].reshape(NFREQ, -1)
    close_arrays(tally_t.T.copy(), tally_j.T.copy(), "roi.bin", NFREQ)
    diverged = np.sum(~np.isclose(tally_t, tally_j, rtol=1e-4,
                                  atol=1e-7 * tally_j.max()))
    assert diverged <= 0.01 * tally_j.size, diverged
    np.testing.assert_array_equal(two_stage["a_t"].roi_tally, tally_t)
    for name in ("absorbed.data", "tmp.T"):
        close_fields(np.fromfile(base / "a_t" / name, np.float32),
                     np.fromfile(base / "a_j" / name, np.float32), name,
                     NFREQ)
    assert (tally_t >= 0).all() and (tally_t.sum(1) > 0).all()


def test_roiload_matches_soc_tpu(two_stage):
    """The sub-model's run from the same ROI file: absorbed file,
    temperatures, injected and escaped weights."""
    base = two_stage["dir"]
    t, j = two_stage["b_t"], two_stage["b_j"]
    for name in ("absorbed.data", "tmp.T"):
        close_fields(np.fromfile(base / "b_t" / name, np.float32),
                     np.fromfile(base / "b_j" / name, np.float32), name,
                     NFREQ)
    np.testing.assert_allclose(t.injected, j.injected, rtol=1e-12)
    np.testing.assert_allclose(t.escaped, j.escaped, rtol=2e-3)
    roi = [st for st in t.source_passes if st["source"] == "roi"]
    assert len(roi) == 1 and roi[0]["pools"] == 1
    assert roi[0]["packets"] == NFREQ * ROI_PACKETS


def test_roi_round_trip(two_stage):
    """soc_tpu's coupling bounds: the sub-model balances the injected
    weight within 1% a channel, and absorbs within 10% of the energy the
    first run absorbed inside the box."""
    a, b = two_stage["a_t"], two_stage["b_t"]
    bal = (b.absorbed_photons + b.escaped) / b.injected - 1
    assert np.abs(bal).max() < 0.01, bal
    np.testing.assert_allclose(b.injected,
                               a.roi_tally.sum(1, dtype=np.float64),
                               rtol=1e-6)
    mask = troi.roi_cell_mask(a.grid, BOX)
    direct = a.ctabs[mask].astype(np.float64).sum()
    sub = b.ctabs.astype(np.float64).sum()
    assert abs(sub - direct) / direct < 0.1, (sub, direct)


def test_cli_rt_roi(tmp_path):
    """`python -m soc_tpu_torch rt` takes the ROI keywords."""
    ini = _stage_a(tmp_path / "a", "mirror zZ\n")
    assert cli.main(["rt", ini, "--device", "cpu", "--lanes", "4096"]) == 0
    assert os.path.getsize(tmp_path / "a" / "roi.bin") \
        == 4 * (5 + NFREQ * NELEM * 48)


def test_roi_tally_with_mirrors_on_the_octree_matches_soc_tpu():
    """The crossing tally with the low faces mirrored on the octree (the
    reflected lanes re-indexed to their leaves), at the transport level:
    soc_tpu's per-channel pools against the port's mixed pool, the same
    packets; the tally as pipeline/driver.py's, the diverged entries
    counted."""
    from soc_tpu.io.dust import hg_scattering_function
    from soc_tpu.transport import propagate as jprop
    from soc_tpu_torch.transport import propagate as tprop
    nf = 3
    kabs = np.asarray([0.3, 0.8, 2.0], np.float32)
    ksca = np.asarray([0.3, 0.2, 1.0], np.float32)
    _, csc = hg_scattering_function([0.0, 0.4, 0.7], 64)
    photons = np.asarray([1.0, 2.0, 0.5], np.float32)
    jg, tg = _octree()
    mask = troi.roi_cell_mask(tg, BOX)
    nelem, npx = NELEM, 12 * ROI_NSIDE ** 2
    n = 4 * 8 * 6 * 64
    hi = int(jsrc.stream_hi_base("bg"))
    ref = np.zeros((nf, nelem * npx), np.float32)
    for f in range(nf):
        phys = dict(kabs=jnp.float32(kabs[f]), ksca=jnp.float32(ksca[f]),
                    csc=jnp.asarray(csc[f]), tw=jnp.float32(1.0),
                    roi_mask=jnp.asarray(mask), roi_box=tuple(BOX),
                    roi_dim=(6, 2, 6, 1.0))
        params = dict(photons=jnp.float32(photons[f]), ifreq=jnp.int32(f),
                      per_freq=jnp.int32(n), hi_base=jnp.uint32(hi))
        out = jprop.transport_run(
            jg, phys, params, jnp.int32(n), jnp.zeros(jg.cells, jnp.float32),
            jnp.zeros((1, 1), jnp.float32), 31, source_kind="bg",
            nlanes=LANES, roi_nside=ROI_NSIDE, mirror_mask=21,
            roi_tally=jnp.zeros(nelem * npx, jnp.float32))
        ref[f] = np.asarray(out[4])
    tally = torch.zeros((nf, nelem * npx))
    tprop.transport_run(
        tg, dict(kabs=torch.as_tensor(kabs), ksca=torch.as_tensor(ksca),
                 csc=torch.as_tensor(csc), tw=torch.ones(nf)),
        dict(photons=torch.as_tensor(photons), per_freq=n, hi_base=hi),
        n * nf, torch.zeros(tg.cells), torch.zeros((1, 1)), 31,
        source_kind="bg", nlanes=LANES, mirror_mask=21,
        roi=dict(mask=torch.as_tensor(mask), box=BOX, dim=(6, 2, 6, 1.0),
                 nside=ROI_NSIDE, tally=tally))
    got = tally.numpy()
    assert (ref.sum(1) > 0).all()
    close_arrays(got.T.copy(), ref.T.copy(), "roi tally", nf)
