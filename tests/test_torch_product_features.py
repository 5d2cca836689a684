"""`devices N` with every keyword soc_tpu's product path runs: the port's
run over N CPU shards against its own one-device run of the same model
(port only, no JAX compile), at N = 4 (dp 2 x freq 2) and N = 6 (dp 3 x
freq 2, 8 channels); and `split` on an octree, held statistically.

Tolerances, each with its reason:
  * every keyword but `split`: the same packets on the same streams, only
    the order of the float32 additions differs (one pool a shard, the dp
    partials folded in shard order): 1e-5 relative and 1e-6 of the
    maximum absolute on every per-cell field; escaped (float64 sums)
    1e-6 relative;
  * `split`: which clones a pool serves depends on its lane count and
    refill order, so the split background is held as chip_smoke phase
    12 (a) holds it: the refined leaves' absorption within five times the
    spread of the differences of 16 cell groups, the energy balance per
    channel within 1e-5.
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.transport.roi import roi_nelem, write_roi_file

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12
SOURCES = [(2.1, 1.9, 2.2, 0.3), (-2.0, 2.0, 2.0, 1.0)]
FIELDS = ("absorbed", "ctabs", "emitted", "temperature", "intensity",
          "roi_tally")


def write_roi_load(d, nfreq, seed=3):
    """A ROI file of a 2 x 2 x 2 box at nside 1 (random photons) in d;
    returns the ini lines that load it."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    nelem = roi_nelem(2, 2, 2)
    write_roi_file(os.path.join(d, "load.roi"), 2, 2, 2, 1,
                   rng.random((nfreq, nelem * 12)).astype(np.float32)
                   * 1e-3)
    return "roiload load.roi\nroipackets %d\n" % (nelem * 12 * 4)


def close(a, b, name):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=1e-6 * np.abs(b).max(), err_msg=name)


def mesh_vs_one(tmp_path, devices=4, extra="", n=4, nfreq=6, roiload=False,
                **kw):
    """The model with `devices N` (None: as written, one device) against
    the same model on one device, without the keyword; returns (one-device
    result, mesh result)."""
    runs = {}
    for name, dev in (("one", None), ("mesh", devices)):
        d = str(tmp_path / name)
        ex = extra + (write_roi_load(d, nfreq) if roiload else "")
        if dev is not None:
            ex += "devices %d\n" % dev
        ini = write_model(d, n, kind="eqdust", nfreq=nfreq, extra=ex, **kw)
        runs[name] = tdriver.run(ini, device=CPU, lanes=LANES)
    one, mesh = runs["one"], runs["mesh"]
    if devices is not None:
        assert mesh.devices == [CPU] * devices
        assert all(st["route"] == "mesh" for st in mesh.source_passes)
        assert all(st["mesh"] for st in mesh.cell_passes)
    assert len(mesh.cell_passes) == len(one.cell_passes)
    for name in FIELDS:
        if getattr(one, name) is not None:
            close(getattr(mesh, name), getattr(one, name), name)
    if 0 in one.maps:
        close(mesh.maps[0], one.maps[0], "map")
    np.testing.assert_allclose(mesh.escaped, one.escaped, rtol=1e-6,
                               atol=1e-12 * np.abs(one.escaped).max())
    np.testing.assert_allclose(mesh.injected, one.injected, rtol=1e-12)
    if one.launched is not None:
        np.testing.assert_allclose(mesh.launched, one.launched, rtol=1e-6)
        np.testing.assert_allclose(mesh.missed, one.missed, rtol=1e-6,
                                   atol=1e-12 * one.launched.max())
    for a, b in zip(mesh.cell_passes, one.cell_passes):
        assert a["packets"] == b["packets"]
        # a pass re-emits the previous solve's emission: held as the fields
        np.testing.assert_allclose(a["injected"], b["injected"], rtol=1e-5)
        np.testing.assert_allclose(a["escaped"], b["escaped"], rtol=1e-6,
                                   atol=1e-12 * np.abs(b["escaped"]).max())
    return one, mesh


CASES = {
    "cellpackets": dict(cellpackets=1280, iterations=3),
    "ali": dict(cellpackets=1280, iterations=3, extra="ali 1\n"),
    "reference": dict(cellpackets=1280, iterations=3,
                      extra="reference 1\nali 1\n"),
    "subiterations": dict(cellpackets=1280, iterations=4,
                          extra="SUBITERATIONS\n"),
    "emweight 1": dict(cellpackets=1280, iterations=3,
                       extra="emweight 1 0 100\n"),
    "emweight 2": dict(cellpackets=1280, iterations=3,
                       extra="emweight 2 0 100\n"),
    "pointsource 4": dict(point_sources=SOURCES, pspackets=400, ps_method=4),
    "hpbgw": dict(hpbg=2, hpbg_weighted=True),
    "diffuse emweight": dict(diffuse=0.5, cellpackets=640,
                             extra="emweight 1\n"),
    "abundance": dict(abundance=True, optishalf=True),
    "saveint 2": dict(saveint=2),
    "dustem": dict(extra="dustem\n"),
    "simum": dict(simum=(1.0, 100.0)),
    "roisave": dict(extra="roi 1 2 1 2 1 2\nroisave roi.bin 1\n"),
    "roiload": dict(roiload=True, bgpac=0),
    "mirror": dict(extra="mirror xyz\n"),
    "weighting": dict(extra="stepweight 2 1.3 0.4\ndireweight 1 0.5\n"),
    "mmapabs": dict(extra="mmapabs\n"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_devices_6_runs_every_keyword(tmp_path, name):
    """dp 3 x freq 2 over 8 channels, each formerly refused keyword
    against the one-device run."""
    kw = dict(CASES[name])
    one, mesh = mesh_vs_one(tmp_path, devices=6, nfreq=8, **kw)
    assert len(mesh.devices) == 6
    if "roisave" in name:
        assert mesh.roi_tally.sum() > 0
    if kw.get("cellpackets") and "diffuse" not in name:
        assert len(mesh.cell_passes) >= 2


def test_devices_split_octree_statistically(tmp_path):
    """The split background on a 3-level octree under `devices 4`: the
    balance per channel (born outside included) closes, clones are
    served, and the refined leaves' absorption agrees with the
    one-device run within five times the spread of 16 cell groups'
    differences (which clones a pool serves depends on its lanes)."""
    runs = {}
    for name, extra in (("one", ""), ("mesh", "devices 4\n")):
        ini = write_model(str(tmp_path / name), 8, kind="eqdust", nfreq=6,
                          octree=(2, 8, 3), split=4, extra=extra)
        runs[name] = tdriver.run(ini, device=CPU, lanes=LANES)
    one, mesh = runs["one"], runs["mesh"]
    st = mesh.source_passes[0]
    assert st["route"] == "mesh" and st["clones"] > 0
    on = mesh.launched > 0
    bal = (mesh.absorbed_photons + mesh.escaped + mesh.missed)[on] \
        / mesh.launched[on] - 1
    assert np.abs(bal).max() < 1e-5
    leaves = np.nonzero(mesh.absorbed[:, 0] > -1e19)[0]
    leaves = leaves[leaves >= 512]          # below the root level
    a = mesh.absorbed[leaves].sum(1).astype(np.float64)
    b = one.absorbed[leaves].sum(1).astype(np.float64)
    groups = np.array_split(np.arange(len(leaves)), 16)
    diffs = np.asarray([a[g].sum() - b[g].sum() for g in groups])
    assert abs(diffs.sum()) < 5.0 * diffs.std() * np.sqrt(len(groups)) \
        + 1e-6 * b.sum()
    np.testing.assert_allclose(a.sum(), b.sum(), rtol=0.05)


@pytest.mark.parametrize("n_dp", [2, 3])
def test_shard_pools_cover_each_packet_once(n_dp):
    """sources.pool_params with uneven budgets (EMWEI's) split over dp as
    run_freqs splits them: the shards' (channel, k) identities are the
    one pool's, each once, and each shard's maps slice gives each packet
    its cell."""
    from soc_tpu_torch.transport.sources import packet_identity, pool_params
    rng = np.random.default_rng(n_dp)
    sel = np.array([0, 2, 3, 5])
    counts = rng.integers(1, 40, len(sel))
    maps = [rng.integers(0, 64, c) for c in counts]
    one = pool_params({}, sel, counts, 0, CPU, maps=maps)
    n = int(counts.sum())
    k, f, _ = packet_identity(torch.arange(n), one)
    want = sorted(zip(f.tolist(), k.tolist(),
                      one["cell_of_id"][torch.arange(n)].tolist()))
    got = []
    q, r = np.divmod(counts, n_dp)
    for dp in range(n_dp):
        mine = q + (dp < r)
        k0 = dp * q + np.minimum(dp, r)
        p = pool_params({}, sel, mine, 0, CPU, k0=k0,
                        maps=[m[a:a + c] for m, a, c in zip(maps, k0, mine)])
        ids = torch.arange(int(mine.sum()))
        k, f, _ = packet_identity(ids, p)
        got += zip(f.tolist(), k.tolist(), p["cell_of_id"][ids].tolist())
    assert sorted(got) == want
