"""soc_tpu_torch against soc_tpu: the scattered-light engine
(render/scattered.py), on a uniform 8^3 grid and a 3-level octree (an 8^3
root, example_model.octree_cloud), with Henyey-Greenstein tables.

Tolerances and why:
  * _ffs_hash2 is integer arithmetic: bit for bit.
  * The marches (_march_tau, _march_ffs) do the same float32 steps; XLA's
    exp, expm1 and log1p differ from torch's by ulps, so tau and the FFS
    weight agree to 1e-5 relative, and the reservoir's candidate cell (a
    uniform against a ratio of those values) on at least 99% of rays.
  * Packets keep soc_tpu's streams, so the events of spawn +
    propagate_events are the same rows; a packet whose path an ulp turns
    elsewhere gives other rows, so at least 99% of the rows are matched
    (cell equal, position to 1e-3).
  * Peel-off of the same events: the same marches and deposits, summed in
    another order: 1e-5 of the map's peak.
  * Whole runs (simulate_scattering, one channel at a time): each pixel
    within 1e-4 of the peak, but for at most 3% of the pixels (those a
    diverged packet reaches), and the map's sum within 1e-3.
  * The mixed pool of three channels against the sum of the port's
    single-channel runs: the same packets, the deposits in another order:
    1e-5 of the peak.
  * The physics checks are soc_tpu's own tests/test_scattered.py on the
    port, with their bounds (single-scattering normalisation 4%).
"""

import collections

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.grid import grid_from_arrays as jgrid_from_arrays
from soc_tpu.grid import uniform_grid as juniform_grid
from soc_tpu.ops import traverse as jtraverse
from soc_tpu.render import scattered as js
from soc_tpu.render.mapping import observer_basis

from soc_tpu_torch.example_model import octree_cloud
from soc_tpu_torch.grid import grid_from_arrays, uniform_grid
from soc_tpu_torch.io.dust import hg_scattering_function
from soc_tpu_torch.ops import traverse
from soc_tpu_torch.render import scattered as ts

torch.set_num_threads(2)
CPU = torch.device("cpu")
NX = 8
BINS = 256
G = (0.0, 0.5, -0.3)                 # the channels' HG asymmetries
KSCA = (8e-2, 0.3, 2e-3)
KABS = (1e-2, 0.1, 0.0)
LANES, CAP = 1 << 10, 1 << 14


def _grids(kind):
    if kind == "uniform":
        return (juniform_grid(NX, NX, NX, density=1.0),
                uniform_grid(NX, NX, NX, CPU, 1.0))
    lcells, values = octree_cloud(NX, 2, 8, 3)
    return (jgrid_from_arrays(NX, NX, NX, lcells, values),
            grid_from_arrays(NX, NX, NX, lcells, values, CPU))


def _msf_tables(cells):
    """Two species: HG g 0.6 and -0.2 at every channel, abundances from a
    seed, scattering U(0.5, 1.5) times the channel's KSCA."""
    rng = np.random.default_rng(7)
    d1, c1 = hg_scattering_function([0.6] * 3, BINS)
    d2, c2 = hg_scattering_function([-0.2] * 3, BINS)
    abu = rng.uniform(0.2, 1.0, (cells, 2)).astype(np.float32)
    sca = (rng.uniform(0.5, 1.5, (2, 3)) * np.asarray(KSCA)).astype(
        np.float32)
    return np.stack([d1, d2]), np.stack([c1, c2]), abu, sca


def _physics(cells, msf=False):
    """(port physics over the three channels, soc_tpu physics of channel
    f as a function)."""
    dsc, csc = hg_scattering_function(G, BINS)
    tp = dict(kabs=torch.tensor(KABS, dtype=torch.float32),
              ksca=torch.tensor(KSCA, dtype=torch.float32),
              csc=torch.as_tensor(csc), dsc=torch.as_tensor(dsc))
    if msf:
        mdsc, mcsc, abu, sca = _msf_tables(cells)
        tp.update(msf_dsc=torch.as_tensor(mdsc.transpose(1, 0, 2).copy()),
                  msf_csc=torch.as_tensor(mcsc),
                  msf_abu=torch.as_tensor(abu),
                  msf_sca=torch.as_tensor(sca.T.copy()))

    def jphys(f):
        p = dict(kabs=jnp.float32(KABS[f]), ksca=jnp.float32(KSCA[f]),
                 csc=jnp.asarray(csc[f]), dsc=jnp.asarray(dsc[f]),
                 tw=jnp.float32(1.0))
        if msf:
            p.update(msf_csc=jnp.asarray(mcsc[:, f]),
                     msf_dsc=jnp.asarray(mdsc[:, f]),
                     msf_abu=jnp.asarray(abu), msf_sca=jnp.asarray(sca[:, f]))
        return p
    return tp, jphys


def _params(f, n):
    return (dict(photons=torch.ones(3), ifreq=f, per_freq=n, hi_base=0),
            dict(photons=jnp.float32(1.0), ifreq=jnp.int32(f),
                 per_freq=jnp.int32(n)))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.3, NX - 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.abs(d) < 1e-5, 1e-5, d).astype(np.float32)
    return pos, d


def _wrap(x):
    return jnp.asarray(x.numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("near", [False, True])
def test_ffs_hash2_bit_for_bit(near):
    """The reservoir's uniforms from (seed, stream, hi, segment): soc_tpu's
    uint32 murmur3 finaliser, bit for bit, on random words and on words
    near 2^32 (where a product of two words passes 2^63)."""
    rng = np.random.default_rng(3)
    n = 4096
    if near:
        words = [(2**32 - 1 - rng.integers(0, 1000, n)).astype(np.uint32)
                 for _ in range(3)]
        seed = 2**32 - 5
    else:
        words = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                 for _ in range(3)]
        seed = 2147561425
    stream, hi, k = words
    j1, j2 = js._ffs_hash2(jnp.uint32(seed), jnp.asarray(stream),
                           jnp.asarray(hi), jnp.asarray(k))
    t1, t2 = ts._ffs_hash2(seed, *(torch.as_tensor(w.astype(np.int64))
                                   for w in (stream, hi, k)))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


@pytest.mark.parametrize("kind", ["uniform", "octree"])
def test_marches_match(kind):
    """_march_tau (with and without the observer distance and the tau
    cut) and _march_ffs against soc_tpu's on 2048 random rays."""
    jg, tg = _grids(kind)
    pos, d = _rays(2048, 11)
    jp, jl, ji, _ = jtraverse.index_global_stack(jg, jnp.asarray(pos))
    tp, tl, ti, _ = traverse.index_global_stack(tg, torch.as_tensor(pos))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    active = np.arange(2048) % 7 != 0
    dist = np.random.default_rng(2).uniform(0.5, 6.0, 2048).astype(
        np.float32)
    for ext, max_dist, cut in ((0.3, None, None), (2.5, dist, 30.0)):
        jt, jx = js._march_tau(jg, jp, jl, ji, jnp.asarray(d),
                               jnp.float32(ext), jnp.asarray(active),
                               max_dist=None if max_dist is None
                               else jnp.asarray(max_dist), tau_cut=cut)
        tt, tx = ts._march_tau(tg, tp, tl, ti, torch.as_tensor(d), ext,
                               torch.as_tensor(active),
                               max_dist=None if max_dist is None
                               else torch.as_tensor(max_dist), tau_cut=cut)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                                   atol=1e-6)
        assert (np.asarray(jt)[~active] == 0).all()
    stream = np.arange(2048, dtype=np.uint32) * 7 + 3
    hi = np.full(2048, 77, np.uint32)
    jw, jcp, jcl, jci, jct = js._march_ffs(
        jg, jnp.float32(0.4), jnp.uint32(3), jp, jl, ji, jnp.asarray(d),
        jnp.asarray(stream), jnp.asarray(hi))
    tw, tcp, tcl, tci, tct = ts._march_ffs(
        tg, 0.4, 3, tp, tl, ti, torch.as_tensor(d),
        torch.as_tensor(stream.astype(np.int64)),
        torch.as_tensor(hi.astype(np.int64)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    same = (tci.numpy() == np.asarray(jci)) & (tcl.numpy() == np.asarray(jcl))
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tct.numpy()[same], np.asarray(jct)[same],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcp.numpy()[same], np.asarray(jcp)[same],
                               atol=1e-4)


def _event_rows(pos, level, ind, photons):
    keys = collections.Counter()
    for p, lv, i, ph in zip(np.round(np.asarray(pos) * 1e3).astype(np.int64),
                            np.asarray(level), np.asarray(ind),
                            np.asarray(photons)):
        keys[(int(lv), int(i), *p.tolist(), float(np.float32(ph)).hex()[:8])] \
            += 1
    return keys


def _phase_engines(kind, f, n, ffs=True, msf=False):
    """soc_tpu's and the port's spawn + propagate_events over n packets of
    channel f: (soc_tpu's events [(pos, dir, photons, level, ind)], the
    port's ScatterEvents list)."""
    jg, tg = _grids(kind)
    tphys, jphys = _physics(tg.cells, msf)
    tpar, jpar = _params(f, n)
    jb, jfp, jpend, _ = js.spawn(jg, jphys(f), jpar, jnp.int32(n),
                                 jnp.int32(0), 5, nlanes=n, ffs=ffs)
    jtau = jnp.zeros(n, jnp.float32)
    tb, tfp, tpend, _ = ts.spawn(tg, tphys, tpar, n, 0, 5, nlanes=n,
                                 ffs=ffs)
    ttau = torch.zeros(n)
    jev, tev = [], []
    while True:
        ev = js.empty_events(CAP)
        jb, jfp, jtau, jpend, ev, ec = js.propagate_events(
            jg, jphys(f), jb, jfp, jtau, jpend, ev, jnp.int32(0), 5,
            capacity=CAP)
        jev.append((ev, int(ec)))
        if not bool(jnp.any(jb.ind >= 0)):
            break
    while True:
        buf = ts.empty_events(CAP, CPU, n)
        tb, tfp, ttau, tpend, ev, ec = ts.propagate_events(
            tg, tphys, tb, tfp, ttau, tpend, buf, 0, 5, capacity=CAP)
        tev.append((ev, ec))
        if not bool((tb.ind >= 0).any()):
            break
    return jg, tg, jphys, tphys, jev, tev


@pytest.mark.parametrize("kind,ffs", [("uniform", True), ("octree", True),
                                      ("octree", False)])
def test_spawn_and_propagate_events_match(kind, ffs):
    """The phase engine's events: the same rows as soc_tpu's, compared as
    multisets (cell, position to 1e-3, photons to 5 hex digits), at least
    99% of them matched; every port row carries the channel."""
    *_, jev, tev = _phase_engines(kind, 1, 1024, ffs)
    jrows, trows = collections.Counter(), collections.Counter()
    for ev, ec in jev:
        jrows += _event_rows(ev.pos[:ec], ev.level[:ec], ev.ind[:ec],
                             ev.photons[:ec])
    for ev, ec in tev:
        trows += _event_rows(ev.pos[:ec].numpy(), ev.level[:ec].numpy(),
                             ev.ind[:ec].numpy(), ev.photons[:ec].numpy())
        assert (ev.ifreq[:ec] == 1).all()
    nj, nt = sum(jrows.values()), sum(trows.values())
    assert nj > 1024 if ffs else nj > 0
    matched = sum((jrows & trows).values())
    assert matched >= 0.99 * max(nj, nt), (matched, nj, nt)


@pytest.mark.parametrize("kind,msf", [("uniform", False), ("octree", False),
                                      ("octree", True)])
def test_peel_off_same_events_match(kind, msf):
    """peel_off (two directions) and peel_off_healpix on the port's events,
    the same rows handed to soc_tpu's: the maps within 1e-5 of the peak
    (with MSF: the mean DSC of the two species)."""
    jg, tg, jphys, tphys, _, tev = _phase_engines(kind, 0, 512, True, msf)
    obs = [observer_basis(0.3, 0.7), observer_basis(1.9, -0.4)]
    odirs, ras, des = (np.stack([o[k] for o in obs]) for k in range(3))
    cen = (NX / 2,) * 3
    tmap = torch.zeros((3, 2, 16, 16))
    thp = torch.zeros((3, 12 * 8 * 8))
    jmap = jnp.zeros((2, 16, 16), jnp.float32)
    jhp = jnp.zeros(12 * 8 * 8, jnp.float32)
    obs_pos = (NX / 2 + 0.3, NX / 2 - 0.7, NX / 2 + 0.1)
    for ev, ec in tev:
        tmap = ts.peel_off(tg, tphys, ev, odirs, ras, des, cen, 1.0,
                           (16, 16), tmap)
        thp = ts.peel_off_healpix(tg, tphys, ev, obs_pos, 8, thp)
        jev = js.ScatterEvents(pos=_wrap(ev.pos), level=_wrap(ev.level),
                               ind=_wrap(ev.ind), dir=_wrap(ev.dir),
                               photons=_wrap(ev.photons),
                               valid=_wrap(ev.valid))
        jmap = js.peel_off(jg, jphys(0), jev, jnp.asarray(odirs),
                           jnp.asarray(ras), jnp.asarray(des),
                           jnp.asarray(cen, jnp.float32), 1.0, (16, 16),
                           jmap)
        jhp = js.peel_off_healpix(jg, jphys(0), jev, obs_pos, 8, jhp)
    for got, ref in ((tmap[0].numpy(), np.asarray(jmap)),
                     (thp[0].numpy(), np.asarray(jhp))):
        assert ref.max() > 0
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * ref.max())
    assert not tmap[1:].any() and not thp[1:].any()


RUNS = [("uniform", "ortho", True, False), ("uniform", "healpix", True, False),
        ("uniform", "ortho", False, False), ("octree", "ortho", True, False),
        ("octree", "healpix", False, False), ("octree", "ortho", True, True),
        ("uniform", "healpix", True, True)]


def _run_both(kind, mode, ffs, msf, f, n, jg, tg):
    tphys, jphys = _physics(tg.cells, msf)
    tpar, jpar = _params(f, n)
    obs = observer_basis(0.3, 0.7)
    cen = (NX / 2,) * 3
    hp = dict(healpix_nside=8, obs_pos=(NX / 2 + 0.3, NX / 2 - 0.7,
                                        NX / 2 + 0.1)) \
        if mode == "healpix" else {}
    ref = js.simulate_scattering(jg, jphys(f), jpar, n, *obs, cen, 1.0,
                                 (16, 16), 11, nlanes=LANES, capacity=CAP,
                                 ffs=ffs, **hp)
    got, st = ts.simulate_scattering(tg, tphys, tpar, n, *obs, cen, 1.0,
                                     (16, 16), 11, nlanes=LANES,
                                     capacity=CAP, ffs=ffs,
                                     return_stats=True, **hp)
    return got.numpy(), np.asarray(ref), st


@pytest.mark.parametrize("kind,mode,ffs,msf", RUNS)
def test_simulate_scattering_matches(kind, mode, ffs, msf):
    """simulate_scattering one channel at a time against soc_tpu's (the
    unified engine: sca_run + peel_off_run), orthographic or Healpix, FFS
    on or off, with or without MSF: the channel's map within 1e-4 of its
    peak on all but 3% of the pixels and its sum within 1e-3; the other
    channels' maps empty; every event's ray deposited."""
    jg, tg = _grids(kind)
    n = 4 * 6 * NX * NX
    for f in (0, 1):
        got, ref, st = _run_both(kind, mode, ffs, msf, f, n, jg, tg)
        assert ref.max() > 0
        diff = np.abs(got[f] - ref)
        assert (diff > 1e-4 * ref.max()).mean() <= 0.03, diff.max()
        assert abs(got[f].sum() / ref.sum() - 1) < 1e-3
        assert not np.delete(got, f, 0).any()
        assert st["rays"] == st["events"]
        assert st["events"] >= (n if ffs else 1)


@pytest.mark.parametrize("kind,mode", [("uniform", "ortho"),
                                       ("octree", "healpix")])
def test_mixed_pool_is_sum_of_channels(kind, mode):
    """One mixed pool over the three channels (per_freq, sel) equals the
    sum of the port's single-channel runs: the same packets, the deposits
    in another order (1e-5 of the peak)."""
    _, tg = _grids(kind)
    tphys, _ = _physics(tg.cells)
    n = 2 * 6 * NX * NX
    obs = observer_basis(0.3, 0.7)
    cen = (NX / 2,) * 3
    kw = dict(healpix_nside=8, obs_pos=(NX / 2,) * 3) \
        if mode == "healpix" else {}
    mixed = ts.simulate_scattering(
        tg, tphys, dict(photons=torch.tensor([1.0, 2.0, 0.5]), per_freq=n,
                        sel=torch.tensor([0, 1, 2]), hi_base=9 << 24),
        3 * n, *obs, cen, 1.0, (16, 16), 11, nlanes=LANES, capacity=CAP,
        **kw)
    single = sum(ts.simulate_scattering(
        tg, tphys, dict(photons=torch.tensor([1.0, 2.0, 0.5]), ifreq=f,
                        hi_base=9 << 24), n, *obs, cen, 1.0, (16, 16), 11,
        nlanes=LANES, capacity=CAP, **kw) for f in range(3))
    assert (mixed.sum(tuple(range(1, mixed.ndim))) > 0).all()
    np.testing.assert_allclose(mixed.numpy(), single.numpy(), rtol=0,
                               atol=1e-5 * float(single.max()))


def test_event_buffer_never_drops():
    """A buffer smaller than one body's events (a row a lane and service)
    raises; one just large enough flushes to the peel-off every body:
    every event's ray is deposited, and the map equals a run with a large
    buffer (1e-6 of the peak: the same rays, another order)."""
    _, tg = _grids("uniform")
    tphys, _ = _physics(tg.cells)
    tpar, _ = _params(1, 4 * 6 * NX * NX)
    obs = observer_basis(0.3, 0.7)
    args = (tg, tphys, tpar, 4 * 6 * NX * NX, *obs, (NX / 2,) * 3, 1.0,
            (16, 16), 11)
    body = LANES * (ts.SCA_PERIOD // ts.SERVICE_PERIOD)
    with pytest.raises(ValueError, match="cannot hold one body"):
        ts.simulate_scattering(*args, nlanes=LANES, capacity=body - 1)
    small, st = ts.simulate_scattering(*args, nlanes=LANES, capacity=body,
                                       return_stats=True)
    big, st_big = ts.simulate_scattering(*args, nlanes=LANES, capacity=CAP,
                                         return_stats=True)
    assert st["events"] == st_big["events"] == st["rays"] > LANES
    assert st["peel_iters"] > st_big["peel_iters"]
    np.testing.assert_allclose(small.numpy(), big.numpy(), rtol=0,
                               atol=1e-6 * float(big.max()))


# ---- soc_tpu's tests/test_scattered.py on the port ----------------------

def _bg(grid, physics, n, npix=24, ffs=True):
    odir, ra, de = observer_basis(0.0, 0.0)
    centre = (grid.nx / 2, grid.ny / 2, grid.nz / 2)
    return ts.simulate_scattering(
        grid, physics, dict(photons=torch.tensor([1.0]), ifreq=0,
                            per_freq=n, hi_base=0),
        n, odir, ra, de, centre, 1.0, (npix, npix), 5, nlanes=1 << 12,
        capacity=1 << 14, ffs=ffs)[0].numpy()


def _hg(ksca, kabs=0.0, g=0.0):
    dsc, csc = hg_scattering_function([g], BINS)
    return dict(kabs=torch.tensor([kabs]), ksca=torch.tensor([ksca]),
                csc=torch.as_tensor(csc), dsc=torch.as_tensor(dsc))


def _normalisation():
    grid = uniform_grid(NX, NX, NX, CPU, 1.0)
    n = 8 * int(grid.area)
    got = _bg(grid, _hg(2.0e-3), n, npix=16).sum()
    expect = n * 2.0e-3 * 4.0 * NX ** 3 / (6 * NX ** 2) / (4.0 * np.pi)
    assert abs(got - expect) / expect < 0.04, (got, expect)


def _centred():
    grid = uniform_grid(NX, NX, NX, CPU, 1.0)
    img = _bg(grid, _hg(5e-3, g=0.4), 4 * int(grid.area))[0]
    assert np.all(img >= 0)
    assert img[8:16, 8:16].sum() / img.sum() > 0.95
    assert img[:6, :].sum() == 0 and img[:, :6].sum() == 0


def _absorption():
    grid = uniform_grid(NX, NX, NX, CPU, 1.0)
    n = 4 * int(grid.area)
    bright = _bg(grid, _hg(5e-3), n).sum()
    dim = _bg(grid, _hg(5e-3, kabs=0.2), n).sum()
    assert dim < 0.5 * bright


def _healpix_internal():
    grid = uniform_grid(NX, NX, NX, CPU, 1.0)
    phys = _hg(2e-3)
    n = 4 * int(grid.area)
    params = dict(photons=torch.tensor([1.0]), ifreq=0, per_freq=n,
                  hi_base=0)
    out = torch.zeros((1, 12 * 8 * 8))
    weight, nev, nxt = 0.0, 0, 0
    while nxt < n:
        b, fp, pend, nxt = ts.spawn(grid, phys, params, n, nxt, 5,
                                    nlanes=1 << 12)
        tau = torch.zeros(b.lanes)
        while True:
            buf = ts.empty_events(1 << 14, CPU, b.lanes)
            b, fp, tau, pend, ev, ec = ts.propagate_events(
                grid, phys, b, fp, tau, pend, buf, 0, 5, capacity=1 << 14)
            out = ts.peel_off_healpix(grid, phys, ev, (NX / 2,) * 3, 8, out)
            nev += ec
            weight += float(ev.photons[:ec].sum())
            if not bool((b.ind >= 0).any()):
                break
    out = out.numpy()
    assert np.isfinite(out).all() and out.sum() > 0 and nev > 0
    rough = weight / (4 * np.pi) / (NX / 3) ** 2
    assert 0.2 * rough < out.sum() < 5 * rough


def _ffs_thin():
    grid = uniform_grid(16, 16, 16, CPU, 1.0)
    phys = _hg(1e-7)
    n = 2048
    params = dict(photons=torch.tensor([1.0]), ifreq=0, per_freq=n,
                  hi_base=0)
    b, fp, pend, _ = ts.spawn(grid, phys, params, n, 0, 3, nlanes=n)
    buf = ts.empty_events(1 << 13, CPU, n)
    b, fp, _, _, ev, ec = ts.propagate_events(
        grid, phys, b, fp, torch.zeros(n), pend, buf, 0, 3,
        capacity=1 << 13)
    assert ec >= n
    ph = ev.photons[:ec].numpy()
    assert 0 < ph.max() <= -np.expm1(-1e-7 * 16 * np.sqrt(3)) * 1.0001


def _engines_agree():
    grid = uniform_grid(NX, NX, NX, CPU, 1.0)
    phys = _hg(8e-2, kabs=1e-2, g=0.5)
    n = 4 * int(grid.area)
    params = dict(photons=torch.tensor([1.0]), ifreq=0, per_freq=n,
                  hi_base=0)
    odir, ra, de = observer_basis(0.3, 0.7)
    cen = (NX / 2,) * 3
    old = torch.zeros((1, 1, 16, 16))
    nold, wold, nxt = 0, 0.0, 0
    while nxt < n:
        b, fp, pend, nxt = ts.spawn(grid, phys, params, n, nxt, 11,
                                    nlanes=1 << 10)
        tau = torch.zeros(b.lanes)
        while True:
            buf = ts.empty_events(1 << 14, CPU, b.lanes)
            b, fp, tau, pend, ev, ec = ts.propagate_events(
                grid, phys, b, fp, tau, pend, buf, 0, 11, capacity=1 << 14)
            old = ts.peel_off(grid, phys, ev, odir, ra, de, cen, 1.0,
                              (16, 16), old)
            nold += ec
            wold += float(ev.photons[:ec].sum())
            if not bool((b.ind >= 0).any()):
                break
    pool = ts.sca_pool_init(grid, phys, params, n, 11, nlanes=1 << 10,
                            capacity=1 << 14)
    new = torch.zeros((1, 1, 16, 16))
    nnew, wnew = 0, 0.0
    while not pool.done:
        ev, ec = ts.sca_run(pool)
        nnew += ec
        wnew += float(ev.photons[:ec].sum())
        if ec:
            m, _ = ts.peel_off_run(grid, phys, ev, ec, (1, 1, 16, 16), odir,
                                   ra, de, cen, 1.0, nlanes=1 << 10)
            new += m
        pool.flush()
    assert nnew == nold
    np.testing.assert_allclose(wnew, wold, rtol=1e-5)
    np.testing.assert_allclose(new.numpy(), old.numpy(), rtol=2e-4,
                               atol=1e-10)


def _reservoir_law():
    nx = 16
    grid = uniform_grid(nx, nx, nx, CPU, 1.0)
    tau_tot = 2.0
    n = 1 << 14
    rng = np.random.default_rng(1)
    pos = torch.as_tensor(np.stack([
        rng.uniform(0.5, nx - 0.5, n), rng.uniform(0.5, nx - 0.5, n),
        np.full(n, 1e-3)], -1).astype(np.float32))
    dirv = torch.tensor([1e-5, 1e-5, 1.0]).expand(n, 3)
    p0, lev, ind, _ = traverse.index_global_stack(grid, pos)
    w, _, _, cind, ctau = ts._march_ffs(
        grid, tau_tot / nx, 3, p0, lev, ind, dirv,
        torch.arange(n, dtype=torch.int64), torch.full((n,), 77))
    np.testing.assert_allclose(w.numpy(), -np.expm1(-tau_tot), rtol=1e-3)
    ctau = ctau.numpy()
    e_analytic = 1.0 - tau_tot * np.exp(-tau_tot) / -np.expm1(-tau_tot)
    assert abs(ctau.mean() - e_analytic) < 0.02 * tau_tot
    for q in (0.25, 0.5, 0.75):
        t_q = -np.log1p(q * np.expm1(-tau_tot))
        assert abs((ctau < t_q).mean() - q) < 0.02
    assert int((cind >= 0).sum()) == n


@pytest.mark.parametrize("check", [
    _normalisation, _centred, _absorption, _healpix_internal, _ffs_thin,
    _engines_agree, _reservoir_law], ids=lambda f: f.__name__.strip("_"))
def test_scattering_physics(check):
    """soc_tpu's seven physics checks of the engine (tests/test_scattered
    .py), on the port: single-scattering normalisation within 4%, the map
    centred and positive, absorption dimming it, the Healpix map of an
    internal observer, FFS keeping every packet of a thin channel, the
    unified engine equal to the phase engine, and the reservoir sampling
    the first-interaction law."""
    check()
