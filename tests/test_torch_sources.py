"""soc_tpu_torch against soc_tpu: the constant sources' generators and
host tables, the MSF draw and the Healpix pixel centres.

The same packets (same ids, seeds and parameters) are born in both
packages. soc_tpu generates each channel in a pool of its own; the port
runs the channels of a selection in one mixed pool, so its ids map to
(channel, index) pairs, and the tests rebuild soc_tpu's packets channel
by channel to hold them lane by lane. Integer draws and host tables are
bit for bit. Directions and positions pass through sin, cos, sqrt,
arccos and a division, whose XLA and torch implementations differ by an
ulp or so: they are held to 2e-6 (directions) and 1e-5 relative
(positions), and a lane's cell may differ only where such an ulp moves it
across a boundary, on at most 1% of the lanes.
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu import rng as jrng
from soc_tpu.grid import encode_link_np
from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
from soc_tpu.render import healpix as jhp
from soc_tpu.transport import sources as jsrc

from soc_tpu_torch import rng as trng
from soc_tpu_torch.grid import grid_from_arrays as t_grid_from_arrays
from soc_tpu_torch.render import healpix as thp
from soc_tpu_torch.transport import sources as tsrc

torch.set_num_threads(2)
N = 8
NFREQ = 5
SEED = 2147495993
DIVERGE = 0.01        # at most this share of lanes in another cell


def _i64(a):
    return np.asarray(a).astype(np.int64)


@pytest.fixture(scope="module")
def grids():
    """An 8^3 root with 12 refined cells, 3 of their children refined
    again: births land on every level."""
    rng = np.random.default_rng(4)
    root = rng.uniform(0.5, 2.0, N ** 3).astype(np.float32)
    ref0 = np.sort(rng.choice(N ** 3, 12, replace=False))
    root[ref0] = encode_link_np(8 * np.arange(len(ref0)))
    l1 = rng.uniform(0.5, 2.0, 8 * len(ref0)).astype(np.float32)
    ref1 = np.sort(rng.choice(len(l1), 3, replace=False))
    l1[ref1] = encode_link_np(8 * np.arange(len(ref1)))
    l2 = rng.uniform(0.5, 2.0, 8 * len(ref1)).astype(np.float32)
    lcells = [len(root), len(l1), len(l2)]
    vals = [root, l1, l2]
    return (j_grid_from_arrays(N, N, N, lcells, vals),
            t_grid_from_arrays(N, N, N, lcells, vals, torch.device("cpu")))


@pytest.mark.parametrize("start", [0, (1 << 32) - 70])
def test_step_uniforms4_bit_exact(start):
    """The MSF draw: four uniforms from two Threefry evaluations, the
    first three step_uniforms' own; counters up to 2^32 - 1."""
    n = 4096
    rng = np.random.default_rng(1)
    stream = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    counter = (start + np.arange(n, dtype=np.uint64) % 64).astype(np.uint32)
    ref = jrng.step_uniforms4(jnp.uint32(SEED), jnp.asarray(stream),
                              jnp.asarray(counter), jnp.asarray(hi))
    got = trng.step_uniforms4(SEED, torch.as_tensor(_i64(stream)),
                              torch.as_tensor(_i64(counter)),
                              torch.as_tensor(_i64(hi)))
    three = trng.step_uniforms(SEED, torch.as_tensor(_i64(stream)),
                               torch.as_tensor(_i64(counter)),
                               torch.as_tensor(_i64(hi)))
    for k in range(4):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in range(3):
        np.testing.assert_array_equal(got[k].numpy(), three[k].numpy())


@pytest.mark.parametrize("nside", [1, 4, 16, 64])
def test_pix2ang_ring(nside):
    """phi bit for bit; theta within an ulp of soc_tpu's (arccos)."""
    npx = 12 * nside * nside
    jt, jp = jhp.pix2ang_ring(nside, jnp.arange(npx, dtype=jnp.int32))
    tt, tp = thp.pix2ang_ring(nside, torch.arange(npx))
    nt, npp = thp.pix2ang_ring_np(nside, np.arange(npx))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(npp, np.asarray(jp))
    for th in (tt.numpy(), nt):
        assert th.dtype == np.float32
        np.testing.assert_allclose(th, np.asarray(jt), rtol=0,
                                   atol=2.4e-7)


SOURCES = [[4.0, 4.0, 20.0], [-3.0, -3.0, 4.0], [4.2, 3.1, 4.7],
           [12.5, -2.0, 15.0], [3.3, 9.0, 5.1], [-0.5, 4.0, 4.0]]


@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 8, 10)])
def test_host_tables_bit_for_bit(shape):
    """PS_METHOD 2, 4/5 and 3 tables for internal, face, edge and corner
    sources, on a cubic and a non-cubic grid."""
    g = SimpleNamespace(nx=shape[0], ny=shape[1], nz=shape[2])
    for a, b in zip(jsrc.analyse_external_point_sources(g, SOURCES),
                    tsrc.analyse_external_point_sources(g, SOURCES)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for a, b in zip(jsrc.illumination_cones(g, SOURCES),
                    tsrc.illumination_cones(g, SOURCES)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for nside in (4, 16):
        for a, b in zip(jsrc.healpix_visibility(g, SOURCES, nside=nside),
                        tsrc.healpix_visibility(g, SOURCES, nside=nside)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _method_tables(method, grid, pos):
    """(soc_tpu params, port params) of a PS_METHOD's tables."""
    if method == 1:
        return dict(halfspace=jnp.int32(1)), dict(halfspace=1)
    if method == 2:
        t = tsrc.analyse_external_point_sources(grid, pos)
        keys = ("xps_nside", "xps_side", "xps_area")
    elif method == 3:
        t = tsrc.healpix_visibility(grid, pos)
        keys = ("ps3_pix", "ps3_p")
    elif method in (4, 5):
        t = tsrc.illumination_cones(grid, pos)
        keys = ("cone_side", "cone_cos")
    else:
        return {}, {}
    return ({k: jnp.asarray(v) for k, v in zip(keys, t)},
            {k: torch.as_tensor(v) for k, v in zip(keys, t)})


def _mixed_against_channels(jgen, tgen, jg, tg, jparams_of, tparams, sel,
                            per_freq, hi_base):
    """The port's mixed pool over channels ``sel`` against soc_tpu's
    per-channel generator, channel by channel; returns (jax batch fields,
    torch batch) concatenated over the channels."""
    ids = torch.arange(per_freq * len(sel))
    tb = tgen(tg, ids, SEED, dict(tparams, per_freq=per_freq,
                                  sel=torch.as_tensor(sel),
                                  hi_base=hi_base))
    parts = []
    for f in sel:
        jp = dict(jparams_of(f), ifreq=jnp.int32(f),
                  hi_base=jnp.uint32(hi_base))
        parts.append(jgen(jg, jnp.arange(per_freq, dtype=jnp.int32),
                          np.uint32(SEED), jp))
    fields = ("pos", "dir", "level", "ind", "photons", "ifreq", "stream",
              "hi", "counter", "anc")
    jb = {f: np.concatenate([np.asarray(getattr(p, f)) for p in parts])
          for f in fields}
    return jb, tb


def _hold_batch(jb, tb, photons_rtol=1e-6):
    for f in ("ifreq", "stream", "hi", "counter"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), _i64(jb[f]),
                                      err_msg=f)
    same = ((tb.ind.numpy() == _i64(jb["ind"]))
            & (tb.level.numpy() == _i64(jb["level"])))
    assert (~same).mean() <= DIVERGE, (~same).mean()
    np.testing.assert_array_equal(tb.anc.numpy()[same],
                                  _i64(jb["anc"])[same])
    np.testing.assert_allclose(tb.dir.numpy(), jb["dir"], rtol=0, atol=2e-6)
    np.testing.assert_allclose(tb.pos.numpy()[same], jb["pos"][same],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.photons.numpy(), jb["photons"],
                               rtol=photons_rtol, atol=0)


@pytest.mark.parametrize("method", [0, 1, 2, 3, 4, 5])
def test_gen_point_source_per_packet(grids, method):
    """Internal and external sources; the mixed pool over a selection of
    channels against soc_tpu's per-channel pools, lane by lane."""
    jg, tg = grids
    pos = np.asarray(SOURCES, np.float32)
    rng = np.random.default_rng(method)
    photons = rng.uniform(0.5, 2.0, (len(pos), NFREQ)).astype(np.float32)
    jt, tt = _method_tables(method, tg, pos)
    hi = tsrc.stream_hi_base("ps")
    sel = np.asarray([0, 2, 3])
    per_freq = 400 * len(pos)
    jb, tb = _mixed_against_channels(
        jsrc.gen_point_source, tsrc.gen_point_source, jg, tg,
        lambda f: dict(ps_pos=jnp.asarray(pos),
                       photons=jnp.asarray(photons[:, f]), **jt),
        dict(ps_pos=torch.as_tensor(pos), photons=torch.as_tensor(photons),
             **tt), sel, per_freq, hi)
    _hold_batch(jb, tb)
    inside = jb["ind"] >= 0
    assert inside.mean() > 0.3        # the external sources reach the cloud
    if method:
        # their photons differ from the internal sources' (the method's
        # weight correction applies)
        isrc = tb.stream.numpy() % len(pos)
        assert not np.allclose(tb.photons.numpy()[isrc == 0],
                               photons[0, tb.ifreq.numpy()[isrc == 0]])


@pytest.mark.parametrize("weighted", [False, True])
def test_gen_hpbg_per_packet(grids, weighted):
    """The Healpix sky, uniform and weighted: the mixed pool's float64
    channel-offset search picks each lane's pixel as jnp.searchsorted
    does in its channel's float32 cdf (photons, distinct per pixel, are
    equal bit for bit)."""
    jg, tg = grids
    nside = 4
    npx = 12 * nside * nside
    rng = np.random.default_rng(3)
    table = rng.uniform(0.5, 3.0, (NFREQ, npx)).astype(np.float32)
    cdf32 = np.zeros((NFREQ, npx), np.float32)
    for f in range(NFREQ):
        p = rng.uniform(0.01, 1.0, npx)
        p /= p.sum()
        c = np.cumsum(p)
        c[-1] = 1.00001
        cdf32[f] = c
    sel = np.asarray([1, 2, 4])
    tparams = dict(hpbg=torch.as_tensor(table))
    if weighted:
        flat = cdf32.astype(np.float64) + 2.0 * np.arange(NFREQ)[:, None]
        tparams["cdf"] = torch.as_tensor(flat.reshape(-1))
    hi = tsrc.stream_hi_base("hpbg")
    jb, tb = _mixed_against_channels(
        jsrc.gen_hpbg, tsrc.gen_hpbg, jg, tg,
        lambda f: dict(hpbg=jnp.asarray(table[f]),
                       cdf=jnp.asarray(cdf32[f]) if weighted else None),
        tparams, sel, 3000, hi)
    _hold_batch(jb, tb, photons_rtol=0)
    assert (tb.ind.numpy() >= 0).all()


def test_packet_identity_selection_and_starts():
    """Ids of a mixed pool over a selection, with equal budgets or with a
    budget a channel ('starts'), map to soc_tpu's per-channel (k, hi)."""
    sel = np.asarray([1, 4, 5])
    counts = np.asarray([7, 3, 11])
    hb = tsrc.stream_hi_base("diffuse")
    starts = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]))
    k, ifreq, hi = tsrc.packet_identity(
        torch.arange(int(counts.sum())),
        dict(starts=starts, sel=torch.as_tensor(sel), hi_base=hb))
    want_f = np.repeat(sel, counts)
    want_k = np.concatenate([np.arange(c) for c in counts])
    np.testing.assert_array_equal(ifreq.numpy(), want_f)
    np.testing.assert_array_equal(k.numpy(), want_k)
    for f in sel:
        jk, jf, jh = jsrc.packet_identity(
            jnp.arange(int(counts[sel == f][0]), dtype=jnp.int32),
            dict(ifreq=jnp.int32(f), hi_base=jnp.uint32(hb)))
        np.testing.assert_array_equal(k.numpy()[want_f == f], _i64(jk))
        np.testing.assert_array_equal(hi.numpy()[want_f == f], _i64(jh))
    k2, f2, _ = tsrc.packet_identity(
        torch.arange(12), dict(per_freq=4, sel=torch.as_tensor(sel),
                               hi_base=hb))
    np.testing.assert_array_equal(f2.numpy(), np.repeat(sel, 4))
    np.testing.assert_array_equal(k2.numpy(), np.tile(np.arange(4), 3))
