"""The `devices N` product path of the port, piece by piece, on the CPU:
the mesh layout against soc_tpu's, a shard's pool (one pool over its block
of channels, from within-channel index k0) against soc_tpu's
transport_run in its ifreq/k0 form, one run per channel, the dp split of
a channel's budget (with a remainder), the sharded A2E solve,
temperature, emission and render against their one-device forms, and how
the mesh drives its shards from one thread.

Tolerances, each with its reason:
  * against soc_tpu's pool: XLA's exp/log/cos/sin differ from torch's by a
    few ulps, so a rare packet takes another path (tests/
    test_torch_transport.py): totals at 2e-3, 90% of the cells at 1e-4;
  * the port's sharded run against its one-device run: the same packets on
    the same paths, only the float32 additions in another order: 1e-5
    relative, 1e-6 of the maximum absolute;
  * the sharded A2E solve, temperature, emission and render: cells, rays
    and channels are computed independently, so they are held bit for bit.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_tpu.grid import uniform_grid as j_uniform_grid
from soc_tpu.io.dust import hg_scattering_function
from soc_tpu.parallel.product import ProductMesh as JProductMesh
from soc_tpu.render import mapping as jmap
from soc_tpu.transport import propagate as jprop
from soc_tpu.transport import sources as jsrc

from soc_tpu_torch.example_model import (gset_solver, synthetic_absorbed,
                                         with_negative_entries)
from soc_tpu_torch.grid import grid_from_arrays, uniform_grid
from soc_tpu_torch.parallel import mesh as tmesh
from soc_tpu_torch.parallel import product
from soc_tpu_torch.render import mapping as tmap
from soc_tpu_torch.solve import a2e_kernel, equilibrium, stochastic
from soc_tpu_torch.transport import propagate as tprop
from soc_tpu_torch.transport import sources as tsrc
from soc_tpu_torch.transport.medium import medium_from_numpy

torch.set_num_threads(2)
CPU = torch.device("cpu")
SEED = 2147495993
HI0 = tsrc.stream_hi_base("bg")


@pytest.mark.parametrize("nfreq", [44, 16, 7])
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_layout_matches_soc_tpu(n, nfreq):
    """(dp, freq) from soc_tpu's rule, shard (dp, fq) on device dp*F + fq
    as soc_tpu's dp-major mesh places it."""
    jm = JProductMesh(n, nfreq, devices=jax.devices()[:n])
    tm = product.ProductMesh(n, nfreq, [CPU] * n)
    assert (tm.n_dp, tm.n_freq, tm.nf_local) \
        == (jm.n_dp, jm.n_freq, jm.nf_local)
    ids = [[d.id for d in row] for row in jm.mesh.devices]
    assert ids == [[jax.devices()[dp * tm.n_freq + fq].id
                    for fq in range(tm.n_freq)] for dp in range(tm.n_dp)]
    assert len(tm.devices) == n


def test_mesh_refuses_missing_cards():
    """devices=None means cuda:0..N-1: with fewer cards visible (none
    here) it raises rather than falling back to the CPU."""
    with pytest.raises(ValueError, match="visible"):
        product.ProductMesh(2, 44)
    with pytest.raises(ValueError):
        product.ProductMesh(3, 44, [CPU] * 2)


def test_packet_identity_of_a_block_matches_soc_tpu():
    """A shard's pool over channels lo .. lo+L-1 from index k0: local id
    fl*pf + j is the packet (k0 + j, hi0 + lo + fl) that soc_tpu's
    uniform run of channel lo + fl (ifreq fl, hi_base hi0 + lo) draws for
    id j; k wraps as a uint32."""
    L, pf, lo = 3, 700, 5
    ids = np.arange(pf)
    for k0 in (0, 123456, 2 ** 32 - 100):
        tk, tf, th = tsrc.packet_identity(
            torch.arange(L * pf), dict(per_freq=pf, k0=k0, hi_base=HI0 + lo))
        for fl in range(L):
            jp = dict(ifreq=jnp.int32(fl), k0=jnp.uint32(k0),
                      hi_base=jnp.uint32(HI0 + lo))
            jk, jf, jh = jsrc.packet_identity(jnp.asarray(ids, jnp.int32),
                                              jp)
            part = slice(fl * pf, fl * pf + pf)
            np.testing.assert_array_equal(tk[part].numpy(),
                                          np.asarray(jk, np.int64))
            np.testing.assert_array_equal(tf[part].numpy(),
                                          np.asarray(jf, np.int64))
            np.testing.assert_array_equal(th[part].numpy(),
                                          np.asarray(jh, np.int64))


@pytest.fixture(scope="module")
def optics():
    rng = np.random.default_rng(7)
    nf = 4
    kabs = np.geomspace(0.05, 0.5, nf).astype(np.float32)
    ksca = (kabs * rng.uniform(0.4, 1.2, nf)).astype(np.float32)
    tw = rng.uniform(0.5, 2.0, nf).astype(np.float32)
    dsc, csc = hg_scattering_function(np.linspace(0.1, 0.6, nf), 128)
    photons = rng.uniform(0.5, 2.0, nf).astype(np.float32)
    return dict(kabs=kabs, ksca=ksca, tw=tw, csc=csc.astype(np.float32),
                dsc=dsc.astype(np.float32), photons=photons)


def test_shard_pool_matches_soc_tpu_channel_pools(optics):
    """One pool over channels 2 and 3 (a block of L = 2, tally columns 0
    and 1), packets k0 .. k0+pf-1 of each, against soc_tpu's
    uniform-frequency transport_run of each channel in turn (ifreq = local
    column, hi_base = hi0 + g - fl: the form soc_tpu product.py:262-268
    calls)."""
    n, lo, L, k0, pf = 8, 2, 2, 777, 1500
    o = optics
    jg = j_uniform_grid(n, n, n, density=1.0)
    jt = jnp.zeros(jg.cells, jnp.float32)
    ji = jnp.zeros((jg.cells, L), jnp.float32)
    je, ja = [], 0.0
    for fl in range(L):
        g = lo + fl
        jphys = dict(kabs=jnp.float32(o["kabs"][g]),
                     ksca=jnp.float32(o["ksca"][g]),
                     csc=jnp.asarray(o["csc"][g]),
                     tw=jnp.float32(o["tw"][g]))
        jpar = dict(photons=jnp.float32(o["photons"][g]),
                    ifreq=jnp.int32(fl), k0=jnp.uint32(k0),
                    hi_base=jnp.uint32(HI0 + g - fl))
        jt, ji, esc, absd = jprop.transport_run(
            jg, jphys, jpar, jnp.int32(pf), jt, ji, np.uint32(SEED),
            source_kind="bg", nlanes=2048, per_freq_tally=True)
        je.append(float(np.asarray(esc)[0]))
        ja += float(absd)
    block = slice(lo, lo + L)
    tphys = {k: torch.as_tensor(o[k][block]) for k in ("kabs", "ksca",
                                                        "csc", "tw")}
    tpar = dict(photons=torch.as_tensor(o["photons"][block]), per_freq=pf,
                k0=k0, hi_base=HI0 + lo)
    tg = uniform_grid(n, n, n, CPU)
    tt, ti, te, ta = tprop.transport_run(
        tg, tphys, tpar, L * pf, torch.zeros(tg.cells),
        torch.zeros((tg.cells, L)), SEED, source_kind="bg", nlanes=2048,
        per_freq_tally=True)
    ji, ti, te = np.asarray(ji), ti.numpy(), te.numpy()
    inj = pf * o["photons"][block].astype(np.float64)
    np.testing.assert_allclose(ti.sum(0) + te, inj, rtol=1e-4)
    np.testing.assert_allclose(ti.sum(0), ji.sum(0), rtol=2e-3)
    np.testing.assert_allclose(te, je, rtol=2e-3)
    assert abs(float(ta) - ja) / ja < 2e-3
    np.testing.assert_allclose(tt.sum(), np.asarray(jt).sum(), rtol=2e-3)
    close = np.isclose(ti, ji, rtol=1e-4, atol=1e-6 * ji.max())
    assert close.mean() > 0.9


@pytest.mark.parametrize("per_freq", [1000, 1001, 999])
def test_run_freqs_dp_split_matches_mixed_pool(optics, per_freq):
    """Six shards over NFREQ 4 give dp 3 x freq 2; budgets of 1000, 1001
    and 999 leave remainders 1, 2 and 0 in the dp split. Every packet of
    the mixed pool runs once, on the same stream, so the sharded run
    equals the mixed pool up to the order of the additions."""
    n = 6
    rng = np.random.default_rng(per_freq)
    dens = rng.uniform(0.5, 2.0, n ** 3).astype(np.float32)
    grid = grid_from_arrays(n, n, n, [n ** 3], [dens], CPU)
    o = optics
    med = medium_from_numpy(o["kabs"], o["ksca"], o["csc"], o["dsc"],
                            o["tw"], CPU)
    pm = product.ProductMesh(6, 4, [CPU] * 6)
    assert (pm.n_dp, pm.n_freq) == (3, 2)
    physics = dict(kabs=med.abs_gl, ksca=med.sca_gl, csc=med.csc,
                   tw=med.tw)
    tabs, slabs, out = product.run_freqs(
        pm, grid, physics, "bg", dict(photons=torch.as_tensor(o["photons"])),
        np.arange(4), per_freq, torch.zeros(grid.cells),
        pm.zeros_intf(grid.cells), SEED, 4096, True, HI0)
    esc = out["escaped"]
    assert out["pools"] == 6 and out["packets"] == 4 * per_freq
    intf = pm.reduce_intf(slabs, CPU).numpy()
    rt, ri, re, ra = tprop.transport_run(
        grid, physics, dict(photons=torch.as_tensor(o["photons"]),
                            per_freq=per_freq, hi_base=HI0),
        per_freq * 4, torch.zeros(grid.cells), torch.zeros((grid.cells, 4)),
        SEED, nlanes=4096, per_freq_tally=True)
    ri = ri.numpy()
    assert ri.min() >= 0 and (ri.sum(0) > 0).all()
    np.testing.assert_allclose(intf, ri, rtol=1e-5, atol=1e-6 * ri.max())
    np.testing.assert_allclose(tabs.numpy(), rt.numpy(), rtol=1e-5,
                               atol=1e-6 * float(rt.max()))
    np.testing.assert_allclose(esc, re.numpy(), rtol=1e-6)
    np.testing.assert_allclose(intf.sum(0) + esc, per_freq * o["photons"],
                               rtol=1e-4)


def test_dp_split_covers_each_packet_once():
    """Shard dp of n_dp takes [k0, k0 + mine) with k0 = dp*q + min(dp, r):
    the ranges tile 0 .. total-1 for any remainder."""
    for total in (983040, 983041, 7, 5):
        for n_dp in (1, 2, 3, 4, 6, 7):
            q, r = divmod(total, n_dp)
            got = []
            for dp in range(n_dp):
                k0 = dp * q + min(dp, r)
                got.extend(range(k0, k0 + q + int(dp < r)))
            assert got == list(range(total))


@pytest.fixture(scope="module")
def solver(tmp_path_factory):
    sol, freq = gset_solver(str(tmp_path_factory.mktemp("a2e")), nfreq=8,
                            nsize=4, ne=16)
    return sol, freq


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("with_align", [False, True])
@pytest.mark.parametrize("clamp", [False, True])
def test_a2e_sharded_equals_one_call(solver, n, with_align, clamp):
    """101 cells (not a multiple of 3 or 4) over n CPU shards: equal to
    one call bit for bit, pre-folded and clamp routes."""
    sol, freq = solver
    rng = np.random.default_rng(n)
    ab = synthetic_absorbed(rng, sol, freq, 101)
    if clamp:
        ab = with_negative_entries(rng, ab)
    stacks = stochastic.get_fused_stacks(sol, CPU, clamp=clamp)
    ab = torch.as_tensor(ab)
    align = torch.as_tensor(rng.random((sol.nsize, 101), np.float32)) \
        if with_align else None
    one = (a2e_kernel.solve_all_sizes_clamp if clamp
           else a2e_kernel.solve_all_sizes)(stacks, ab, align)
    got = a2e_kernel.solve_all_sizes_sharded({CPU: stacks}, ab, align,
                                             [CPU] * n, clamp)
    assert torch.equal(got[0], one[0])
    assert (got[1] is None) == (not with_align)
    if with_align:
        assert torch.equal(got[1], one[1])


def test_a2e_shard_ranges():
    assert a2e_kernel.shard_ranges(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert a2e_kernel.shard_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    ab = torch.rand(2, 5)
    stacks = a2e_kernel.A2EStacks(None, None, torch.zeros(1, 2),
                                  torch.zeros(1, 5, 2), 2)
    with pytest.raises(ValueError, match="w_flat"):   # no silent fallback
        a2e_kernel.solve_all_sizes_sharded({CPU: stacks}, ab, None,
                                           [CPU] * 4, False)


@pytest.mark.parametrize("negative", [False, True])
def test_solve_emission_devices(solver, monkeypatch, negative):
    """solve_emission over a device list: the sharded solve, equal to
    the one-device solve bit for bit, on both routes; SOC_TPU_A2E_SHARD=0
    turns the split off, as it does in soc_tpu."""
    sol, freq = solver
    rng = np.random.default_rng(9)
    ab = synthetic_absorbed(rng, sol, freq, 57)
    if negative:
        ab = with_negative_entries(rng, ab)
    calls = []
    real = a2e_kernel.solve_all_sizes_sharded

    def spy(*a, **kw):
        calls.append(a[3])
        return real(*a, **kw)

    monkeypatch.setattr(a2e_kernel, "solve_all_sizes_sharded", spy)
    one = stochastic.solve_emission(sol, ab, CPU)
    got = stochastic.solve_emission(sol, ab, CPU, devices=[CPU] * 3)
    assert calls == [[CPU], [CPU] * 3]
    np.testing.assert_array_equal(got, one)
    monkeypatch.setenv("SOC_TPU_A2E_SHARD", "0")
    assert stochastic.a2e_devices(CPU, [CPU] * 3) == [CPU]
    stochastic.solve_emission(sol, ab, CPU, devices=[CPU] * 3)
    assert calls[2:] == [[CPU]]
    monkeypatch.delenv("SOC_TPU_A2E_SHARD")
    assert stochastic.a2e_devices(CPU) == [CPU]


@pytest.fixture(scope="module")
def cube():
    n, nf = 6, 8
    rng = np.random.default_rng(4)
    dens = rng.uniform(0.2, 3.0, n ** 3).astype(np.float32)
    grid = grid_from_arrays(n, n, n, [n ** 3], [dens], CPU)
    emit = torch.as_tensor(rng.random((n ** 3, nf)).astype(np.float32) * 1e3)
    ext = torch.as_tensor(rng.uniform(0.01, 0.8, nf).astype(np.float32))
    return grid, emit, ext


@pytest.mark.parametrize("ndev,layout", [(4, (2, 2)), (6, (3, 2))])
def test_sharded_render_equals_one_device(cube, ndev, layout):
    """A 12x12 map of 8 channels over (dp 2, freq 2) or (dp 3, freq 2)
    CPU shards."""
    grid, emit, ext = cube
    pm = product.ProductMesh(ndev, 2 * ndev - 2, [CPU] * ndev)
    assert (pm.n_dp, pm.n_freq) == layout
    odir, ra, de = tmap.observer_basis(np.radians(37.0), np.radians(21.0))
    args = (grid, emit, ext, odir, ra, de, (3.0, 3.0, 3.0), 0.6, (12, 12))
    one = tmap.render_ortho(*args)
    got = tmesh.sharded_render_ortho(*args, pm)
    for a, b in zip(got, one):
        assert torch.equal(a, b)
    assert float(one[2].max()) > 0
    with pytest.raises(ValueError, match="divide"):
        tmesh.sharded_render_ortho(*args[:-1], (12, 7), pm)


def test_render_rows_window_matches_soc_tpu(cube):
    """render_ortho's rows [row0, row0+nrows) against soc_tpu's."""
    from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
    grid, emit, ext = cube
    jg = j_grid_from_arrays(6, 6, 6, [216], [grid.dens.numpy()])
    odir, ra, de = tmap.observer_basis(np.radians(60.0), np.radians(10.0))
    jp = jmap.render_ortho(jg, jnp.asarray(emit.numpy()),
                           jnp.asarray(ext.numpy()), jnp.asarray(odir),
                           jnp.asarray(ra), jnp.asarray(de),
                           (3.0, 3.0, 3.0), 0.7, (8, 9), row0=3, nrows=4)
    tp = tmap.render_ortho(grid, emit, ext, odir, ra, de, (3.0, 3.0, 3.0),
                           0.7, (8, 9), row0=3, nrows=4)
    full = tmap.render_ortho(grid, emit, ext, odir, ra, de, (3.0, 3.0, 3.0),
                             0.7, (8, 9))
    assert tp[0].shape == (8, 4, 8)
    for a, b, f in zip(tp, jp, full):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
        assert torch.equal(a, f[..., 3:7, :])


def test_temperature_and_emission_sharded_equal(cube):
    grid, _, _ = cube
    pm = product.ProductMesh(4, 8, [CPU] * 4)
    freq = np.geomspace(3e11, 3e15, 8)
    abs_gl = np.geomspace(1e-3, 1.0, 8).astype(np.float32)
    table = equilibrium.build_temperature_table(freq, abs_gl, 0.01, CPU)
    rng = np.random.default_rng(2)
    tabs = torch.as_tensor(
        (10.0 ** rng.uniform(-3, 3, grid.cells)).astype(np.float32))
    gl_cm = 0.01 * 3.08567758e18
    one = equilibrium.solve_temperature(grid, table, tabs, gl_cm)
    got = product.solve_temperature(pm, grid, table, tabs, gl_cm)
    assert torch.equal(got, one)
    assert torch.equal(product.emission(pm, freq, abs_gl, got, gl_cm),
                       equilibrium.emission(freq, abs_gl, one, gl_cm))


def test_shard_failure_propagates():
    """The shards run in turn in the caller's thread, each under its own
    device (here the CPU and the meta device): the failing shard's
    exception reaches the caller, and no later shard runs; the same for
    the stepped shards of map_steps."""
    pm = product.ProductMesh(4, 8, [CPU, torch.device("meta")] * 2)
    seen = []

    def fn(i, dev):
        seen.append(i)
        if i == 2:
            raise RuntimeError("shard 2 failed")
        return i

    with pytest.raises(RuntimeError, match="shard 2"):
        pm.map_shards(fn)
    assert seen == [0, 1, 2]
    assert pm.map_shards(lambda i, dev: (i, dev.type)) \
        == [(0, "cpu"), (1, "meta"), (2, "cpu"), (3, "meta")]

    def steps(i, dev):
        yield
        if i == 1:
            raise RuntimeError("shard 1 failed")
        return i

    with pytest.raises(RuntimeError, match="shard 1"):
        pm.map_steps(steps)


def test_map_steps_round_robin():
    """map_steps advances every shard's generator one step in turn until
    each returns; shards of unequal length, results in shard order."""
    pm = product.ProductMesh(3, 6, [CPU] * 3)
    order = []

    def steps(i, dev):
        for k in range(i + 1):
            order.append((i, k))
            yield
        return i * 10

    assert pm.map_steps(steps) == [0, 10, 20]
    assert order == [(0, 0), (1, 0), (2, 0), (1, 1), (2, 1), (2, 2)]


def test_replicas_cached_per_device(cube):
    grid, _, _ = cube
    pm = product.ProductMesh(2, 8, [CPU, torch.device("meta")])
    assert pm.replica(grid, CPU) is grid
    r = pm.replica(grid, "meta")
    assert r.dens.device.type == "meta" and r.nx == grid.nx
    assert pm.replica(grid, "meta") is r


def test_launch_counts_add_up_under_threads():
    """The kernels' launch counts may take adds from several threads: 16
    threads x 2000 adds with a short switch interval lose none."""
    before = a2e_kernel.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [a2e_kernel._count("launches")
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert a2e_kernel.launches - before == 32000
    a2e_kernel.launches = before
