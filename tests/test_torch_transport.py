"""soc_tpu_torch against soc_tpu: background sources and packet transport.

Both packages draw every packet's random numbers from the same Threefry
stream, so packets follow the same paths, except where XLA's own exp, log,
cos and sin (which differ from torch's by a few ulps) move a free path or
a direction across a cell boundary. The tests below hold each step lane by
lane, count the packets whose whole paths diverge, and compare tallies with
tolerances sized for those few packets.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.grid import encode_link_np
from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
from soc_tpu.grid import uniform_grid as j_uniform_grid
from soc_tpu.io.dust import hg_scattering_function
from soc_tpu.transport import propagate as jprop
from soc_tpu.transport import sources as jsrc

from soc_tpu_torch.grid import grid_from_arrays as t_grid_from_arrays
from soc_tpu_torch.grid import uniform_grid as t_uniform_grid
from soc_tpu_torch.transport import propagate as tprop
from soc_tpu_torch.transport import sources as tsrc

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 10
NFREQ = 6
SEED = 2147495993
HI = int(jsrc.stream_hi_base("bg"))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    kabs = np.geomspace(0.02, 0.6, NFREQ).astype(np.float32)
    ksca = (kabs * rng.uniform(0.3, 1.5, NFREQ)).astype(np.float32)
    tw = rng.uniform(0.5, 2.0, NFREQ).astype(np.float32)
    _, csc = hg_scattering_function(np.linspace(0.0, 0.7, NFREQ), 256)
    photons = rng.uniform(0.5, 2.0, NFREQ).astype(np.float32)
    jg = j_uniform_grid(N, N, N, density=1.0)
    tg = t_uniform_grid(N, N, N, CPU, density=1.0)
    # a 3-level octree: some root cells refined, some children again
    root = rng.uniform(0.5, 2.0, N ** 3).astype(np.float32)
    ref0 = np.sort(rng.choice(N ** 3, 40, replace=False))
    root[ref0] = encode_link_np(8 * np.arange(len(ref0)))
    l1 = rng.uniform(0.5, 2.0, 8 * len(ref0)).astype(np.float32)
    ref1 = np.sort(rng.choice(len(l1), 30, replace=False))
    l1[ref1] = encode_link_np(8 * np.arange(len(ref1)))
    l2 = rng.uniform(0.5, 2.0, 8 * len(ref1)).astype(np.float32)
    lcells = [len(root), len(l1), len(l2)]
    octree = (j_grid_from_arrays(N, N, N, lcells, [root, l1, l2]),
              t_grid_from_arrays(N, N, N, lcells, [root, l1, l2], CPU))
    jphys = dict(kabs=jnp.asarray(kabs), ksca=jnp.asarray(ksca),
                 csc=jnp.asarray(csc), tw=jnp.asarray(tw))
    tphys = {k: torch.as_tensor(np.array(v)) for k, v in jphys.items()}
    return dict(grids=dict(uniform=(jg, tg), octree=octree), jg=jg, tg=tg,
                jphys=jphys, tphys=tphys, photons=photons)


def _params(setup, per_freq):
    jp = dict(photons=jnp.asarray(setup["photons"]), ifreq=None,
              per_freq=jnp.int32(per_freq), hi_base=jnp.uint32(HI))
    tp = dict(photons=torch.as_tensor(setup["photons"]),
              per_freq=per_freq, hi_base=HI)
    return jp, tp


def _i64(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("start", [0, 2 * 8 * 6 * N * N + 977])
def test_gen_background_per_packet(setup, start):
    n = 5000
    per_freq = 8 * 6 * N * N
    jp, tp = _params(setup, per_freq)
    jb = jsrc.gen_background(setup["jg"],
                             jnp.arange(start, start + n, dtype=jnp.int32),
                             np.uint32(SEED), jp)
    tb = tsrc.gen_background(setup["tg"], torch.arange(start, start + n),
                             SEED, tp)
    for f in ("level", "ind", "ifreq", "stream", "hi", "counter", "anc"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _i64(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(tb.photons.numpy(), np.asarray(jb.photons))
    # entry points are exact (uniforms + integers); directions go through
    # cos/sin, whose implementations differ by a few ulps
    np.testing.assert_array_equal(tb.pos.numpy(), np.asarray(jb.pos))
    np.testing.assert_allclose(tb.dir.numpy(), np.asarray(jb.dir),
                               rtol=0, atol=2e-6)


def _jax_state(setup, n):
    """A JAX pool of n packets born together, after 12 march steps (so
    some lanes are frozen at scattering points, some have left)."""
    jg = setup["jg"]
    jp, _ = _params(setup, n // NFREQ + 1)
    kit = jprop.make_step_fns(jg, setup["jphys"], jnp.uint32(SEED),
                              per_freq_tally=True, esc_bins=NFREQ)
    b = jsrc.gen_background(jg, jnp.arange(n, dtype=jnp.int32),
                            np.uint32(SEED), jp)
    fp, _ = kit.draw_birth_fp(b.stream, b.hi)
    z = jnp.zeros(n, jnp.float32)
    st = (b, jnp.zeros(n, bool), fp, z, jnp.zeros(jg.cells, jnp.float32),
          jnp.zeros((jg.cells, NFREQ), jnp.float32), z, jnp.float32(0.0),
          jnp.zeros(1, jnp.float32), jnp.zeros(1, jnp.float32), {}, b.anc,
          kit.lane_const_of(b), None)
    march = jax.jit(lambda s: kit.march(*s))
    service = jax.jit(lambda s: kit.service(*s))
    return kit, st, march, service


def _to_torch(st, cells):
    b = st[0]
    tb = tprop.PacketBatch(
        pos=torch.tensor(np.asarray(b.pos)),
        dir=torch.tensor(np.asarray(b.dir)),
        level=torch.as_tensor(_i64(b.level)),
        ind=torch.as_tensor(_i64(b.ind)),
        photons=torch.tensor(np.asarray(b.photons)),
        ifreq=torch.as_tensor(_i64(b.ifreq)),
        stream=torch.as_tensor(_i64(b.stream)),
        hi=torch.as_tensor(_i64(b.hi)),
        counter=torch.as_tensor(_i64(b.counter)),
        scatterings=torch.as_tensor(_i64(b.scatterings)),
        e_cell=torch.as_tensor(_i64(b.e_cell)),
        anc=torch.as_tensor(_i64(st[11])))
    tabs = np.asarray(st[4], np.float32)
    intf = np.asarray(st[5], np.float32).reshape(-1)
    return tprop.PoolState(
        b=tb, pending=torch.tensor(np.asarray(st[1])),
        free_path=torch.tensor(np.asarray(st[2])),
        tau=torch.tensor(np.asarray(st[3])),
        esc_pending=torch.tensor(np.asarray(st[6])),
        tabs=torch.tensor(tabs), intf=torch.tensor(intf),
        absd=torch.tensor(np.asarray(st[7])),
        spare_cell=torch.remainder(torch.arange(len(tb.ind)), cells))


def _compare(ts, st, cells, exact_ints=True):
    """Lane-by-lane comparison of a torch PoolState with a JAX state."""
    b = st[0]
    for f in ("level", "ind", "scatterings", "counter"):
        np.testing.assert_array_equal(getattr(ts.b, f).numpy(),
                                      _i64(getattr(b, f)), err_msg=f)
    np.testing.assert_array_equal(ts.pending.numpy(), np.asarray(st[1]))
    # directions pass through cos/sin: a few ulps of a unit vector
    np.testing.assert_allclose(ts.b.dir.numpy(), np.asarray(b.dir), rtol=0,
                               atol=1e-6)
    for a, r, name in ((ts.b.pos, b.pos, "pos"),
                       (ts.b.photons, b.photons, "photons"),
                       (ts.free_path, st[2], "free_path"),
                       (ts.tau, st[3], "tau"),
                       (ts.esc_pending, st[6], "esc_pending")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-6,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(ts.tabs.numpy(), np.asarray(st[4]),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(ts.intf.reshape(cells, NFREQ).numpy(),
                               np.asarray(st[5]), rtol=2e-5, atol=1e-6)


def test_march_service_sweep_lane_by_lane(setup):
    """From the same mid-flight state, one service step and then one march
    step give the same lanes in both packages."""
    n = 4096
    jg, tg = setup["jg"], setup["tg"]
    kit, st, march, service = _jax_state(setup, n)
    for _ in range(12):
        st = march(st)
    assert int(np.sum(np.asarray(st[1]))) > 50      # lanes pending
    ts = _to_torch(st, jg.cells)
    tkit = tprop.StepKit(tg, setup["tphys"], SEED, per_freq_tally=True)
    lane_c = tkit.lane_const_of(ts.b)
    st = service(st)
    tkit.service(ts)
    _compare(ts, st, jg.cells)
    st = march(st)
    tkit.march(ts, lane_c)
    _compare(ts, st, jg.cells)


def test_whole_paths_diverge_rarely(setup):
    """2048 packets stepped to the end in both packages (service, then 16
    march steps, repeated): count the packets whose path diverges (another
    scattering count, another final weight or another exit frequency
    bookkeeping). XLA's and torch's exp/log/cos/sin differ by ulps, so a
    rare packet may take another path; at most 1% may."""
    n = 2048
    jg, tg = setup["jg"], setup["tg"]
    kit, st, march, service = _jax_state(setup, n)
    ts = _to_torch(st, jg.cells)
    tkit = tprop.StepKit(tg, setup["tphys"], SEED, per_freq_tally=True)
    lane_c = tkit.lane_const_of(ts.b)
    for _ in range(60):
        st = service(st)
        tkit.service(ts)
        for _ in range(16):
            st = march(st)
            tkit.march(ts, lane_c)
        if not (np.asarray(st[0].ind) >= 0).any() \
                and not bool((ts.b.ind >= 0).any()):
            break
    assert not (np.asarray(st[0].ind) >= 0).any()
    assert not bool((ts.b.ind >= 0).any())
    same = ((ts.b.scatterings.numpy() == _i64(st[0].scatterings))
            & np.isclose(ts.esc_pending.numpy(), np.asarray(st[6]),
                         rtol=1e-4, atol=1e-9))
    diverged = int(n - same.sum())
    assert int(np.asarray(st[0].scatterings).sum()) > n // 2   # scattering
    assert diverged <= n // 100, diverged


def _run_jax(setup, total, nlanes, grid="uniform"):
    jg = setup["grids"][grid][0]
    per_freq = total // NFREQ
    jp, _ = _params(setup, per_freq)
    tabs, intf, esc, absd = jprop.transport_run(
        jg, setup["jphys"], jp, jnp.int32(total),
        jnp.zeros(jg.cells, jnp.float32),
        jnp.zeros((jg.cells, NFREQ), jnp.float32), np.uint32(SEED),
        source_kind="bg", nlanes=nlanes, per_freq_tally=True,
        esc_bins=NFREQ)
    return (np.asarray(tabs), np.asarray(intf), np.asarray(esc),
            float(absd))


def _run_torch(setup, total, nlanes, grid="uniform"):
    tg = setup["grids"][grid][1]
    per_freq = total // NFREQ
    _, tp = _params(setup, per_freq)
    tabs, intf, esc, absd = tprop.transport_run(
        tg, setup["tphys"], tp, total, torch.zeros(tg.cells),
        torch.zeros((tg.cells, NFREQ)), SEED, source_kind="bg",
        nlanes=nlanes, per_freq_tally=True)
    return tabs.numpy(), intf.numpy(), esc.numpy(), float(absd)


@pytest.mark.parametrize("grid", ["uniform", "octree"])
def test_transport_run_totals_match(setup, grid):
    """Whole runs: per-frequency absorbed and escaped photons, the
    integrated tally and the quantiles of the per-cell tallies agree, on
    a single-level grid and on a 3-level octree (the march's deferred
    descent and ancestor stack)."""
    total = 6 * 2400
    jt, ji, je, ja = _run_jax(setup, total, 4096, grid)
    tt, ti, te, ta = _run_torch(setup, total, 4096, grid)
    deepest = int(setup["grids"][grid][1].off[-1])
    assert ti[deepest:].sum() > 0      # packets reached the deepest level
    inj = total // NFREQ * setup["photons"].astype(np.float64)
    # conservation in both
    np.testing.assert_allclose(ji.sum(0) + je, inj, rtol=1e-4)
    np.testing.assert_allclose(ti.sum(0) + te, inj, rtol=1e-4)
    # a diverged packet moves at most its own weight between tallies
    np.testing.assert_allclose(ti.sum(0), ji.sum(0), rtol=2e-3)
    np.testing.assert_allclose(te, je, rtol=2e-3)
    assert abs(ta - ja) / ja < 2e-3
    np.testing.assert_allclose(tt.sum(), jt.sum(), rtol=2e-3)
    q = [0.05, 0.25, 0.5, 0.75, 0.95]
    for f in range(NFREQ):
        np.testing.assert_allclose(np.quantile(ti[:, f], q),
                                   np.quantile(ji[:, f], q), rtol=2e-2)
    # per cell: most cells carry identical packet sets
    close = np.isclose(ti, ji, rtol=1e-4, atol=1e-6 * ji.max())
    assert close.mean() > 0.9


def test_transport_run_lane_count_independent(setup):
    """Paths depend only on (stream, counter): a pool 4x narrower gives
    the same tallies up to the order of the float32 additions."""
    total = 6 * 1000
    a = _run_torch(setup, total, 1024)
    b = _run_torch(setup, total, 4096)
    np.testing.assert_allclose(a[1], b[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a[2], b[2], rtol=1e-5)
    assert abs(a[3] - b[3]) / b[3] < 1e-5


def test_profile_busy_seconds_is_interval_union():
    """The transport profile's device-busy time is the union of the device
    intervals: overlapping ones count once, host events not at all."""
    from types import SimpleNamespace as NS
    from soc_tpu_torch.profile_transport import busy_seconds

    def ev(kind, start, end):
        return NS(device_type=NS(name=kind),
                  time_range=NS(start=start, end=end))

    evs = [ev("CUDA", 30, 40), ev("CUDA", 0, 10), ev("CPU", 0, 100),
           ev("CUDA", 5, 20), ev("CUDA", 35, 36)]
    busy, n = busy_seconds(evs)
    assert n == 4
    assert busy == pytest.approx(30e-6)
    assert busy_seconds([ev("CPU", 0, 1)]) == (None, 0)


@pytest.mark.parametrize("grid", ["uniform", "octree"])
@pytest.mark.parametrize("refill", [8, 16])
def test_transport_run_max_iters_matches(setup, grid, refill):
    """soc_tpu's max_iters and refill_period: 7 refill bodies (not a
    multiple of CHECK_EVERY) of ``refill`` march steps on a budget they
    cannot drain, port against soc_tpu at test_transport_run_totals_match's
    tolerances (a diverged packet moves at most its own weight); the port
    runs exactly 7 bodies (one yield of transport_steps each), and the
    packets still in flight keep the run short of the drained one."""
    iters, total, lanes = 7, 6 * 2400, 1024
    assert iters % tprop.CHECK_EVERY
    jg, tg = setup["grids"][grid]
    jp, tp = _params(setup, total // NFREQ)
    jt, ji, je, ja = jprop.transport_run(
        jg, setup["jphys"], jp, jnp.int32(total),
        jnp.zeros(jg.cells, jnp.float32),
        jnp.zeros((jg.cells, NFREQ), jnp.float32), np.uint32(SEED),
        source_kind="bg", nlanes=lanes, per_freq_tally=True,
        esc_bins=NFREQ, max_iters=iters, refill_period=refill)
    steps = tprop.transport_steps(
        tg, setup["tphys"], tp, total, torch.zeros(tg.cells),
        torch.zeros((tg.cells, NFREQ)), SEED, source_kind="bg",
        nlanes=lanes, per_freq_tally=True, max_iters=iters,
        refill_period=refill)
    bodies = 0
    while True:
        try:
            next(steps)
            bodies += 1
        except StopIteration as stop:
            tt, ti, te, ta = stop.value
            break
    assert bodies == iters
    ti, te, ji, je = ti.numpy(), te.numpy(), np.asarray(ji), np.asarray(je)
    np.testing.assert_allclose(ti.sum(0), ji.sum(0), rtol=2e-3)
    np.testing.assert_allclose(te, je, rtol=2e-3)
    assert abs(float(ta) - float(ja)) / float(ja) < 2e-3
    np.testing.assert_allclose(tt.sum().item(), float(jt.sum()), rtol=2e-3)
    close = np.isclose(ti, ji, rtol=1e-4, atol=1e-6 * ji.max())
    assert close.mean() > 0.9
    full = _run_torch(setup, total, lanes, grid)
    assert float(ta) < 0.9 * full[3]
    # the keyword's run equals the generator's bit for bit
    again = tprop.transport_run(
        tg, setup["tphys"], tp, total, torch.zeros(tg.cells),
        torch.zeros((tg.cells, NFREQ)), SEED, source_kind="bg",
        nlanes=lanes, per_freq_tally=True, max_iters=iters,
        refill_period=refill)
    np.testing.assert_array_equal(again[1].numpy(), ti)
