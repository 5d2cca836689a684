"""In-flight packet splitting (`split`) against soc_tpu.

A packet that descends into a finer level halves its weight and posts a
clone request; the next refill body serves requests into dead lanes
before fresh packets. Whether a packet splits depends on how many lanes
are dead at each refill, so both packages run at the same lane count, and
splitting is held three ways:
  * bit for bit on the split's own steps from one state: the march's
    posting (which lanes split, and the request each posts) and
    serve_clones (the adopted lanes' states, the 32-bit counter base
    path * 64 wrapping for a path with bit 25 set); the clone's birth
    free path goes through log, so it is held to 1e-6;
  * per tally on a small 3-level grid where no packet diverges: the same
    clone count, tallies within 1e-5 relative (measured 3.6e-7);
  * against a split-free run of the port: energy conserved to 1e-4 and
    the refined cells' absorption unbiased (soc_tpu's own test,
    tests/test_split.py): five seeds' totals within 2% of a 16x run.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.grid import encode_link_np
from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
from soc_tpu.io.dust import hg_scattering_function
from soc_tpu.transport import propagate as jprop
from soc_tpu.transport import sources as jsrc

from soc_tpu_torch.grid import grid_from_arrays as t_grid_from_arrays
from soc_tpu_torch.transport import propagate as tprop
from soc_tpu_torch.transport import sources as tsrc

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 8
NFREQ = 3
SEED = 5
HI = tsrc.stream_hi_base("bg")


def _i64(a):
    return np.asarray(a).astype(np.int64)


@pytest.fixture(scope="module")
def setup():
    """tests/test_split.py's grid: one root cell refined, one of its
    children again; three channels of different opacity."""
    rng = np.random.default_rng(0)
    root = rng.uniform(0.5, 1.0, N ** 3).astype(np.float32)
    centre = (N // 2) + N * (N // 2) + N * N * (N // 2)
    root[centre] = encode_link_np(np.asarray([0], np.int32))[0]
    l1 = rng.uniform(2.0, 4.0, 8).astype(np.float32)
    l1[3] = encode_link_np(np.asarray([0], np.int32))[0]
    l2 = rng.uniform(8.0, 16.0, 8).astype(np.float32)
    lcells, vals = [N ** 3, 8, 8], [root, l1, l2]
    _, csc = hg_scattering_function([0.3, 0.1, 0.5], 128)
    phys = dict(kabs=np.asarray([0.05, 0.1, 0.2], np.float32),
                ksca=np.asarray([0.05, 0.02, 0.1], np.float32),
                csc=csc.astype(np.float32), tw=np.ones(NFREQ, np.float32))
    return dict(jg=j_grid_from_arrays(N, N, N, lcells, vals),
                tg=t_grid_from_arrays(N, N, N, lcells, vals, CPU),
                jphys={k: jnp.asarray(v) for k, v in phys.items()},
                tphys={k: torch.as_tensor(v) for k, v in phys.items()},
                photons=np.ones(NFREQ, np.float32))


def _jax_split_state(setup, n, steps):
    """A JAX pool of n background packets born together, after ``steps``
    march steps with splitting on (requests posted, none served)."""
    jg = setup["jg"]
    kit = jprop.make_step_fns(jg, setup["jphys"], jnp.uint32(SEED),
                              per_freq_tally=True, esc_bins=NFREQ,
                              split_max=4)
    jp = dict(photons=jnp.asarray(setup["photons"]), ifreq=None,
              per_freq=jnp.int32(n), hi_base=jnp.uint32(HI))
    b = jsrc.gen_background(jg, jnp.arange(n, dtype=jnp.int32),
                            np.uint32(SEED), jp)
    fp, _ = kit.draw_birth_fp(b.stream, b.hi)
    z = jnp.zeros(n, jnp.float32)
    st = (b, jnp.zeros(n, bool), fp, z, jnp.zeros(jg.cells, jnp.float32),
          jnp.zeros((jg.cells, NFREQ), jnp.float32), z, jnp.float32(0.0),
          jnp.zeros(1, jnp.float32), jnp.zeros(1, jnp.float32),
          jprop.init_split_state(n, jg.levels), b.anc,
          kit.lane_const_of(b), None)
    march = jax.jit(lambda s: kit.march(*s))
    for _ in range(steps):
        st = march(st)
    return kit, st, march


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
    sp = {}
    for k, v in st[10].items():
        a = np.asarray(v)
        sp[k] = torch.tensor(a) if a.dtype in (np.float32, np.bool_) \
            else torch.as_tensor(_i64(a))
    return tprop.PoolState(
        b=tb, pending=torch.tensor(np.asarray(st[1])),
        free_path=torch.tensor(np.asarray(st[2])),
        tau=torch.tensor(np.asarray(st[3])),
        esc_pending=torch.tensor(np.asarray(st[6])),
        tabs=torch.tensor(np.asarray(st[4])),
        intf=torch.tensor(np.asarray(st[5])).reshape(-1),
        absd=torch.tensor(np.asarray(st[7])),
        spare_cell=torch.remainder(torch.arange(len(tb.ind)), cells),
        sp=sp)


def _hold_split_state(tsp, jsp):
    for k, v in jsp.items():
        np.testing.assert_array_equal(tsp[k].numpy(), _i64(v)
                                      if np.asarray(v).dtype.kind in "iu"
                                      else np.asarray(v), err_msg=k)


def test_march_posts_the_same_clone_requests(setup):
    """From the same mid-flight state, one march step posts the same
    requests in both packages (which lanes, and every field of each)."""
    n = 4096
    jg, tg = setup["jg"], setup["tg"]
    kit, st, march = _jax_split_state(setup, n, 10)
    assert int(np.asarray(st[10]["pending"]).sum()) > 20
    ts = _to_torch(st, jg.cells)
    tkit = tprop.StepKit(tg, setup["tphys"], SEED, per_freq_tally=True,
                         split_max=4)
    lane_c = tkit.lane_const_of(ts.b)
    before = int(np.asarray(st[10]["pending"]).sum())
    st = march(st)
    tkit.march(ts, lane_c)
    assert int(np.asarray(st[10]["pending"]).sum()) > before
    _hold_split_state(ts.sp, st[10])
    np.testing.assert_array_equal(ts.b.ind.numpy(), _i64(st[0].ind))
    # the other lanes' attenuation goes through exp: an ulp
    np.testing.assert_allclose(ts.b.photons.numpy(),
                               np.asarray(st[0].photons), rtol=2e-7, atol=0)


def test_serve_clones_bit_for_bit(setup):
    """serve_clones from the same state: pending requests (two of them
    given split paths with bit 25 set, so path * 64 wraps in 32 bits)
    served into the dead lanes."""
    n = 4096
    jg, tg = setup["jg"], setup["tg"]
    _, st, _ = _jax_split_state(setup, n, 40)
    sp = dict(st[10])
    pend = np.nonzero(np.asarray(sp["pending"]))[0]
    dead = np.asarray(st[0].ind) < 0
    assert len(pend) > 20 and dead.sum() > 100
    path = np.asarray(sp["path"]).copy()
    path[pend[0]] = (1 << 25) | 5
    path[pend[1]] = (1 << 26) - 1
    sp["path"] = jnp.asarray(path)
    st = st[:10] + (sp,) + st[11:]
    ts = _to_torch(st, jg.cells)
    b, pending, fp, tau, jsp, _, anc = jprop.serve_clones(
        jnp.uint32(SEED), st[0], st[1], st[2], st[3], sp, st[0].ind < 0,
        st[11])
    tprop.serve_clones(SEED, ts)
    adopted = (np.asarray(b.ind) >= 0) & dead
    assert adopted.sum() == min(len(pend), dead.sum())
    wrapped = np.asarray(b.counter)[adopted] < 64 * (1 << 25)
    assert wrapped.any()                   # a counter base that wrapped
    for f in ("pos", "dir", "photons"):
        np.testing.assert_array_equal(getattr(ts.b, f).numpy(),
                                      np.asarray(getattr(b, f)), err_msg=f)
    for f in ("level", "ind", "ifreq", "stream", "hi", "counter",
              "scatterings", "e_cell"):
        np.testing.assert_array_equal(getattr(ts.b, f).numpy(),
                                      _i64(getattr(b, f)), err_msg=f)
    np.testing.assert_array_equal(ts.b.anc.numpy(), _i64(anc))
    np.testing.assert_array_equal(ts.pending.numpy(), np.asarray(pending))
    np.testing.assert_array_equal(ts.tau.numpy(), np.asarray(tau))
    np.testing.assert_allclose(ts.free_path.numpy(), np.asarray(fp),
                               rtol=1e-6, atol=0)
    _hold_split_state(ts.sp, jsp)


def _run(setup, side, total, nlanes, seed=SEED, split_max=4):
    """A mixed background run with splitting: (tabs, intf, escaped,
    clones) of soc_tpu ('j') or the port ('t')."""
    per = total // NFREQ
    if side == "j":
        out = jprop.transport_run(
            setup["jg"], setup["jphys"],
            dict(photons=jnp.asarray(setup["photons"]), ifreq=None,
                 per_freq=jnp.int32(per), hi_base=jnp.uint32(HI)),
            jnp.int32(total), jnp.zeros(setup["jg"].cells, jnp.float32),
            jnp.zeros((setup["jg"].cells, NFREQ), jnp.float32),
            np.uint32(seed), source_kind="bg", nlanes=nlanes,
            per_freq_tally=True, esc_bins=NFREQ, split_max=split_max)
        tabs, intf, esc = (np.asarray(x) for x in out[:3])
    else:
        tg = setup["tg"]
        out = tprop.transport_run(
            tg, setup["tphys"],
            dict(photons=torch.as_tensor(setup["photons"]), per_freq=per,
                 hi_base=HI), total, torch.zeros(tg.cells),
            torch.zeros((tg.cells, NFREQ)), seed, source_kind="bg",
            nlanes=nlanes, per_freq_tally=True, split_max=split_max)
        tabs, intf, esc = (x.numpy() for x in out[:3])
    clones = int(out[4]) if split_max > 0 else 0
    return tabs, intf, esc, clones


def test_split_run_matches_soc_tpu(setup):
    """Whole runs at the same lane count: the same clones, the same
    tallies (no packet diverges on this grid)."""
    total = NFREQ * 4 * int(setup["jg"].area)
    jt, ji, je, jc = _run(setup, "j", total, 1 << 11)
    tt, ti, te, tc = _run(setup, "t", total, 1 << 11)
    assert tc == jc and tc > 50
    assert ti[N ** 3:].sum() > 0            # the refined cells absorb
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-6 * jt.max())
    np.testing.assert_allclose(ti, ji, rtol=1e-5, atol=1e-6 * ji.max())
    np.testing.assert_allclose(te, je, rtol=1e-5)


def test_split_conserves_weight_and_is_unbiased(setup):
    """Halving and cloning keep the injected weight (absorbed + escaped =
    injected to 1e-4 in every channel), and the refined cells' absorption
    has the split-free run's expectation: five seeds against a run 16x
    larger, totals within 2%, the mean per-cell error not larger."""
    area = int(setup["jg"].area)
    total = NFREQ * 6 * area
    _, ti, te, tc = _run(setup, "t", total, 1 << 11)
    inj = total // NFREQ * setup["photons"].astype(np.float64)
    np.testing.assert_allclose(ti.sum(0) + te, inj, rtol=1e-4)
    assert tc > 0
    truth = _run(setup, "t", 16 * total, 1 << 12, seed=999,
                 split_max=0)[0] / 16
    refined = np.arange(setup["jg"].cells) >= N ** 3
    refined &= np.asarray(setup["jg"].dens) > 0
    tot_s, err_s, err_p = [], [], []
    for seed in (11, 23, 37, 53, 71):
        ts = _run(setup, "t", total, 1 << 11, seed=seed)[0]
        tp = _run(setup, "t", total, 1 << 11, seed=seed, split_max=0)[0]
        tot_s.append(ts.sum())
        err_s.append(np.abs(ts - truth)[refined] / truth[refined])
        err_p.append(np.abs(tp - truth)[refined] / truth[refined])
    assert abs(np.mean(tot_s) - truth.sum()) / truth.sum() < 0.02
    assert np.mean(np.concatenate(err_s)) <= np.mean(
        np.concatenate(err_p))
