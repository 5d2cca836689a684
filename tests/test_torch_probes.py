"""soc_tpu_torch.probes against the probe scripts: every Pallas kernel of
scripts/probe_gather.py, scripts/probe_gather2.py and
scripts/gather_probe.py (in Pallas interpret mode) and every XLA baseline
beside them, against the port's plain versions on the CPU.

Each script is loaded from its path, unchanged; for the run its REPS (or
ITERS) is cut to a few steps, its ``timeit`` runs each function once and
records (inputs, output), and ``pallas_call`` runs with interpret=True.
The recorded inputs, as numpy, go through the port's functions. Gathers
add the same float32 values in the same order: equal bit for bit.
Scatters, the one-hot deposits and the RG row sums add in another order:
rtol 1e-5 (of the output's maximum for the scatters and deposits).
The CUDA kernels themselves run only on a card (tests/test_torch_gpu.py).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from soc_tpu_torch.probes import common, gather_probe, kernels
from soc_tpu_torch.probes import probe_gather as tpg
from soc_tpu_torch.probes import probe_gather2 as tpg2

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 2
ITERS = 8


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "script_" + name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret_pallas(mp, calls):
    """pallas_call in interpret mode; each call's (inputs, outputs) kept."""
    orig = pl.pallas_call

    def wrapped(*a, **kw):
        fn = orig(*a, **dict(kw, interpret=True))

        def call(*args):
            out = fn(*args)
            calls.append((args, out))
            return out
        return call
    mp.setattr(pl, "pallas_call", wrapped)


def _np(x):
    if isinstance(x, (tuple, list)):
        return tuple(_np(y) for y in x)
    return np.asarray(x)


def _run_script(name, cut):
    """(the timeit records [(args, out)], the pallas_call records) of one
    run of the script's main() at the cut REPS/ITERS."""
    mod = _load(name)
    records, calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        for k, v in cut.items():
            mp.setattr(mod, k, v)

        def timeit(fn, *args, reps=3):
            records.append((_np(args), _np(fn(*args))))
            return 1.0
        mp.setattr(mod, "timeit", timeit)
        _interpret_pallas(mp, calls)
        mod.main()
    return mod, records, [(_np(a), _np(o)) for a, o in calls]


@pytest.fixture(scope="module")
def pg():
    return _run_script("probe_gather", {"REPS": REPS})


@pytest.fixture(scope="module")
def pg2():
    return _run_script("probe_gather2", {"REPS": REPS})


def _t(*arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def _same(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def _close(got, ref, of_max=True):
    got = got.numpy()
    assert got.shape == ref.shape
    atol = 1e-5 * np.abs(ref).max() if of_max else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


# probe_gather.py: timeit calls in the script's order
PG_ROWS = [
    ("baseline gather", lambda a: tpg.baseline_gather(*_t(*a), reps=REPS),
     "exact"),
    ("baseline scatter", lambda a: tpg.baseline_scatter(*_t(*a), reps=REPS),
     "scatter"),
    ("baseline both", lambda a: tpg.baseline_both(*_t(*a), reps=REPS),
     "both"),
    ("A1", lambda a: tpg.a1(*_t(*a), reps=REPS), "exact"),
    ("A2", lambda a: tpg.a2(*_t(*a), reps=REPS), "exact"),
    ("A3", lambda a: tpg.a3(*_t(*a), reps=REPS), "exact"),
    ("A4", lambda a: tpg.a4(*_t(*a), reps=REPS), "exact"),
    ("A5", lambda a: tpg.a5(*_t(*a), reps=REPS), "exact"),
    ("S1", lambda a: tpg.s1(*_t(*a)), "scatter"),
]


def _compare(got, ref, how):
    if how == "exact":
        _same(got, ref)
    elif how == "scatter":
        _close(got, ref)
    elif how == "rel":
        _close(got, ref, of_max=False)
    else:               # (scatter, exact gather) pairs
        _close(got[0], ref[0])
        _same(got[1], ref[1])


@pytest.mark.parametrize("row", range(len(PG_ROWS)),
                         ids=[r[0] for r in PG_ROWS])
def test_probe_gather_rows(pg, row):
    _, records, _ = pg
    assert len(records) == len(PG_ROWS)
    name, port, how = PG_ROWS[row]
    args, ref = records[row]
    _compare(port(args), ref, how)


PG2_ROWS = [
    ("baseline gather", lambda a: tpg2.baseline_gather(*_t(*a), reps=REPS),
     "exact"),
    ("baseline scatter", lambda a: tpg2.baseline_scatter(*_t(*a),
                                                         reps=REPS),
     "scatter"),
    ("W1", lambda a: tpg2.w1(*_t(*a), reps=REPS), "exact"),
    ("W2", lambda a: tpg2.w2(*_t(*a), reps=REPS), "exact"),
    ("W3", lambda a: tpg2.w3(*_t(*a), reps=REPS), "exact"),
    ("W4", lambda a: tpg2.w4(*_t(*a), reps=REPS), "exact"),
    ("RG", lambda a: tpg2.rg(*_t(*a), reps=REPS), "rel"),
    ("S2", lambda a: tpg2.s2(*_t(*a)), "scatter"),
    ("MX bf16x1", lambda a: tpg2.mx(*_t(*a), split=1, reps=REPS),
     "scatter"),
    ("MX bf16x2", lambda a: tpg2.mx(*_t(*a), split=2, reps=REPS),
     "scatter"),
]


@pytest.mark.parametrize("row", range(len(PG2_ROWS)),
                         ids=[r[0] for r in PG2_ROWS])
def test_probe_gather2_rows(pg2, row):
    _, records, _ = pg2
    assert len(records) == len(PG2_ROWS)
    name, port, how = PG2_ROWS[row]
    args, ref = records[row]
    _compare(port(args), ref, how)


def test_probe_gather2_mx_correctness_deposit(pg2):
    """The script's last pallas_call (one step, no LCG, bf16x2), and the
    port's exact scatter that the card holds it to."""
    _, _, calls = pg2
    (ix, v), ref = calls[-1]
    assert ix.shape == (256, 512)
    got = tpg2.mx_check(*_t(ix, v))
    _close(got, ref)
    exact = tpg2.exact_deposit(*_t(ix.reshape(-1), v.reshape(-1)))
    rel = float(torch.abs(got.reshape(-1) - exact).max() / exact.max())
    assert rel <= tpg2.MX_CHECK_LIMIT


@pytest.fixture(scope="module")
def gp():
    mod = _load("gather_probe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "ITERS", ITERS)
        calls = []
        _interpret_pallas(mp, calls)
        rng = np.random.default_rng(0)
        table = jnp.asarray(rng.random(mod.CELLS, np.float32))
        idx0 = jnp.asarray(rng.integers(0, mod.CELLS, mod.LANES)
                           .astype(np.int32))
        xla = _np(mod.run_xla(table, idx0)(table, idx0))
        take = _np(mod.run_pallas_take(table, idx0)(table, idx0))
    return np.asarray(table), np.asarray(idx0), xla, take


def test_gather_probe_inputs_are_the_scripts(gp):
    table, idx0, _, _ = gp
    t, i = gather_probe.inputs(0, torch.device("cpu"))
    _same(t, table)
    _same(i, idx0)


def test_gather_probe_plain(gp):
    table, idx0, (acc, tabs, idx), _ = gp
    g_acc, g_tabs, g_idx = gather_probe.run_plain(*_t(table, idx0),
                                                  iters=ITERS)
    _same(g_acc, acc)
    _close(g_tabs, tabs)
    _same(g_idx, idx)


def test_gather_probe_take(gp):
    """run_pallas_take's acc bit for bit; its tabs is all zero, in the
    script's kernel and the port alike."""
    table, idx0, (acc_xla, _, _), (acc, tabs) = gp
    g_acc, g_tabs = gather_probe.run_take(*_t(table, idx0), iters=ITERS)
    _same(g_acc, acc)
    _same(g_acc, acc_xla)
    assert not tabs.any() and not g_tabs.numpy().any()
    _same(g_tabs, tabs)


GATHER_ROWS = ["A1", "A2", "A3", "A4", "A5", "W1", "W2", "W3", "W4", "take"]


@pytest.fixture(scope="module")
def gather_cases():
    """Every gather row of the three probe modules at the scripts' shapes,
    with a few steps, by the first word of its name."""
    tbl, idx, vals = tpg.inputs(0, torch.device("cpu"))
    table, idx0 = gather_probe.inputs(0, torch.device("cpu"))
    rows = (tpg.cases(tbl, idx, vals, reps=REPS)
            + tpg2.cases(tbl, idx, vals, reps=REPS)
            + gather_probe.cases(table, idx0, ["take"], iters=ITERS))
    return {c.name.split()[0]: c for c in rows}


@pytest.mark.parametrize("row", GATHER_ROWS)
def test_gather_row_library_matches_plain(gather_cases, row):
    """Each gather row's library yardstick, one embedding_bag over the
    [lanes, reps] indices the row reads, computes what the row's plain
    version does, held as the card holds it (1e-5 of the maximum: the bag
    sums in its own order); the plain version counts no launch. RG has no
    one-call yardstick."""
    case = gather_cases[row]
    assert case.kernel == "probe_gather" and case.library is not None
    n0 = dict(kernels.launches)
    call = case.library(*case.args)
    got, ref = call(), case.fn(*case.args, ops=kernels.PLAIN)
    assert kernels.launches == n0
    err = common.error(got, ref, common.REL_OF_MAX)
    assert err <= common.LIMITS[common.REL_OF_MAX], err
    assert gather_cases["RG"].library is None


H100_SMEM = 232448     # shared memory a block may use on an H100


@pytest.mark.parametrize("layout,mod,want", [
    (kernels.FLAT, 262144, False),      # A1-A3, W2 as FLAT, take
    (kernels.ROW, 128, True),           # A4
    (kernels.COL, 2048, True),          # A5
    (kernels.ROW, 262144, False),       # W1, W2
    (kernels.ROW, 32768, True),         # W3
    (kernels.ROW, 2560, True),          # W4
    (kernels.ROW, 58112, True),         # the largest row that fits
    (kernels.COL, 58113, False),
    (kernels.COL, 8, True),             # short columns, however many
])
def test_gather_staging(layout, mod, want):
    """Which probe rows the gather kernel stages in shared memory on an
    H100: a row or column that fits; a FLAT table never."""
    assert kernels.staged(layout, mod, H100_SMEM) == want


def test_lcg_wraps_like_jax_int32():
    """common.lcg against the scripts' jnp int32 expression on values near
    +-2^31, where the product and the adds wrap."""
    vals = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 12345,
                     -2 ** 31 + 7, 1234567891, -987654321, 262143,
                     2 ** 30, -2 ** 30], np.int32)
    j = jnp.asarray(vals)
    for i in (0, 1, 31, 399):
        for mod in (128, 2048, 2560, 32768, 262144):
            ref = ((j * jnp.int32(1103515245) + jnp.int32(12345) + i)
                   % mod + mod) % mod
            got = common.lcg(torch.as_tensor(vals), i, mod)
            assert got.dtype == torch.int32
            _same(got, np.asarray(ref))
    w = common.wrap32(torch.as_tensor(vals).long() * common.LCG_A)
    _same(w.to(torch.int32), np.asarray(j * jnp.int32(common.LCG_A)))


@pytest.mark.parametrize("module", [tpg, tpg2, gather_probe],
                         ids=["probe_gather", "probe_gather2",
                              "gather_probe"])
def test_probe_modules_exit_nonzero_without_cuda(monkeypatch, module):
    """No CPU path: without a card a probe stops with a non-zero exit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code not in (0, None)


def test_wrappers_take_plain_path_on_cpu_only():
    """CPU tensors run the plain versions and count no launch; any other
    device raises rather than fall back."""
    t = torch.arange(16, dtype=torch.float32)
    ix = torch.tensor([3, 15, 0, 7], dtype=torch.int32)
    n0 = dict(kernels.launches)
    np.testing.assert_array_equal(
        kernels.gather(t, ix, kernels.ADD, kernels.FLAT, 3).numpy(),
        kernels.gather_plain(t, ix, kernels.ADD, kernels.FLAT, 3).numpy())
    assert kernels.launches == n0
    meta = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="device"):
        kernels.gather(meta, ix.to("meta"), kernels.ADD, kernels.FLAT, 3)
    with pytest.raises(ValueError, match="device"):
        kernels.onehot(ix.to("meta"), meta[:4], 1, 1, False)


# ---- the algebra the redesigned kernels rely on (their CUDA forms run
# only on a card, tests/test_torch_gpu.py)

def scatter_conv(ix, v, mod, reps):
    """FLAT ADD scatter as the scatter kernel computes it: the tally H
    deposited once a lane, then out = sum_{i < reps} roll(H, i), i.e.
    out[c] = sum_i H[(c - i) mod M]."""
    h = torch.zeros(mod).index_add_(0, torch.remainder(ix.long(), mod), v)
    out = torch.zeros(mod)
    for i in range(reps):
        out += torch.roll(h, i)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("reps,mod", [(1, 1000), (4, 262144), (4, 1000),
                                      (33, 1000), (33, 16)])
def test_s1_convolution_form_matches_plain(seed, reps, mod):
    """One deposit a lane and a cyclic stencil equal reps deposits a lane
    (reps 33 over 16 cells wraps twice), for start indices over all of
    int32: within 1e-5 of the maximum (the adds associate otherwise)."""
    rng = np.random.default_rng(seed)
    ix = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, 5000,
                                      dtype=np.int64).astype(np.int32))
    v = torch.as_tensor(rng.random(5000, np.float32))
    ref = kernels.scatter_plain(ix, v, kernels.ADD, kernels.FLAT, mod, reps)
    _close(scatter_conv(ix, v, mod, reps), ref.numpy())


def test_s1_convolution_form_matches_pallas_s1(pg):
    """The convolution form against the script's S1 kernel (interpret
    mode) on its recorded inputs: 4 steps over 262,144 cells."""
    _, records, _ = pg
    (ix, v), ref = records[[r[0] for r in PG_ROWS].index("S1")]
    _close(scatter_conv(*_t(ix, v), tpg.CELLS, 4), ref)


def row_gather_ahead(t, r, reps, nk):
    """RG as the row-gather kernel computes it: every row index walked
    ahead (kernels.row_gather_indices), each row summed, then each
    column's row sums added in step order."""
    sums = t[kernels.row_gather_indices(r, reps, nk, t.shape[0])].sum(-1)
    acc = torch.zeros(nk)
    for i in range(reps):
        acc = acc + sums[:, i]
    return acc[None, :]


@pytest.mark.parametrize("nk,ncols,mod,reps", [
    (1, 128, 2048, 1), (128, 128, 2048, 32), (130, 100, 1000, 33),
    (128, 100, 2048, 33), (130, 128, 1000, 32)])
def test_rg_indices_ahead_match_plain(nk, ncols, mod, reps):
    """The row indices walked ahead give RG's sums (the plain version
    steps the LCG as it reads), and so does the two-call reference
    (embedding_bag, then a sum): 1e-6 relative."""
    rng = np.random.default_rng(nk + ncols + reps)
    t = torch.as_tensor(rng.random((mod, ncols), np.float32))
    r = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, (2, 140),
                                     dtype=np.int64).astype(np.int32))
    ref = kernels.row_gather_plain(t, r, reps, nk).numpy()
    _close(row_gather_ahead(t, r, reps, nk), ref, of_max=False)
    _close(kernels.row_gather_two_calls(t, r, reps, nk)(), ref,
           of_max=False)
    assert tuple(kernels.row_gather_indices(r, reps, nk, mod).shape) == \
        (nk, reps)


def test_rg_indices_ahead_match_pallas_rg(pg2):
    """The walked-ahead form and the two-call reference against the
    script's RG kernel (interpret mode) on its recorded inputs."""
    _, records, _ = pg2
    (t2, r), ref = records[[row[0] for row in PG2_ROWS].index("RG")]
    t2, r = _t(t2, r)
    _close(row_gather_ahead(t2, r, REPS, tpg2.RG_ROWS), ref, of_max=False)
    _close(kernels.row_gather_two_calls(t2, r, REPS, tpg2.RG_ROWS)(), ref,
           of_max=False)


def test_span_and_intervals_of_a_call():
    """A call's span runs from its first device interval's start to its
    last end, the gaps included (busy time leaves them out); each
    interval keeps its kernel's name without namespace and arguments."""
    from types import SimpleNamespace as NS

    def event(name, start_us, end_us):
        return NS(name=name, time_range=NS(start=start_us, end=end_us))

    call = [event("Memset (Device)", 10.0, 11.0),
            event("(anonymous namespace)::deposit_add(int const*, "
                  "float const*, float*, int, probe::FloorMod)", 30.0, 33.0),
            event("void (anonymous namespace)::row_add<1>(int const*)",
                  31.0, 32.0)]
    assert common.span(call) == pytest.approx(23e-6)
    assert common.intervals(call) == [
        ("Memset", pytest.approx(1e-6)), ("deposit_add", pytest.approx(3e-6)),
        ("row_add", pytest.approx(1e-6))]
