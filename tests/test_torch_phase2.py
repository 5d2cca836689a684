"""The octree and `rt`'s self-heating phase 2 through both packages on the
same inputs: the ancestor stack of cells anywhere in the hierarchy, cell
emission packets, the ALI self-absorption split, the EMWEI allocation and
whole `rt` runs with `cellpackets` and `iterations 3` on a 3-level octree
(example_model's octree option at an 8^3 root: 512 + 64 + 64 cells),
plain, with `reference 1`, `ali 1` (with `reference 1` and `alibeta`:
the XAB carry under the reference field), `emweight 1` and SUBITERATIONS
(with and without `externalmask`).

Tolerances, each with its reason:
  * packet births: integers, weights and positions bit for bit (the same
    Threefry words, the same gathers); directions through cos/sin, whose
    implementations differ by a few ulps: 2e-6;
  * the ALI split on one set of packets: tabs_noali == tabs_ali + xab to
    1e-4 of the maximum (the same deposits added in another grouping);
  * whole runs against soc_tpu: XLA's exp/log/cos/sin differ from torch's
    by a few ulps, so a rare packet takes another path
    (tests/test_torch_slice.py): per-frequency totals at 2e-3, 99% of the
    per-cell entries at 1e-4, temperatures at 1e-4;
  * EMWEI runs: one ulp of emission can flip a roulette draw or a floor of
    the allocation, and so change which packets run; the allocation itself
    is held bit for bit on one column, the run statistically: temperatures
    within 2% (soc_tpu's bound for iterated runs, tests/test_iterations.py)
    and per-frequency totals within 1%. Measured worst case on this model:
    6.0e-6 on the temperatures (no draw flipped);
  * each cell pass's energy balance per channel, on signed sums: 1e-4 of
    the channel's absolute injected weight, or of 1e-12 of the largest
    channel's where that is larger (pass_balance).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
from soc_tpu.grid import uniform_grid as j_uniform_grid
from soc_tpu.io.dust import hg_scattering_function
from soc_tpu.ops import traverse as jtrav
from soc_tpu.pipeline import driver as jdriver
from soc_tpu.transport import propagate as jprop
from soc_tpu.transport import sources as jsrc

from soc_tpu_torch.example_model import octree_cloud, write_model
from soc_tpu_torch.grid import grid_from_arrays as t_grid_from_arrays
from soc_tpu_torch.grid import uniform_grid as t_uniform_grid
from soc_tpu_torch.ops import traverse as ttrav
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.transport import propagate as tprop
from soc_tpu_torch.transport import sources as tsrc

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12
NFREQ = 10
SEED = 2147495993
OCTREE = (2, 8, 3)        # example_model octree at an 8^3 root: 640 cells
CELLS = 640
NAMES = ("absorbed.data", "emitted.data", "tmp.T", "map_dir_00.bin")


def _i64(a):
    return np.asarray(a).astype(np.int64)


def _grids(kind):
    if kind == "uniform":
        return j_uniform_grid(6, 6, 6), t_uniform_grid(6, 6, 6, CPU)
    lcells, values = octree_cloud(8, *OCTREE)
    return (j_grid_from_arrays(8, 8, 8, lcells, values),
            t_grid_from_arrays(8, 8, 8, lcells, values, CPU))


@pytest.mark.parametrize("depth", [3, 4])
def test_stack_from_par_matches_soc_tpu(depth):
    """Every cell of a 3- and a 4-level octree, by (level, local index)."""
    lcells, values = octree_cloud(8, 2, 8, depth)
    jg = j_grid_from_arrays(8, 8, 8, lcells, values)
    tg = t_grid_from_arrays(8, 8, 8, lcells, values, CPU)
    lev = np.repeat(np.arange(len(lcells)), lcells)
    loc = np.concatenate([np.arange(n) for n in lcells])
    ja = jtrav.stack_from_par(jg, jnp.asarray(lev, jnp.int32),
                              jnp.asarray(loc, jnp.int32))
    ta = ttrav.stack_from_par(tg, torch.as_tensor(lev), torch.as_tensor(loc))
    np.testing.assert_array_equal(ta.numpy(), _i64(ja))
    assert (ta.numpy()[lev > 0] >= 0).all()


def _cell_params(cells, alloc, mixed, rng):
    """(soc_tpu params, port params) of one cell-emission pool."""
    hi = int(jsrc.stream_hi_base("cell", 2))
    emit = rng.uniform(0.5, 2.0, (cells, NFREQ) if mixed else cells)
    emit = emit.astype(np.float32)
    jp = dict(emit=jnp.asarray(emit), hi_base=jnp.uint32(hi))
    tp = dict(emit=torch.as_tensor(emit), hi_base=hi)
    if alloc == "per_cell":
        jp["per_cell"] = jnp.int32(3)
        tp["per_cell"] = 3
    else:
        com = np.sort(rng.integers(0, cells, 1024)).astype(np.int32)
        jp["cell_of_id"] = jnp.asarray(com)
        tp["cell_of_id"] = torch.as_tensor(com)
    if mixed:
        jp.update(ifreq=None, per_freq=jnp.int32(3 * cells))
        tp["per_freq"] = 3 * cells
    else:
        jp.update(ifreq=jnp.int32(4), per_freq=jnp.int32(3 * cells))
        tp["ifreq"] = 4
    return jp, tp


@pytest.mark.parametrize("alloc,mixed", [("per_cell", False),
                                         ("per_cell", True),
                                         ("cell_of_id", False)],
                         ids=["per_cell", "per_cell-mixed", "cell_of_id"])
@pytest.mark.parametrize("grid", ["uniform", "octree"])
def test_gen_cell_per_packet(grid, alloc, mixed):
    """Cell-emission packets, packet by packet, at both allocations (the
    EMWEI map's pools are one channel each, in both packages), in a
    one-channel pool and in the mixed pool."""
    jg, tg = _grids(grid)
    jp, tp = _cell_params(tg.cells, alloc, mixed, np.random.default_rng(7))
    n = 3 * tg.cells * (NFREQ if mixed else 1)
    n = min(n, 1024) if alloc == "cell_of_id" else n
    jb = jsrc.gen_cell(jg, jnp.arange(n, dtype=jnp.int32), np.uint32(SEED),
                       jp)
    tb = tsrc.gen_cell(tg, torch.arange(n), SEED, tp)
    for f in ("level", "ind", "ifreq", "stream", "hi", "counter",
              "scatterings", "e_cell", "anc"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _i64(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(tb.photons.numpy(), np.asarray(jb.photons))
    np.testing.assert_array_equal(tb.pos.numpy(), np.asarray(jb.pos))
    np.testing.assert_allclose(tb.dir.numpy(), np.asarray(jb.dir), rtol=0,
                               atol=2e-6)
    if grid == "octree":
        assert (tb.level.numpy() == 2).any()


@pytest.mark.parametrize("grid", ["uniform", "octree"])
def test_ali_split_is_exact(grid):
    """The same packets with and without ALI: tabs_noali == tabs_ali +
    xab cell by cell, xab a significant but partial share, the escape
    unchanged; and the port's xab against soc_tpu's."""
    jg, tg = _grids(grid)
    dens = 3.0 if grid == "uniform" else 1.0
    if grid == "uniform":
        jg, tg = (j_uniform_grid(6, 6, 6, density=dens),
                  t_uniform_grid(6, 6, 6, CPU, density=dens))
    _, csc = hg_scattering_function([0.3], 128)
    tphys = dict(kabs=torch.tensor([0.2]), ksca=torch.tensor([0.15]),
                 csc=torch.as_tensor(csc), tw=torch.tensor([1.0]))
    per_cell = 32
    n = per_cell * tg.cells
    params = dict(emit=torch.ones(tg.cells), per_cell=per_cell, ifreq=0,
                  hi_base=0)

    def run(with_ali):
        return tprop.transport_run(
            tg, tphys, params, n, torch.zeros(tg.cells), torch.zeros(1, 1),
            4, source_kind="cell", nlanes=LANES, with_ali=with_ali)

    tabs_plain, _, esc0, _ = run(False)
    tabs_ali, _, esc1, _, xab = run(True)
    tabs_plain, tabs_ali, xab = (x.numpy() for x in (tabs_plain, tabs_ali,
                                                     xab))
    assert 0.01 < xab.sum() / tabs_plain.sum() < 0.9
    np.testing.assert_allclose(tabs_ali + xab, tabs_plain, rtol=1e-4,
                               atol=1e-4 * tabs_plain.max())
    np.testing.assert_allclose(esc1.numpy(), esc0.numpy(), rtol=1e-6)

    jphys = dict(kabs=jnp.float32(0.2), ksca=jnp.float32(0.15),
                 csc=jnp.asarray(csc[0]), tw=jnp.float32(1.0))
    jparams = dict(emit=jnp.ones(jg.cells, jnp.float32),
                   per_cell=jnp.int32(per_cell), ifreq=jnp.int32(0),
                   per_freq=jnp.int32(n))
    jt, _, _, _, jx = jprop.transport_run(
        jg, jphys, jparams, jnp.int32(n), jnp.zeros(jg.cells, jnp.float32),
        jnp.zeros((1, 1), jnp.float32), 4, source_kind="cell",
        nlanes=LANES, with_ali=True, xab=jnp.zeros(jg.cells, jnp.float32))
    for a, b in ((tabs_ali, np.asarray(jt)), (xab, np.asarray(jx))):
        np.testing.assert_allclose(a.sum(), b.sum(), rtol=2e-3)
        assert np.isclose(a, b, rtol=1e-4, atol=1e-7 * b.max()).mean() > 0.99


@pytest.mark.parametrize("mode,lims", [(1, (0.0, 1e10, 0.0)),
                                       (1, (0.0, 1e10, 0.3)),
                                       (2, (0.0, 1e10, 0.0))])
def test_emweight_allocation_bit_equal(mode, lims):
    """The EMWEI allocation, and the per-channel allocations with
    EMWEIGHT_SKIP reuse, on the same columns and roulette generator."""
    rng = np.random.default_rng(3)
    emitted = (rng.lognormal(0.0, 3.0, (CELLS, NFREQ))).astype(np.float32)
    for col in range(3):
        a = jdriver.emweight_allocation(emitted[:, col], 2000, lims,
                                        np.random.default_rng(5), mode)
        b = tdriver.emweight_allocation(emitted[:, col], 2000, lims,
                                        np.random.default_rng(5), mode)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    class Cfg:
        clpac = 2000
        emweight_lim = lims
        emweight_skip = 3
        use_emweight = mode

    def philox():
        return np.random.Generator(np.random.Philox(
            key=np.uint64([SEED & 0xFFFFFFFF, 2])))

    ja = jdriver._emweight_allocs(emitted, Cfg, philox(), NFREQ)
    ta = tdriver._emweight_allocs(emitted, Cfg, philox(), NFREQ)
    assert sorted(ja) == sorted(ta) == list(range(NFREQ))
    for i in range(NFREQ):
        for x, y in zip(ja[i], ta[i]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _read(d):
    return {n: np.fromfile(os.path.join(d, n), np.float32) for n in NAMES}


def close_fields(t, j, name, ncol, rtol_t=1e-4, rtol_sum=2e-3, share=0.99):
    """The port's file against soc_tpu's (see the module docstring)."""
    if name == "tmp.T":
        np.testing.assert_allclose(t, j, rtol=rtol_t)
        return
    np.testing.assert_array_equal(t[:2], j[:2])      # int32 headers
    close_arrays(t[2:], j[2:], name, ncol, rtol_sum, share)


def close_arrays(t, j, name, ncol, rtol_sum=2e-3, share=0.99):
    """Per-column totals and per-entry closeness of two [-1, ncol] fields
    (see the module docstring)."""
    a, b = t.reshape(-1, ncol), j.reshape(-1, ncol)
    # atol: XLA rewrites a / b / c as a / (b * c), which underflows the
    # coldest channels' emission to 0 where torch keeps ~1e-18 of the peak
    np.testing.assert_allclose(a.sum(0), b.sum(0), rtol=rtol_sum,
                               atol=1e-12 * np.abs(b.sum(0)).max())
    close = np.isclose(a, b, rtol=1e-4, atol=1e-7 * np.abs(b).max())
    assert close.mean() > share, (name, close.mean())


def octree_model(d, iterations=3, extra="", **kw):
    return write_model(str(d), 8, kind="eqdust", nfreq=NFREQ, octree=OCTREE,
                       cellpackets=2 * CELLS, iterations=iterations,
                       extra=extra, **kw)


def check_passes(res, nexpect):
    """Every cell pass of a port run balances per channel."""
    assert len(res.cell_passes) == nexpect
    for st in res.cell_passes:
        assert st["packets"] > 0 and st["seconds"] > 0
        assert np.abs(tdriver.pass_balance(st)).max() < 1e-4, st["route"]


RT_CASES = {
    "plain": ("", 2),
    "reference": ("reference 1\n", 2),
    "ali": ("ali 1\nreference 1\nalibeta\n", 2),
    "emweight": ("emweight 1\n", 2),
    "subiterations": ("SUBITERATIONS\n", 3),
    "subiterations-mask": ("SUBITERATIONS\nexternalmask hot.mask\n", 3),
}


@pytest.mark.parametrize("case", list(RT_CASES))
def test_rt_phase2_matches_soc_tpu(tmp_path, case):
    """`rt` with cellpackets and iterations 3 on the octree, the port
    against soc_tpu: absorbed.data, emitted.data, tmp.T and the map. The
    `externalmask` marks the refined block and every third root cell hot
    (the model's own cells stay below 30 K)."""
    extra, passes = RT_CASES[case]
    hot = np.zeros(CELLS, np.int32)
    hot[::3] = 1
    hot[512:] = 1
    inis = {}
    for pkg in ("t", "j"):
        inis[pkg] = octree_model(tmp_path / pkg, extra=extra)
        hot.tofile(tmp_path / pkg / "hot.mask")
    rt = tdriver.run(inis["t"], device=CPU, lanes=LANES)
    jdriver.run(inis["j"], lanes=LANES)
    ft, fj = _read(tmp_path / "t"), _read(tmp_path / "j")
    kw = dict(rtol_t=0.02, rtol_sum=1e-2) if case == "emweight" else {}
    for n in NAMES:
        close_fields(ft[n], fj[n], n, NFREQ if n != "map_dir_00.bin" else 64,
                     **kw)
    check_passes(rt, passes)
    routes = {"ali": "ali", "emweight": "emweight"}
    assert {s["route"] for s in rt.cell_passes} == {routes.get(case,
                                                               "mixed")}
    if case == "ali":
        assert (tmp_path / "t" / "OXAB.save").exists()
        np.testing.assert_allclose(
            np.fromfile(tmp_path / "t" / "OXEM.save", np.float32),
            np.fromfile(tmp_path / "j" / "OXEM.save", np.float32),
            rtol=1e-4, atol=1e-7 * np.abs(rt.emitted).max())
    assert (rt.temperature > 3.0).all() and np.isfinite(rt.maps[0]).all()
