"""soc_tpu_torch on a CUDA device: the A2E kernels (pre-folded and clamp)
against their plain twin, the wrapper's checks, the sharded A2E solve
against one launch, the probes' four kernels against their plain
versions, the slice on the card against the slice on the CPU, and the
`devices N` path over cuda:0 three times against the one-device run.
Every test here carries the ``gpu`` marker and skips where there is no
CUDA device. This file imports no jax, so it runs on a
machine without it; tests/conftest.py does import jax, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: the kernel and the plain twin do the same float32 arithmetic
in another order (the kernel forms each substitution row from the
pre-folded weights, the twin folds the heating matrix after a cuBLAS
product, TF32 off), so they agree to 1e-4 relative over the cells whose
emission is above 1e-6 of the maximum, as chip_smoke.py demands. The clamp
kernel sums the same products in yet another order (see csrc/a2e.cu): the
same tolerance; its inputs are ones where the clamp changes the result by
more than ten times that. The probe kernels are held to their plain
versions with the limits of ``probes.common`` (gathers bit for bit).
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu_torch.example_model import (gset_solver, negate_one_weight,
                                         synthetic_absorbed,
                                         with_negative_entries, write_model)
from soc_tpu_torch.parallel import mesh as tmesh
from soc_tpu_torch.pipeline import driver, full
from soc_tpu_torch.probes import common, gather_probe, kernels
from soc_tpu_torch.probes import probe_gather, probe_gather2
from soc_tpu_torch.solve import a2e_kernel, stochastic

pytestmark = pytest.mark.gpu
REL_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _max_rel(got, ref):
    sel = ref > 1e-6 * ref.max()
    return float((torch.abs(got - ref)[sel] / ref[sel]).max())


def rescale_count(w_flat, tdown, absorbed, ne):
    """How often the forward substitution's 1e-20 rescale fires over the
    cells of ``absorbed`` [cells, NFREQ] for one size (w_flat [NE*NE,
    NFREQ], tdown [NE]): the plain twin's float32 steps, counted."""
    a = torch.clamp_min(absorbed @ w_flat.T, 0.0).reshape(-1, ne, ne)
    s = torch.flip(torch.cumsum(torch.flip(a, [1]), 1), [1])
    b = s - a[:, ne - 1:ne, :]
    b[:, ne - 1, :] = a[:, ne - 1, :]
    x = torch.zeros((a.shape[0], ne), dtype=torch.float32,
                    device=absorbed.device)
    x[:, 0] = 1.0e-20
    fired = 0
    for j in range(1, ne):
        xj = torch.clamp((b[:, j, :j] * x[:, :j]).sum(1)
                         / (tdown[j] + 1.0e-30), 0.0, 3.0e37)
        big = xj > 1.0e20
        fired += int(big.sum())
        x[big] *= 1.0e-20
        x[:, j] = torch.where(big, xj * 1.0e-20, xj)
    return fired


# (NE, NFREQ, cells, absorbed scale): the pipeline's NFREQ at NE 16-256;
# NE and NFREQ at the edges of the kernel's tiling (NFREQ 5 and 45 not a
# multiple of 4, 100 more than one register chunk; NE 2 and 3 with at most
# one column a row, 17 and 129 odd); 1 cell and 1000 (not a multiple of
# any tile: a ragged last block); a heating 1e4 times stronger, where the
# 1e-20 rescale fires
A2E_CASES = ([(ne, 44, 1000, 1.0) for ne in (16, 48, 128, 256)]
             + [(ne, nf, cells, 1.0) for ne in (2, 3, 17, 129)
                for nf in (5, 45, 100) for cells in (1, 1000)]
             + [(128, 44, 1000, 1e4)])


@pytest.mark.parametrize("ne,nfreq,cells,scale", A2E_CASES)
def test_kernel_matches_plain_twin(cuda, tmp_path, ne, nfreq, cells, scale):
    """All sizes in one launch, with the align-weighted sum."""
    sol, freq = gset_solver(str(tmp_path), nfreq=nfreq, nsize=4, ne=ne)
    assert stochastic.fused_weights_nonneg(sol)
    rng = np.random.default_rng(ne)
    stacks = stochastic.get_fused_stacks(sol, cuda, plain=True)
    ab = torch.as_tensor(synthetic_absorbed(rng, sol, freq, cells) * scale,
                         device=cuda)
    align = torch.as_tensor(rng.uniform(0, 1, (sol.nsize, cells))
                            .astype(np.float32), device=cuda)
    fired = sum(rescale_count(stacks.w_flat[s], stacks.tdown[s], ab, ne)
                for s in range(sol.nsize))
    assert (fired > 0) == (scale > 1.0), fired
    n0 = a2e_kernel.launches
    tot, ptot = a2e_kernel.solve_all_sizes(stacks, ab, align)
    assert a2e_kernel.launches == n0 + 1
    tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(tot).all()) and bool(torch.isfinite(ptot).all())
    assert _max_rel(tot, tot_p) < REL_TOL
    assert _max_rel(ptot, ptot_p) < REL_TOL
    tot2, none = a2e_kernel.solve_all_sizes(stacks, ab)
    assert none is None
    assert torch.equal(tot2, tot)


# (kernel, NFREQ, NE): one of the two given, the other the largest that
# the kernel's picker admits on this card (a2e_kernel.shape_ceiling): NE
# at NFREQ 1000, NFREQ at NE 256 and at NE 32
CEILING_CASES = [(k, nf, ne) for k in ("fold", "clamp")
                 for nf, ne in ((1000, None), (None, 256), (None, 32))]


@pytest.mark.parametrize("kernel,nfreq,ne", CEILING_CASES)
def test_kernel_at_its_shape_ceiling(cuda, tmp_path, kernel, nfreq, ne):
    """Each A2E kernel at the largest shape it takes in this card's shared
    memory, found through its picker (the library's own sizing and cap):
    one size, 300 cells, against the plain twin (1e-4 relative; the clamp
    kernel on a negative weight and negative absorbed values); one step
    beyond raises the ValueError that names the kernel, NE, NFREQ and
    the cap."""
    lib, index = a2e_kernel._lib(), cuda.index or 0
    top = a2e_kernel.shape_ceiling(lib, kernel, index, nfreq=nfreq, ne=ne)
    nfreq, ne, beyond = (nfreq, top, (nfreq, top + 1)) if ne is None \
        else (top, ne, (top + 1, ne))
    clamp = kernel == "clamp"
    sol, freq = gset_solver(str(tmp_path), nfreq=nfreq, nsize=1, ne=ne)
    rng = np.random.default_rng(ne + nfreq)
    ab = synthetic_absorbed(rng, sol, freq, 300)
    if clamp:
        negate_one_weight(sol)
        ab = with_negative_entries(rng, ab)
    stacks = stochastic.get_fused_stacks(sol, cuda, plain=True, clamp=clamp)
    ab = torch.as_tensor(ab, device=cuda)
    align = torch.as_tensor(rng.uniform(0, 1, (1, 300)).astype(np.float32),
                            device=cuda)
    solve = a2e_kernel.solve_all_sizes_clamp if clamp \
        else a2e_kernel.solve_all_sizes
    tot, ptot = solve(stacks, ab, align)
    tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(tot).all()) and bool(torch.isfinite(ptot).all())
    assert _max_rel(tot, tot_p) < REL_TOL
    assert _max_rel(ptot, ptot_p) < REL_TOL
    pick = a2e_kernel.pick_clamp_config if clamp \
        else a2e_kernel.pick_fold_config
    name = "a2e_clamp" if clamp else "a2e_all_sizes"
    with pytest.raises(ValueError, match=r"%s: NE=%d with NFREQ=%d .*\(%d "
                       % (name, beyond[1], beyond[0],
                          a2e_kernel._smem_cap(lib, index))):
        pick(lib, *beyond, index)


def test_wrapper_checks_inputs(cuda, tmp_path):
    sol, freq = gset_solver(str(tmp_path), nfreq=12, nsize=2, ne=16)
    stacks = stochastic.get_fused_stacks(sol, cuda)
    ab = torch.as_tensor(synthetic_absorbed(np.random.default_rng(1), sol,
                                            freq, 64), device=cuda)
    with pytest.raises(TypeError):
        a2e_kernel.solve_all_sizes(stacks, ab.double())
    with pytest.raises(ValueError, match="contiguous"):
        a2e_kernel.solve_all_sizes(stacks, ab.T.contiguous().T)
    with pytest.raises(ValueError, match="shape"):
        a2e_kernel.solve_all_sizes(stacks, ab[:, :-1].contiguous())
    with pytest.raises(ValueError, match="align"):
        a2e_kernel.solve_all_sizes(stacks, ab, torch.zeros((1, 64),
                                                           device=cuda))
    cpu_stacks = stochastic.get_fused_stacks(sol, torch.device("cpu"))
    with pytest.raises(ValueError, match="w_fold"):
        a2e_kernel.solve_all_sizes(cpu_stacks, ab)


@pytest.mark.parametrize("ne", [16, 48, 128, 256])
def test_clamp_kernel_matches_plain_twin(cuda, tmp_path, ne):
    """A negative weight and negative absorbed values: the clamp kernel
    against the plain twin, with the align-weighted sum. The clamp takes
    effect on these inputs: some heating entries are negative, and the
    pre-folded kernel, which folds before it could clamp, differs from the
    twin by more than ten times the tolerance."""
    sol, freq = gset_solver(str(tmp_path), nfreq=44, nsize=4, ne=ne)
    negate_one_weight(sol)
    assert not stochastic.fused_weights_nonneg(sol)
    rng = np.random.default_rng(ne)
    stacks = stochastic.get_fused_stacks(sol, cuda, plain=True, clamp=True)
    ab = torch.as_tensor(with_negative_entries(
        rng, synthetic_absorbed(rng, sol, freq, 1000)), device=cuda)
    align = torch.as_tensor(rng.uniform(0, 1, (sol.nsize, 1000))
                            .astype(np.float32), device=cuda)
    n0 = a2e_kernel.clamp_launches
    tot, ptot = a2e_kernel.solve_all_sizes_clamp(stacks, ab, align)
    assert a2e_kernel.clamp_launches == n0 + 1
    tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(tot).all()) and bool(torch.isfinite(ptot).all())
    assert _max_rel(tot, tot_p) < REL_TOL
    assert _max_rel(ptot, ptot_p) < REL_TOL
    with pytest.raises(ValueError, match="w_fold"):
        a2e_kernel.solve_all_sizes(stacks, ab)
    assert sum(int((ab @ stacks.w_flat[s].T < 0).sum())
               for s in range(stacks.nsize)) > 0
    unclamped, _ = a2e_kernel.solve_all_sizes(
        stochastic.get_fused_stacks(sol, cuda), ab)
    assert _max_rel(torch.nan_to_num(unclamped, nan=float("inf")),
                    tot_p) > 10 * REL_TOL


# (NE, NFREQ, cells, absorbed scale, staged rows): a2e_clamp over NE 2-256
# and NFREQ 5-100 (5 not a multiple of 4, 49 and 100 more than one
# register chunk) on 1000 cells (a ragged last block for every tile); a
# heating 1e4 times stronger, where the rescale fires; and runs of 7 and
# 40 rows, which divide no column's NE-1-j rows evenly at NE 48 and 128,
# on 1 and 333 cells
CLAMP_CASES = ([(ne, nf, 1000, 1.0, None) for ne in (2, 3, 16, 48, 128, 256)
                for nf in (5, 44, 49, 100)]
               + [(128, 44, 1000, 1e4, None), (48, 44, 1, 1.0, 7),
                  (128, 44, 333, 1.0, 40)])


@pytest.mark.parametrize("ne,nfreq,cells,scale,lr", CLAMP_CASES)
def test_clamp_kernel_shapes(cuda, tmp_path, monkeypatch, ne, nfreq, cells,
                             scale, lr):
    """The clamp kernel against the plain twin (1e-4) on a negative weight
    and negative absorbed values, with the align-weighted sum. With a
    forced run of lr staged rows it equals the picked run's result bit for
    bit: the sums of a cell do not depend on how a column is staged."""
    sol, freq = gset_solver(str(tmp_path), nfreq=nfreq, nsize=3, ne=ne)
    negate_one_weight(sol)
    rng = np.random.default_rng(ne * 1000 + nfreq)
    stacks = stochastic.get_fused_stacks(sol, cuda, plain=True, clamp=True)
    ab = torch.as_tensor(with_negative_entries(
        rng, synthetic_absorbed(rng, sol, freq, cells)) * scale,
        device=cuda)
    align = torch.as_tensor(rng.uniform(0, 1, (sol.nsize, cells))
                            .astype(np.float32), device=cuda)
    fired = sum(rescale_count(stacks.w_flat[s], stacks.tdown[s], ab, ne)
                for s in range(sol.nsize))
    assert (fired > 0) == (scale > 1.0), fired
    n0 = a2e_kernel.clamp_launches
    tot, ptot = a2e_kernel.solve_all_sizes_clamp(stacks, ab, align)
    assert a2e_kernel.clamp_launches == n0 + 1
    tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(tot).all()) and bool(torch.isfinite(ptot).all())
    assert _max_rel(tot, tot_p) < REL_TOL
    assert _max_rel(ptot, ptot_p) < REL_TOL
    if lr is not None:
        tile, _, warps = a2e_kernel.pick_clamp_config(
            a2e_kernel._lib(), nfreq, ne, cuda.index or 0)
        monkeypatch.setitem(a2e_kernel._CONFIG,
                            ("clamp", cuda.index or 0, nfreq, ne),
                            (tile, lr, warps))
        got = a2e_kernel.solve_all_sizes_clamp(stacks, ab, align)
        assert torch.equal(got[0], tot) and torch.equal(got[1], ptot)


@pytest.mark.parametrize("neg_weight", [False, True])
def test_solve_emission_runs_clamp_kernel_for_negative_inputs(cuda, tmp_path,
                                                              neg_weight):
    """Negative absorbed values (and a negative weight) on the card run the
    clamp kernel, never the pre-folded one or the plain twin, and match
    the same solve on the CPU (the plain twin)."""
    sol, freq = gset_solver(str(tmp_path), nfreq=12, nsize=2, ne=16)
    if neg_weight:
        negate_one_weight(sol)
    ab = synthetic_absorbed(np.random.default_rng(2), sol, freq, 32)
    ab[3, 4] = -1.0
    n0 = (a2e_kernel.launches, a2e_kernel.clamp_launches)
    got = stochastic.solve_emission(sol, ab, cuda)
    assert (a2e_kernel.launches, a2e_kernel.clamp_launches) == \
        (n0[0], n0[1] + 1)
    ref = stochastic.solve_emission(sol, ab, torch.device("cpu"))
    assert _max_rel(torch.as_tensor(got), torch.as_tensor(ref)) < REL_TOL


@pytest.mark.parametrize("clamp", [False, True])
def test_sharded_a2e_equals_one_launch(cuda, tmp_path, clamp):
    """1000 cells with the polarised sum over cuda:0 three times and over
    every visible card: one launch per shard, and the result equal to one
    launch over all cells bit for bit (one thread per cell, a fixed order
    of the sums). Then two shards split at cells 1, 127 and 129, which
    moves every cell of the second to another place in its block: still
    bit for bit."""
    sol, freq = gset_solver(str(tmp_path), nfreq=44, nsize=4, ne=48)
    rng = np.random.default_rng(5)
    ab = synthetic_absorbed(rng, sol, freq, 1000)
    if clamp:
        negate_one_weight(sol)
        ab = with_negative_entries(rng, ab)
    stacks = stochastic.get_fused_stacks(sol, cuda, clamp=clamp)
    ab = torch.as_tensor(ab, device=cuda)
    align = torch.as_tensor(rng.uniform(0, 1, (sol.nsize, 1000))
                            .astype(np.float32), device=cuda)
    solve = a2e_kernel.solve_all_sizes_clamp if clamp \
        else a2e_kernel.solve_all_sizes
    one = solve(stacks, ab, align)
    visible = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    count = "clamp_launches" if clamp else "launches"
    for shards in ([cuda] * 3, visible):
        by_device = {d: stochastic.get_fused_stacks(sol, d, clamp=clamp)
                     for d in set(shards)}
        n0 = getattr(a2e_kernel, count)
        got = a2e_kernel.solve_all_sizes_sharded(by_device, ab, align,
                                                 shards, clamp)
        torch.cuda.synchronize()
        assert getattr(a2e_kernel, count) - n0 == len(shards)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    for c0 in (1, 127, 129):
        parts = [solve(stacks, ab[i0:i1], align[:, i0:i1].contiguous())
                 for i0, i1 in ((0, c0), (c0, 1000))]
        for k in range(2):
            assert torch.equal(torch.cat([p[k] for p in parts]), one[k]), c0


def test_devices_path_on_card(cuda, tmp_path, monkeypatch):
    """`rt` and `pipeline` over cuda:0 three times (dp 3 at 8 channels,
    a 6x6 map split into rows) against the one-device runs on the card:
    the same packets on the same streams, the atomic adds in another
    order, so every entry within 1e-4 relative or 1e-6 of the maximum."""
    maps = []
    real = tmesh.sharded_render_ortho
    monkeypatch.setattr(tmesh, "sharded_render_ortho",
                        lambda *a: maps.append(a[-1]) or real(*a))
    shards = [cuda] * 3
    ini = write_model(str(tmp_path / "rt"), 6, kind="eqdust", nfreq=8)
    rd = driver.run(ini, device=cuda, lanes=1 << 12, devices=shards)
    r1 = driver.run(ini, device=cuda, lanes=1 << 12)
    assert [(m.n_dp, m.n_freq) for m in maps] == [(3, 1)]
    for a, b in ((rd.absorbed, r1.absorbed), (rd.temperature, r1.temperature),
                 (rd.emitted, r1.emitted), (rd.maps[0], r1.maps[0])):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * np.abs(b).max())
    bal = (rd.absorbed_photons + rd.escaped) / rd.injected - 1
    assert np.abs(bal).max() < 1e-4
    kw = dict(kind="gset", nfreq=8, nsize=4, extra="nenumber 32\n")
    out = []
    for name, devices in (("one", None), ("three", shards)):
        ini = write_model(str(tmp_path / name), 6, **kw)
        n0 = a2e_kernel.launches
        _, emitted, res_map = full.run_pipeline(ini, device=cuda,
                                                lanes=1 << 12,
                                                devices=devices)
        # without a device list the solve splits over every visible card
        assert a2e_kernel.launches - n0 == \
            (3 if devices else torch.cuda.device_count())
        out.append((emitted, res_map.maps[0]))
    for a, b in zip(out[1], out[0]):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * np.abs(b).max())


PROBE_CASES = {     # reduced reps; the scripts' shapes
    "probe_gather": lambda t, i, v: (
        probe_gather.cases(t, i, v, reps=4) + probe_gather2.cases(t, i, v,
                                                                  reps=4)
        + gather_probe.cases(t, i[:gather_probe.LANES], ["take"],
                             iters=16)),
    "probe_row_gather": lambda t, i, v: probe_gather2.cases(t, i, v, reps=4),
    "probe_scatter": lambda t, i, v: (probe_gather.cases(t, i, v, reps=4)
                                      + probe_gather2.cases(t, i, v,
                                                            reps=4)),
    "probe_onehot": lambda t, i, v: probe_gather2.cases(t, i, v, reps=2),
}


@pytest.mark.parametrize("kernel", list(PROBE_CASES))
def test_probe_kernel_matches_plain(cuda, kernel):
    """Every probe row of one kernel, at the scripts' shapes with a few
    reps, through the kernel and its plain version."""
    tbl, idx, vals = probe_gather.inputs(3, cuda)
    rows = [c for c in PROBE_CASES[kernel](tbl, idx, vals)
            if c.kernel == kernel]
    assert rows
    for case in rows:
        n0 = kernels.launches[kernel]
        got = case.fn(*case.args, ops=kernels.KERNELS)
        assert kernels.launches[kernel] == n0 + 1
        ref = case.fn(*case.args, ops=kernels.PLAIN)
        torch.cuda.synchronize()
        err = common.error(got, ref, case.tol)
        assert err <= common.LIMITS[case.tol], (case.name, err)
    if kernel == "probe_onehot":
        ix = idx.reshape(256, 512)
        got = probe_gather2.mx_check(ix, vals.reshape(256, 512))
        exact = probe_gather2.exact_deposit(idx, vals)
        rel = float(torch.abs(got.reshape(-1) - exact).max() / exact.max())
        assert rel <= probe_gather2.MX_CHECK_LIMIT


# MX indices: the edges of the CTAs' slices of the table (each CTA of a
# cluster holds 32,768 cells), every lane on one cell, or random cells
# stepped by the LCG
MX_INDICES = {
    "edges": lambda n, rng: np.resize(
        np.array([0, 32767, 32768, 262143], np.int32), n),
    "hot": lambda n, rng: np.full(n, 32768, np.int32),
    "lcg": lambda n, rng: rng.integers(-2 ** 31, 2 ** 31 - 1, n,
                                       dtype=np.int64).astype(np.int32),
}


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("reps", [1, 32])
@pytest.mark.parametrize("n", [1, 513])
@pytest.mark.parametrize("pattern", list(MX_INDICES))
def test_onehot_kernel_edges(cuda, pattern, n, reps, split):
    """The MX deposit kernel against its plain version (index_add_) at the
    slice edges, on a hot spot and on LCG chains, for 1 and 513 lanes, 1
    and 32 steps, split 1 and 2: within 1e-5 of the maximum (float32 adds
    in another order)."""
    rng = np.random.default_rng(n * 64 + reps)
    ix = torch.as_tensor(MX_INDICES[pattern](n, rng), device=cuda)
    v = torch.as_tensor(rng.uniform(0.0, 1.0, n).astype(np.float32),
                        device=cuda)
    use_lcg = pattern == "lcg"
    n0 = kernels.launches["probe_onehot"]
    got = kernels.onehot(ix, v, split, reps, use_lcg)
    assert kernels.launches["probe_onehot"] == n0 + 1
    ref = kernels.onehot_plain(ix, v, split, reps, use_lcg)
    torch.cuda.synchronize()
    assert float(ref.max()) > 0
    err = common.error(got, ref, common.REL_OF_MAX)
    assert err <= common.LIMITS[common.REL_OF_MAX], err
    assert int((got != 0).sum()) == int((ref != 0).sum())


# (layout, table shape, index shape): a power-of-two M and not, the
# probes' 262,144 among them; rows and columns that fit in shared memory
# (staged) and that do not (M above 58,112 floats: read through L2); lane
# counts that are not a multiple of the block (1000 flat lanes, rows of
# 130 and 1100 lanes, column slabs of 7 and 30 rows)
GATHER_SHAPES = [
    (kernels.FLAT, (4096,), (1000,)), (kernels.FLAT, (1000,), (1000,)),
    (kernels.FLAT, (262144,), (1000,)),
    (kernels.ROW, (3, 4096), (3, 1100)), (kernels.ROW, (3, 2560), (3, 130)),
    (kernels.ROW, (2, 65536), (2, 130)), (kernels.ROW, (2, 60001), (2, 130)),
    (kernels.COL, (2048, 48), (7, 48)), (kernels.COL, (1000, 6), (30, 6)),
    (kernels.COL, (65536, 2), (70, 2)), (kernels.COL, (60001, 2), (70, 2)),
    (kernels.COL, (8, 65537), (2, 65537)),
]


@pytest.mark.parametrize("layout,tshape,xshape", GATHER_SHAPES)
@pytest.mark.parametrize("rule", [kernels.ADD, kernels.LCG_BEFORE,
                                  kernels.LCG_AFTER])
def test_gather_kernel_edges(cuda, rule, layout, tshape, xshape):
    """The gather kernel against its plain version, bit for bit, for 1,
    U-1, U+1 and 400 steps (U the loads a lane keeps in flight, from
    global memory and from shared memory), on start indices over all of
    int32 (negative ones too; LCG_AFTER reads t at its start index, so
    there they lie in [0, M))."""
    rng = np.random.default_rng(len(tshape) * 7 + rule)
    t = torch.as_tensor(rng.random(tshape, np.float32), device=cuda)
    ix = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, xshape,
                                      dtype=np.int64).astype(np.int32),
                         device=cuda)
    mod = kernels._gather_geometry(t, ix, layout)[0]
    if rule == kernels.LCG_AFTER:
        ix = torch.remainder(ix, mod)
    lib = kernels._lib("probe_gather")
    steps = {1, 400}
    for staged in (0, 1):
        unroll = lib.probe_gather_unroll(staged)
        steps |= {unroll - 1, unroll + 1}
    for reps in sorted(steps):
        n0 = kernels.launches["probe_gather"]
        got = kernels.gather(t, ix, rule, layout, reps)
        assert kernels.launches["probe_gather"] == n0 + 1
        ref = kernels.gather_plain(t, ix, rule, layout, reps)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), reps


# (layout, lanes, mod): FLAT over a power-of-two M (the probe's 262,144)
# and not (1000), over 16 cells (33 steps wrap twice) and with no lanes;
# ROW rows of S2's 128 lanes and of 100 and 33 lanes (not a multiple of
# 32), mod 128 and 1000
SCATTER_SHAPES = [
    (kernels.FLAT, (5000,), 262144), (kernels.FLAT, (5000,), 1000),
    (kernels.FLAT, (300,), 16), (kernels.FLAT, (0,), 1000),
    (kernels.ROW, (7, 128), 128), (kernels.ROW, (5, 100), 1000),
    (kernels.ROW, (3, 33), 128),
]
# start indices over all of int32 (negative ones under ADD), or every lane
# on one cell (a hot spot: under the LCG every chain is the same)
SCATTER_INDICES = {
    "int32": lambda shape, rng: rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                                             dtype=np.int64).astype(np.int32),
    "hot": lambda shape, rng: np.full(shape, 12345, np.int32),
}


@pytest.mark.parametrize("pattern", list(SCATTER_INDICES))
@pytest.mark.parametrize("layout,xshape,mod", SCATTER_SHAPES)
@pytest.mark.parametrize("rule", [kernels.ADD, kernels.LCG_BEFORE])
def test_scatter_kernel_edges(cuda, rule, layout, xshape, mod, pattern):
    """The scatter kernel against its plain version (index_add_, step by
    step) for 1, 4 and 33 steps, within 1e-5 of the maximum (float32 adds
    in another order), the same cells non-zero. The kernel writes all of
    out: nothing is zeroed for it."""
    rng = np.random.default_rng(sum(xshape) + mod + rule)
    ix = torch.as_tensor(SCATTER_INDICES[pattern](xshape, rng), device=cuda)
    v = torch.as_tensor(rng.uniform(0.0, 1.0, xshape).astype(np.float32),
                        device=cuda)
    for reps in (1, 4, 33):
        ref = kernels.scatter_plain(ix, v, rule, layout, mod, reps)
        n0 = kernels.launches["probe_scatter"]
        got = kernels.scatter(ix, v, rule, layout, mod, reps)
        assert kernels.launches["probe_scatter"] == n0 + 1
        torch.cuda.synchronize()
        err = common.error(got, ref, common.REL_OF_MAX)
        assert err <= common.LIMITS[common.REL_OF_MAX], (reps, err)
        assert int((got != 0).sum()) == int((ref != 0).sum()), reps


@pytest.mark.parametrize("nk", [1, 128, 130])
@pytest.mark.parametrize("ncols,offset", [(128, 0), (100, 0), (128, 1)])
@pytest.mark.parametrize("mod", [2048, 1000])
def test_row_gather_kernel_edges(cuda, nk, ncols, offset, mod):
    """The row-gather kernel against its plain version for 1, 32 and 33
    steps (one pass of 32 and a second of one step) over all of int32's
    start indices, within 1e-6 relative: rows of 128 floats read as
    float4 and rows of 100 (not a multiple of 4) or starting 4 bytes off
    16 (offset 1) read as scalars."""
    rng = np.random.default_rng(nk * ncols + mod + offset)
    flat = torch.as_tensor(rng.random(mod * ncols + 1, np.float32),
                           device=cuda)
    t = flat[offset:offset + mod * ncols].view(mod, ncols)
    r = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, (2, 140),
                                     dtype=np.int64).astype(np.int32),
                        device=cuda)
    for reps in (1, 32, 33):
        n0 = kernels.launches["probe_row_gather"]
        got = kernels.row_gather(t, r, reps, nk)
        assert kernels.launches["probe_row_gather"] == n0 + 1
        ref = kernels.row_gather_plain(t, r, reps, nk)
        torch.cuda.synchronize()
        err = common.error(got, ref, common.REL)
        assert err <= common.LIMITS[common.REL], (reps, err)


def test_probe_wrappers_check_inputs(cuda):
    t = torch.rand(2048, 128, device=cuda)
    ix = torch.randint(0, 2048, (1024, 128), device=cuda,
                       dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.gather(t, ix.long(), kernels.ADD, kernels.FLAT, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gather(t.T, ix, kernels.ADD, kernels.FLAT, 2)
    with pytest.raises(ValueError, match="ROW"):
        kernels.gather(t, ix, kernels.LCG_BEFORE, kernels.ROW, 2)
    with pytest.raises(ValueError, match="onehot"):
        kernels.onehot(ix, t[:1024], 3, 1, True)
    far = torch.tensor([0, 512 * 512], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        kernels.onehot(far, torch.ones(2, device=cuda), 1, 1, False)
    v = t[:1024].contiguous()
    with pytest.raises(ValueError, match="ROW scatter"):
        kernels.scatter(ix, v, kernels.ADD, kernels.ROW, 10 ** 6, 4)
    with pytest.raises(ValueError, match="row_gather"):
        kernels.row_gather(t, ix, 4, 200)


def test_pipeline_on_card_matches_cpu(cuda, tmp_path):
    """The `pipeline` slice on the card against the same slice on the CPU.
    Packets follow the same Threefry streams on both devices; the card's
    exp/log and its atomic tally order differ by rounding, so totals are
    held at 2e-3 and 99% of the per-cell entries at 1e-4."""
    kw = dict(kind="gset", nfreq=16, nsize=6, extra="nenumber 32\n")
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("gpu", cuda)):
        ini = write_model(str(tmp_path / name), 8, **kw)
        n0 = a2e_kernel.launches
        res_rt, emitted, res_map = full.run_pipeline(ini, device=dev,
                                                     lanes=1 << 12)
        launched = a2e_kernel.launches - n0
        # on the card one launch per visible card, each over its cells
        assert launched == (torch.cuda.device_count()
                            if dev.type == "cuda" else 0)
        out[name] = (res_rt, emitted, res_map.maps[0])
    (rc, ec, mc), (rg, eg, mg) = out["cpu"], out["gpu"]
    bal = (rg.absorbed_photons + rg.escaped) / rg.injected - 1
    assert np.abs(bal).max() < 1e-4
    np.testing.assert_allclose(rg.absorbed.sum(0), rc.absorbed.sum(0),
                               rtol=2e-3)
    np.testing.assert_allclose(eg.sum(0), ec.sum(0), rtol=2e-3,
                               atol=1e-12 * np.abs(ec.sum(0)).max())
    for a, b in ((rg.absorbed, rc.absorbed), (eg, ec), (mg, mc)):
        close = np.isclose(a, b, rtol=1e-4, atol=1e-7 * np.abs(b).max())
        assert close.mean() > 0.99
    assert os.path.exists(tmp_path / "gpu" / "map_dir_00.bin")
