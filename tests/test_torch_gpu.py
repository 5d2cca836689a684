"""soc_tpu_torch on a CUDA device: the A2E kernels (pre-folded and clamp)
against their plain twin, the wrapper's checks, the sharded A2E solve
against one launch, the probes' four kernels against their plain
versions, the slice on the card against the slice on the CPU, and the
`devices N` path over cuda:0 three times against the one-device run,
the scattered-light runs on the card against the CPU's, two processes
on cuda:0 (parallel/dist.py) against one process, and the transport's
fused march block (csrc/march.cu) against the eager block.
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
                                         seeded_a2e_stacks,
                                         synthetic_absorbed,
                                         write_sca_model,
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


def solve_beyond(device, kernel, nfreq, ne, seed):
    """An A2E kernel on one size of seeded stacks (example_model.
    seeded_a2e_stacks: 512 cells, the align weights; the clamp kernel with a
    negative weight and negative absorbed values) at a shape its picker
    sends to the global form, against the plain twin; returns (max
    relative difference of EMIT, of PEMIT, the kernel's config). Raises
    if the shared form was picked or the launch was not counted."""
    clamp = kernel == "clamp"
    stacks, ab = seeded_a2e_stacks(seed, ne, nfreq, device, clamp=clamp,
                                   negate=clamp)
    rng = np.random.default_rng(seed)
    if clamp:
        ab = with_negative_entries(rng, ab)
    ab = torch.as_tensor(ab, device=device)
    align = torch.as_tensor(rng.uniform(0, 1, (1, ab.shape[0]))
                            .astype(np.float32), device=device)
    pick = a2e_kernel.pick_clamp_config if clamp \
        else a2e_kernel.pick_fold_config
    config = pick(a2e_kernel._lib(), nfreq, ne, device.index or 0)
    if config.form != "global":
        raise AssertionError("NE %d, NFREQ %d: %s picked the %s form"
                             % (ne, nfreq, kernel, config.form))
    count = "clamp_global_launches" if clamp else "global_launches"
    n0 = getattr(a2e_kernel, count)
    solve = a2e_kernel.solve_all_sizes_clamp if clamp \
        else a2e_kernel.solve_all_sizes
    tot, ptot = solve(stacks, ab, align)
    if getattr(a2e_kernel, count) != n0 + 1:
        raise AssertionError("the global form's launch was not counted")
    tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align,
                                                     batch=64)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(tot).all()) and bool(torch.isfinite(ptot).all())
    return _max_rel(tot, tot_p), _max_rel(ptot, ptot_p), config


# (kernel, NFREQ, NE): one of the two given, the other the largest that
# the kernel's picker admits on this card (a2e_kernel.shape_ceiling): NE
# at NFREQ 1000, NFREQ at NE 256 and at NE 32
CEILING_CASES = [(k, nf, ne) for k in ("fold", "clamp")
                 for nf, ne in ((1000, None), (None, 256), (None, 32))]


@pytest.mark.parametrize("kernel,nfreq,ne", CEILING_CASES)
def test_kernel_at_its_shape_ceiling(cuda, tmp_path, kernel, nfreq, ne):
    """Each A2E kernel at the largest shape its shared form takes in this
    card's shared memory, found through its picker (the library's own
    sizing and cap): one size, 300 cells, against the plain twin (1e-4
    relative; the clamp kernel on a negative weight and negative absorbed
    values); one step beyond, the picker turns to the global form, which
    solves seeded stacks of that shape within the same tolerance."""
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
    pick = a2e_kernel.pick_clamp_config if clamp \
        else a2e_kernel.pick_fold_config
    assert pick(lib, nfreq, ne, index).form == "shared"
    tot, ptot = solve(stacks, ab, align)
    tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(tot).all()) and bool(torch.isfinite(ptot).all())
    assert _max_rel(tot, tot_p) < REL_TOL
    assert _max_rel(ptot, ptot_p) < REL_TOL
    rel, prel, _ = solve_beyond(cuda, kernel, beyond[0], beyond[1],
                                ne + nfreq)
    assert rel < REL_TOL and prel < REL_TOL, (rel, prel)


@pytest.mark.parametrize("kernel,nfreq,ne,run", [
    ("fold", 44, 1856, 64), ("fold", 1088, 256, 16),
    ("clamp", 44, 1856, 64), ("clamp", 1088, 256, 16),
    ("fold", 3300, 16, 0), ("clamp", 3700, 16, 0)])
def test_kernel_beyond_its_ceiling(cuda, kernel, nfreq, ne, run):
    """Both A2E kernels' global form at shapes beyond the shared form's
    ceiling: NE 1856 at NFREQ 44 and NFREQ 1088 at NE 256 (staged runs of
    64 and 16), and above NFREQ 3200 at NE 16, where not even two runs of
    8 fit and the weights are read unstaged (run 0): one size, 512 cells,
    the align weights, against the plain twin at 1e-4 relative."""
    rel, prel, config = solve_beyond(cuda, kernel, nfreq, ne, ne + nfreq)
    assert config.run == run, config
    assert rel < REL_TOL and prel < REL_TOL, (rel, prel)


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
                            a2e_kernel.Config(tile, lr, warps))
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


def _close_on_card(got, ref):
    """The card against the CPU (see test_pipeline_on_card_matches_cpu):
    totals per channel at 2e-3, 99% of the entries at 1e-4."""
    tot = ref.reshape(-1, ref.shape[-1]).sum(0)
    np.testing.assert_allclose(got.reshape(-1, got.shape[-1]).sum(0), tot,
                               rtol=2e-3, atol=1e-12 * np.abs(tot).max())
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-7 * np.abs(ref).max())
    assert close.mean() > 0.99


def test_octree_rt_phase2_on_card_matches_cpu(cuda, tmp_path):
    """`rt` on a 3-level octree with cell packets, `ali 1` and `reference
    1` (iterations 3: two ALI passes, each one mixed pool with the XAB
    tally, delta fields with negative weights) on the card against the
    same run on the CPU; each cell pass balances per channel."""
    kw = dict(kind="eqdust", nfreq=8, octree=(2, 8, 3), cellpackets=1280,
              iterations=3, extra="ali 1\nreference 1\n")
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("gpu", cuda)):
        ini = write_model(str(tmp_path / name), 8, **kw)
        out[name] = driver.run(ini, device=dev, lanes=1 << 12)
    rc, rg = out["cpu"], out["gpu"]
    assert [s["route"] for s in rg.cell_passes] == ["ali", "ali"]
    for st in rg.cell_passes:
        assert np.abs(driver.pass_balance(st)).max() < 1e-4
    np.testing.assert_allclose(rg.temperature, rc.temperature, rtol=1e-4)
    for a, b in ((rg.absorbed, rc.absorbed), (rg.emitted, rc.emitted),
                 (rg.maps[0], rc.maps[0])):
        _close_on_card(a, b)
    assert os.path.exists(tmp_path / "gpu" / "OXAB.save")


def test_octree_pipeline_on_card(cuda, tmp_path):
    """The `pipeline` verb on a 3-level octree: one A2E launch a card over
    every cell, the parent cells' emission zero, against the CPU run."""
    kw = dict(kind="gset", nfreq=16, nsize=6, octree=(2, 8, 3),
              extra="nenumber 32\n")
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("gpu", cuda)):
        ini = write_model(str(tmp_path / name), 8, **kw)
        n0 = a2e_kernel.launches
        res_rt, emitted, res_map = full.run_pipeline(ini, device=dev,
                                                     lanes=1 << 12)
        assert a2e_kernel.launches - n0 == \
            (torch.cuda.device_count() if dev.type == "cuda" else 0)
        out[name] = (res_rt, emitted, res_map.maps[0])
    (rc, ec, mc), (rg, eg, mg) = out["cpu"], out["gpu"]
    parents = rg.absorbed[:, 0] < -1e19
    assert rg.grid.levels == 3 and parents.sum() == 16
    assert (eg[parents] == 0).all() and eg[~parents].max() > 0
    bal = (rg.absorbed_photons + rg.escaped) / rg.injected - 1
    assert np.abs(bal).max() < 1e-4
    for a, b in ((rg.absorbed[~parents], rc.absorbed[~parents]), (eg, ec),
                 (mg, mc)):
        _close_on_card(a, b)


SOURCES = [(3.1, 2.9, 3.2, 0.3), (2.8, 3.3, 14.0, 1.0)]


def _rt_cpu_and_card(cuda, tmp_path, n=6, **kw):
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("gpu", cuda)):
        ini = write_model(str(tmp_path / name), n, kind="eqdust", nfreq=6,
                          **kw)
        out[name] = driver.run(ini, device=dev, lanes=1 << 12)
    return out["cpu"], out["gpu"]


def _hold_sources(rc, rg, rtol_t=1e-4):
    """A phase-1 run on the card against the CPU: the same packets, the
    atomics in another order (see test_pipeline_on_card_matches_cpu)."""
    assert [s["source"] for s in rg.source_passes] == \
        [s["source"] for s in rc.source_passes]
    on = rg.launched > 0
    bal = (rg.absorbed_photons + rg.escaped + rg.missed)[on] \
        / rg.launched[on] - 1
    assert np.abs(bal).max() < 1e-5
    np.testing.assert_allclose(rg.launched, rc.launched, rtol=1e-6)
    np.testing.assert_allclose(rg.temperature, rc.temperature, rtol=rtol_t)
    for a, b in ((rg.absorbed, rc.absorbed), (rg.maps[0], rc.maps[0])):
        _close_on_card(a, b)


@pytest.mark.parametrize("method", [0, 1, 2, 3, 4, 5])
def test_point_sources_on_card_match_cpu(cuda, tmp_path, method):
    """An internal and an external point source, each PS_METHOD."""
    rc, rg = _rt_cpu_and_card(cuda, tmp_path, point_sources=SOURCES,
                              ps_method=method, pspackets=3000)
    _hold_sources(rc, rg)
    np.testing.assert_allclose(rg.missed, rc.missed, rtol=1e-4,
                               atol=1e-6 * rc.launched.max())


def test_sky_diffuse_simum_saveint_on_card_match_cpu(cuda, tmp_path):
    """The weighted Healpix sky (the per-lane search of each channel's
    cdf), the diffuse field, `simum` over half the channels and the
    (I, Ix, Iy, Iz) tally of `saveint 2`."""
    rc, rg = _rt_cpu_and_card(cuda, tmp_path, hpbg=4, hpbg_weighted=True,
                              diffuse=0.5, dfpackets=4 * 216,
                              simum=(1.0, 300.0), saveint=2)
    _hold_sources(rc, rg)
    masked = rg.launched == 0
    assert masked.any() and (rg.absorbed_photons[masked] == 0).all()
    assert rg.intensity.shape == (216, 6, 4)
    _close_on_card(rg.intensity[..., 0], rc.intensity[..., 0])
    assert np.isfinite(rg.intensity).all()


@pytest.mark.parametrize("mode", ["saveint 1", "dustem"])
def test_intensity_modes_on_card_match_cpu(cuda, tmp_path, mode):
    """saveint 1 and dustem (no absorbed file): the [CELLS, NFREQ]
    intensity on the card against the CPU's."""
    rc, rg = _rt_cpu_and_card(cuda, tmp_path, point_sources=SOURCES,
                              pspackets=2000, extra=mode + "\n")
    assert rg.intensity.shape == (216, 6)
    assert (rg.absorbed is None) == (mode == "dustem")
    _close_on_card(rg.intensity, rc.intensity)
    np.testing.assert_allclose(rg.temperature, rc.temperature, rtol=1e-4)


@pytest.mark.parametrize("half", [False, True])
def test_abundance_on_card_matches_cpu(cuda, tmp_path, half):
    """Two dusts with per-cell abundances and MSF, with and without
    optishalf (the per-cell tables a cuBLAS product on the card, TF32
    off): the runs as above."""
    rc, rg = _rt_cpu_and_card(cuda, tmp_path, abundance=True,
                              optishalf=half, point_sources=SOURCES,
                              pspackets=2000)
    _hold_sources(rc, rg)


def test_split_on_card_matches_cpu(cuda, tmp_path):
    """Splitting on the card (serve_clones' request map a stable
    partition, no index out of range): on a 3-level octree, the split
    background and sky at the same lane count as the CPU run. A packet
    whose path an ulp diverges can shift other lanes' splits, so the
    clones are held to 2% and the temperatures to 2%."""
    rc, rg = _rt_cpu_and_card(cuda, tmp_path, n=8, octree=(2, 8, 3),
                              hpbg=4, hpbg_weighted=True, split=4)
    for sc, sg in zip(rc.source_passes, rg.source_passes):
        assert sg["clones"] > 0
        assert abs(sg["clones"] - sc["clones"]) <= 0.02 * sc["clones"]
    on = rg.launched > 0
    bal = (rg.absorbed_photons + rg.escaped)[on] / rg.launched[on] - 1
    assert np.abs(bal).max() < 1e-5
    np.testing.assert_allclose(rg.temperature, rc.temperature, rtol=0.02)


def test_pipeline_abundance_on_card(cuda, tmp_path):
    """The `pipeline` verb with two GSET dusts and per-cell abundances:
    one A2E launch a card and a dust, against the CPU run."""
    kw = dict(kind="gset", nfreq=16, nsize=6, abundance=True,
              extra="nenumber 32\n")
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("gpu", cuda)):
        ini = write_model(str(tmp_path / name), 6, **kw)
        n0 = a2e_kernel.launches
        res_rt, emitted, _ = full.run_pipeline(ini, device=dev,
                                               lanes=1 << 12)
        assert a2e_kernel.launches - n0 == \
            (2 * torch.cuda.device_count() if dev.type == "cuda" else 0)
        out[name] = (res_rt, emitted)
    (rc, ec), (rg, eg) = out["cpu"], out["gpu"]
    _close_on_card(rg.absorbed, rc.absorbed)
    _close_on_card(eg, ec)


def test_octree_pipeline_sources_on_card(cuda, tmp_path):
    """The `pipeline` verb on a 3-level octree with the split background,
    point sources, a diffuse field and saveint 2: one A2E launch a card,
    the parents' emission zero, against the CPU run."""
    kw = dict(kind="gset", nfreq=16, nsize=6, octree=(2, 8, 3),
              extra="nenumber 32\n", split=4,
              point_sources=[(4.3, 3.7, 4.1, 0.3)], pspackets=1000,
              diffuse=0.5, dfpackets=1280, saveint=2)
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("gpu", cuda)):
        ini = write_model(str(tmp_path / name), 8, **kw)
        n0 = a2e_kernel.launches
        res_rt, emitted, _ = full.run_pipeline(ini, device=dev,
                                               lanes=1 << 12)
        assert a2e_kernel.launches - n0 == \
            (torch.cuda.device_count() if dev.type == "cuda" else 0)
        out[name] = (res_rt, emitted)
    (rc, ec), (rg, eg) = out["cpu"], out["gpu"]
    parents = rg.absorbed[:, 0] < -1e19
    assert (eg[parents] == 0).all() and eg[~parents].max() > 0
    assert rg.intensity.shape == (640, 16, 4)
    leaf = ~parents
    _close_on_card(rg.absorbed[leaf], rc.absorbed[leaf])
    _close_on_card(eg, ec)


ROI_BOX = (1, 6, 1, 2, 1, 6)


def test_roi_save_and_load_on_card_match_cpu(cuda, tmp_path):
    """`roi` + `roisave` on a 3-level octree (the crossing tally with its
    spare slots, Healpix pixels of the lanes' directions), then `roiload`
    on the box's sub-model from the CPU run's file, both stages on the
    card against the CPU: the ROI tallies as the absorbed files (totals
    per channel at 2e-3, 99% of the entries at 1e-4)."""
    extra = ("roi %d %d %d %d %d %d\nroisave roi.bin 1\nroinside 2\n"
             % ROI_BOX)
    rc, rg = _rt_cpu_and_card(cuda, tmp_path, n=8, octree=(2, 8, 3),
                              extra=extra)
    _hold_sources(rc, rg)
    assert rg.roi_tally.shape == rc.roi_tally.shape
    _close_on_card(rg.roi_tally.T, rc.roi_tally.T)
    roi_file = str(tmp_path / "cpu" / "roi.bin")
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("gpu", cuda)):
        ini = write_model(str(tmp_path / ("sub_" + name)), 8, kind="eqdust",
                          nfreq=6, octree=(2, 8, 3), roi_box=ROI_BOX,
                          bgpac=0, extra="roiload %s\nroipackets 23040\n"
                          % roi_file)
        out[name] = driver.run(ini, device=dev, lanes=1 << 12)
    _hold_sources(out["cpu"], out["gpu"])
    np.testing.assert_allclose(out["gpu"].injected, out["cpu"].injected,
                               rtol=1e-12)


@pytest.mark.parametrize("extra", [
    "mirror xyz\n", "stepweight 2 1.3 0.4\n", "stepweight 1 1.4\n",
    "direweight 1 0.5\n"])
def test_mirror_and_weights_on_card_match_cpu(cuda, tmp_path, extra):
    """The mirrored low faces (the reflected lanes re-indexed from the
    root on the octree) and the step and direction weighting, with point sources
    inside and outside the cloud, on the card against the CPU."""
    rc, rg = _rt_cpu_and_card(cuda, tmp_path, n=8, octree=(2, 8, 3),
                              point_sources=SOURCES, pspackets=3000,
                              extra=extra)
    if extra.startswith("mirror"):
        # the three low faces, an octant of a symmetric cloud: between two
        # mirrored opposite faces a grazing packet of a nearly transparent
        # channel bounces for ~1e5 steps and more
        _hold_sources(rc, rg)
    else:
        # the weights make the balance hold in expectation only: the
        # card against the CPU, the same packets
        np.testing.assert_allclose(rg.launched, rc.launched, rtol=1e-6)
        np.testing.assert_allclose(rg.temperature, rc.temperature,
                                   rtol=1e-4)
        for a, b in ((rg.absorbed, rc.absorbed), (rg.maps[0], rc.maps[0])):
            _close_on_card(a, b)


def _render_inputs(dev):
    from soc_tpu_torch.example_model import octree_cloud
    from soc_tpu_torch.grid import grid_from_arrays
    lcells, values = octree_cloud(8, 2, 8, 3)
    grid = grid_from_arrays(8, 8, 8, lcells, values, dev)
    rng = np.random.default_rng(3)
    emit = torch.as_tensor(rng.uniform(0, 1, (grid.cells, 4))
                           .astype(np.float32), device=dev)
    ext = torch.tensor([0.05, 0.2, 0.5, 1.0], device=dev)
    return grid, emit, ext


def _renders(dev):
    from soc_tpu_torch.render import mapping as m
    grid, emit, ext = _render_inputs(dev)
    odir, ra, de = m.observer_basis(np.radians(70.0), np.radians(10.0))
    c, obs = (4.0, 4.0, 4.0), (3.3, 4.1, 4.7)
    out = {"ortho": m.render_ortho(grid, emit, ext, odir, ra, de, c, 0.5,
                                   (12, 10)),
           "mapint": m.render_ortho(grid, emit, ext, odir, ra, de, c, 0.5,
                                    (12, 10), map_interp=2),
           "yshear": m.render_ortho(grid, emit, ext, odir, ra, de, c, 0.5,
                                    (12, 10), use_shear=True, y_shear=2.0,
                                    maxlos=24.0),
           "perspective": m.render_perspective(grid, emit, ext, obs,
                                               (16, 8)),
           "pstau": m.render_pstau(grid, ext, np.asarray(
               [[3.0, 4.0, 5.0], [1.0, 7.0, 2.0]], np.float32), odir),
           "ortho_hier": (m.render_ortho_hier(grid, emit, ext, odir, ra, de,
                                              c, 0.5, (12, 10)),),
           "healpix_hier": m.render_healpix_hier(grid, emit, ext, obs, 4)}
    for mode in (0, 1, 2, 3):
        out["healpix%d" % mode] = m.render_healpix(grid, emit, ext, obs, 4,
                                                   interpolate=mode)
    return {k: [t.cpu().numpy() for t in v] for k, v in out.items()}


def test_renderers_on_card_match_cpu(cuda):
    """Every renderer (and each `interpolate` mode) on the card against
    the CPU: the same float32 steps, the card's exp, sin and cos a few
    ulps off the CPU's: 1e-5 of each output's peak, but for `interpolate
    3`, where a lookup point within an ulp of a cell face may fall into
    the neighbouring cell: 0.5% of the entries may differ by up to 1e-3
    of the peak."""
    gpu, cpu = _renders(cuda), _renders(torch.device("cpu"))
    for name in cpu:
        for g, c in zip(gpu[name], cpu[name]):
            peak = max(np.abs(c).max(), 1e-30)
            assert np.isfinite(g).all(), name
            if name == "healpix3":
                assert (np.abs(g - c) > 1e-5 * peak).mean() <= 0.005
                np.testing.assert_allclose(g, c, rtol=0, atol=1e-3 * peak)
            else:
                np.testing.assert_allclose(g, c, rtol=0, atol=1e-5 * peak,
                                           err_msg=name)


def _pol_renders(dev):
    """Every polarization render of the octree (render/polarization.py)
    with a tangled field, |B| <= 1, and a `threshold`-like mask of the
    root level."""
    from soc_tpu_torch.render import mapping as m
    from soc_tpu_torch.render import polarization as p
    grid, emit, ext = _render_inputs(dev)
    rng = np.random.default_rng(5)
    b = np.asarray([0.1, 0.5, 0.2]) + rng.normal(0, 0.25, (grid.cells, 3))
    b = torch.as_tensor((b / np.maximum(1.0, np.linalg.norm(b, axis=1))
                         [:, None]).astype(np.float32), device=dev)
    cell_w = (torch.arange(grid.cells, device=dev) >= 512).to(torch.float32)
    odir, ra, de = m.observer_basis(np.radians(70.0), np.radians(10.0))
    c, obs, npix = (4.0, 4.0, 4.0), (3.3, 4.1, 4.7), (12, 10)
    out = {}
    for name, kw in (("plain", {}), ("polred", dict(polred=True)),
                     ("rho", dict(rho_weight=True)),
                     ("window", dict(minlos=2.0, maxlos=6.5)),
                     ("shear", dict(use_shear=True, y_shear=2.0,
                                    maxlos=16.0))):
        out["pol_" + name] = p.render_pol(grid, emit, ext, b, 0.2, odir, ra,
                                          de, c, 0.5, npix, **kw)
    for mode in (0, 1, 2, 3):
        out["pol_hp%d" % mode] = p.render_pol_healpix(
            grid, emit, ext, b, 0.2, obs, 4, interpolate=mode)
    for name, w in (("stat", None), ("stat_w", cell_w)):
        out[name] = p.render_polstat(grid, emit, ext, b, odir, ra, de, c,
                                     0.5, npix, cell_w=w)
    out["stat_hp"] = p.render_polstat_healpix(grid, emit, ext, b, obs, 4,
                                              maxlos=5.0)
    out["stat_hp_shear"] = p.render_polstat_healpix(
        grid, emit, ext, b, obs, 4, use_shear=True, y_shear=2.0,
        maxlos=16.0)
    return {k: ({kk: t.cpu().numpy() for kk, t in v.items()}
                if isinstance(v, dict) else [t.cpu().numpy() for t in v])
            for k, v in out.items()}


def test_polarization_renders_on_card_match_cpu(cuda):
    """Every polarization render on the card against the CPU, at
    tests/test_torch_polarization.py's tolerances: Stokes planes and
    column densities 1e-5 of each plane's peak (for `interpolate 3` 0.5%
    of the entries up to 1e-3, as test_renderers_on_card_match_cpu); rT
    and jT 1e-4 rad on all but 1% of the pixels; rI and jI as cos^2 at
    1e-5, B, B_LOS, B_POS, tau and N at 1e-5 of the peak (under the mask
    on all but 1% of the pixels, none beyond ten times that)."""
    gpu, cpu = _pol_renders(cuda), _pol_renders(torch.device("cpu"))
    for name in cpu:
        if isinstance(cpu[name], dict):
            masked = name == "stat_w"
            for key, c in cpu[name].items():
                g = gpu[name][key]
                assert np.isfinite(g).all(), (name, key)
                if key in ("rT", "jT"):
                    assert (np.abs(g - c) > 1e-4).mean() <= 0.01, (name, key)
                    continue
                if key in ("rI", "jI"):
                    g, c = np.cos(g) ** 2, np.cos(c) ** 2
                    tol = 1e-5
                else:
                    tol = 1e-5 * max(np.abs(c).max(), 1e-30)
                assert (np.abs(g - c) > tol).mean() <= \
                    (0.01 if masked else 0.0), (name, key)
                np.testing.assert_allclose(g, c, rtol=0, atol=10 * tol,
                                           err_msg="%s %s" % (name, key))
            continue
        for k, (g, c) in enumerate(zip(gpu[name], cpu[name])):
            assert np.isfinite(g).all(), name
            for gp, cp in (zip(g, c) if k < 3 else [(g, c)]):
                peak = max(np.abs(cp).max(), 1e-30)
                if name == "pol_hp3":
                    assert (np.abs(gp - cp) > 1e-5 * peak).mean() <= 0.005
                    np.testing.assert_allclose(gp, cp, rtol=0,
                                               atol=1e-3 * peak)
                else:
                    np.testing.assert_allclose(gp, cp, rtol=0,
                                               atol=1e-5 * peak,
                                               err_msg="%s %d" % (name, k))


def test_pipeline_polarisation_on_card(cuda, tmp_path):
    """The `pipeline` verb with `polarisation` and `polmap` on a 16^3
    cloud (4,096 cells): a2e_all_sizes launched once a card, with the
    align weights; PEMITTED within REL_TOL of the plain twin's polarised
    sum over the same absorptions, <emitted>.P equal to it, at most
    EMITTED; the polarization map finite."""
    from soc_tpu_torch.io.fields import read_cell_frequency_array
    from soc_tpu_torch.solve.solver_file import read_solver
    ini = write_model(str(tmp_path), 16, kind="gset", nfreq=16, nsize=6,
                      bfield="tangled", polarisation=True,
                      extra="nenumber 32\npolmap Bx.bin By.bin Bz.bin\n")
    n0, a0 = a2e_kernel.launches, a2e_kernel.align_launches
    res_rt, emitted, res_map = full.run_pipeline(ini, device=cuda,
                                                 lanes=1 << 12)
    ncard = torch.cuda.device_count()
    assert (a2e_kernel.launches - n0, a2e_kernel.align_launches - a0) == \
        (ncard, ncard)
    pem = res_map.pemitted
    assert pem.shape == (4096, 16) and np.isfinite(pem).all()
    np.testing.assert_array_equal(
        read_cell_frequency_array(str(tmp_path / "emitted.data.P")), pem)
    assert (pem <= emitted * (1 + 1e-5)).all() and pem.max() > 0
    sol = read_solver(str(tmp_path / "gs_TST.solver"))
    aalg = np.fromfile(str(tmp_path / "aalg.bin"), np.float32)[1:]
    _, ref = stochastic.solve_emission(sol, res_rt.absorbed,
                                       torch.device("cpu"), aalg=aalg)
    assert _max_rel(torch.as_tensor(pem), torch.as_tensor(ref)) < REL_TOL
    assert np.isfinite(res_map.maps[("pol", 0)][0]).all()


# scattered light (the `sca` verb): the cases of test_torch_sca_pipeline.py
SCA_PS = [(8.1, 7.9, 8.2, 0.3), (7.5, 8.3, 30.0, 1.0)]
SCA_CASES = {
    "bg": dict(n=16),
    "hpbg": dict(n=16, hpbg=4, background=False),
    "ps": dict(n=16, bgpac=0, point_sources=SCA_PS, pspackets=3000),
    "cell": dict(n=16, bgpac=0, emitted=0.5, cellpackets=2 * 4096),
    "roi": dict(n=16, bgpac=0, roiload=(0.5, 30000)),
    "diffuse": dict(n=16, bgpac=0, diffuse=0.5, dfpackets=2 * 4096),
    "all_octree": dict(n=8, octree=(2, 8, 3), hpbg=4,
                       point_sources=[(4.1, 3.9, 4.2, 0.3)], pspackets=2000,
                       emitted=0.3, cellpackets=1280, diffuse=0.3,
                       dfpackets=1280),
    "msf_octree": dict(n=8, octree=(2, 8, 3), abundance=True),
    "intobs": dict(n=16, intobs=(8.3, 7.7, 8.1), outnside=8),
    "fits": dict(n=16, fits=True),
    "ffs0": dict(n=16, ffs=0),
}


def _sca_model(d, name):
    kw = dict(SCA_CASES[name])
    n = kw.pop("n")
    return write_sca_model(str(d), n, nfreq=8, simum=(0.05, 3.0), **kw)


def _sca_close(got, ref):
    """Each lit channel within 1e-4 of its peak but for 3% of the pixels
    (a packet whose path an ulp of the card's exp/log turns elsewhere),
    its sum within 1e-3 (tests/test_torch_sca_pipeline.py's bound)."""
    assert got.shape == ref.shape
    for f in range(ref.shape[0]):
        if not ref[f].any():
            assert not got[f].any()
            continue
        diff = np.abs(got[f] - ref[f])
        assert (diff > 1e-4 * ref[f].max()).mean() <= 0.03, f
        assert abs(got[f].sum() / ref[f].sum() - 1) < 1e-3, f


@pytest.mark.parametrize("name", list(SCA_CASES))
def test_scattering_on_card_matches_cpu(cuda, tmp_path, name):
    """scattering.run on the card against the same run on the CPU (the
    same packets; the card's ulps and atomics), every source alone and
    together, MSF, the internal observer, FITS and ffs 0; then a same-seed
    rerun on the card within the atomics bound (1e-4 relative or 1e-6 of
    the peak) and every event's rays deposited."""
    from soc_tpu_torch.pipeline import scattering
    ini = _sca_model(tmp_path, name)
    ref = scattering.run(ini, device="cpu", lanes=4096)
    passes = []
    got = scattering.run(ini, device=cuda, lanes=4096, passes=passes)
    assert np.isfinite(got).all() and (got >= 0).all()
    _sca_close(got, ref)
    ndir = got.shape[1] if got.ndim == 4 else 1
    assert all(p["rays"] == p["events"] * ndir > 0 for p in passes)
    again = scattering.run(ini, device=cuda, lanes=4096)
    np.testing.assert_allclose(again, got, rtol=1e-4, atol=1e-6 * got.max())


@pytest.mark.parametrize("name", ["bg", "intobs"])
def test_scattering_devices_on_card(cuda, tmp_path, name):
    """`devices 2` as cuda:0 twice (the shards share the card): equal to
    the one-pool run within soc_tpu's sharded bound (rtol 2e-4, atol 1e-6
    of the peak)."""
    from soc_tpu_torch.pipeline import scattering
    ini = _sca_model(tmp_path, name)
    one = scattering.run(ini, device=cuda, lanes=4096)
    two = scattering.run(ini, device=cuda, lanes=4096,
                         devices=[cuda, cuda])
    np.testing.assert_allclose(two, one, rtol=2e-4, atol=1e-6 * one.max())


# the surrogates and the streamed A2E solve (BASELINE config 5's layer)

def test_library_lookup_on_card_matches_twin(cuda):
    """The lookup on the card (float32 bins, one index_select) picks the
    NumPy twin's bin in >= 99.9% of the cells (soc_tpu's bound)."""
    from soc_tpu_torch.solve import library
    rng = np.random.default_rng(7)
    absorbed = rng.lognormal(0.0, 2.0, (200000, 16)).astype(np.float32)
    emitted = rng.random((200000, 16)).astype(np.float32)
    lib = library.build_library(absorbed[:50000], emitted[:50000],
                                [1, 5, 9], nbins=32)
    got = library.solve_with_library(lib, absorbed, device=cuda)
    twin = library.solve_with_library(lib, absorbed,
                                      device=torch.device("cpu"))
    assert np.all(got == twin, axis=1).mean() > 0.999
    assert library.device_table(lib, cuda)[0].is_cuda


def test_nn_fit_and_solve_on_card(cuda):
    """nn_fit on the card (its CUDA-graphed step) reaches soc_tpu's
    held-out bounds (tests/test_nn.py:27-35); nn_solve on the card equals
    the CPU's at rtol 1e-4: two float32 forward passes (TF32 off) in
    another order, which 10**(out_sd y + out_mu) amplifies by up to
    ln(10) out_sd."""
    from soc_tpu_torch.pipeline import mabu
    from soc_tpu_torch.solve import nn
    freq = np.logspace(11.5, 15, 24)
    kabs = 1e-21 * (freq / 1e12) ** 1.7
    rng = np.random.default_rng(2)
    strength = 10.0 ** rng.uniform(1, 5, 3000)
    base = (freq / freq.max()) ** -1
    absorbed = (strength[:, None] * base[None, :]).astype(np.float32)
    emitted, _ = mabu.solve_equilibrium_eqdust(kabs, freq, absorbed)
    iabs = [4, 10, 16, 22]
    stats = {}
    model = nn.nn_fit(absorbed[:2500, iabs], emitted[:2500], cuda,
                      epochs=400, batch=256, seed=1, stats=stats)
    assert stats["steps"] == 4000
    pred = nn.nn_solve(model, absorbed[2500:, iabs], cuda)
    truth = emitted[2500:]
    m = truth > truth.max() * 1e-8
    rel = np.abs(np.log10(pred[m]) - np.log10(truth[m]))
    assert np.median(rel) < 0.02 and np.percentile(rel, 95) < 0.1
    np.testing.assert_allclose(
        pred, nn.nn_solve(model, absorbed[2500:, iabs], torch.device("cpu")),
        rtol=1e-4)


@pytest.mark.parametrize("batch", [1 << 16, 100000])
def test_streamed_a2e_on_card(cuda, tmp_path, batch):
    """The streamed solve on the card: one A2E launch a chunk, equal to the
    in-memory solve on the card bit for bit and to the plain twin on the
    CPU within REL_TOL."""
    from soc_tpu_torch.io.fields import (read_cell_frequency_array,
                                         write_cell_frequency_array)
    sol, freq = gset_solver(str(tmp_path), nfreq=12, nsize=4, ne=32)
    ab = synthetic_absorbed(np.random.default_rng(3), sol, freq, 250000)
    write_cell_frequency_array(tmp_path / "abs.bin", ab)
    ref = stochastic.solve_emission(sol, ab, cuda)
    a2e_kernel.launches = 0
    rows = stochastic.solve_emission_streaming(
        sol, tmp_path / "abs.bin", tmp_path / "emit.bin", cuda, batch=batch)
    assert rows == 250000
    assert a2e_kernel.launches == -(-250000 // batch)
    got = read_cell_frequency_array(tmp_path / "emit.bin")
    np.testing.assert_array_equal(got, ref)
    twin = stochastic.solve_emission(sol, ab[::50], torch.device("cpu"))
    assert _max_rel(torch.as_tensor(got[::50]), torch.as_tensor(twin)) \
        < REL_TOL


def test_graphed_training_step_equals_eager(cuda):
    """nn_fit's CUDA-graphed step (full batches) against the eager step on
    the same batches, an eager remainder step between graph replays: the
    same kernels on the same tensors, so the same parameters (rtol 1e-6)."""
    from soc_tpu_torch.solve import nn
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(3000, 4)).astype(np.float32),
                        device=cuda)
    y = torch.as_tensor(rng.normal(size=(3000, 6)).astype(np.float32),
                        device=cuda)

    def model():
        m = nn.EmissionMLP(4, (13, 17, 13), 6)
        m.reset_parameters(torch.Generator().manual_seed(0))
        return m.to(cuda)
    a, b = model(), model()
    oa, ob = nn.adam(a, 3e-3, 40), nn.adam(b, 3e-3, 40)
    graphed = nn._GraphedStep(b, ob, x, y, 256)
    order = torch.as_tensor(rng.permutation(3000), device=cuda)
    for i in range(30):
        sel = order[i * 97:i * 97 + (100 if i == 10 else 256)]
        la = nn._train_step(a, oa, x, y, sel)
        lb = graphed(sel) if len(sel) == 256 else \
            nn._train_step(b, ob, x, y, sel)
        torch.testing.assert_close(lb, la, rtol=1e-6, atol=0)
    assert int(ob.count) == 30
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pb, pa, rtol=1e-6, atol=1e-9)


DOMAIN_CASES = {
    "background cells": dict(cellpackets=2 * 8 ** 3, iterations=2),
    "sources octree": dict(octree=(2, 8, 3), point_sources=[
        (4.1, 3.9, 4.2, 0.3), (3.8, 4.3, 14.0, 1.0)], ps_method=4,
        pspackets=2000, hpbg=2, diffuse=0.5, dfpackets=1024,
        cellpackets=1024, extra="emweight 1 0 100\n"),
    "ali mirror": dict(octree=(2, 8, 3), cellpackets=1280, iterations=2,
                       extra="ali 1\nmirror z\n")}


@pytest.mark.parametrize("name", list(DOMAIN_CASES))
def test_domains_on_card_match_one_pool(cuda, tmp_path, name):
    """`domains` over cuda:0 four times against cuda:0's one pool, by
    soc_tpu's rule for domain runs (test_torch_domain.held); every cell
    pass's balance within 0.5%."""
    from test_torch_domain import held
    ini = write_model(str(tmp_path), 8, kind="eqdust", nfreq=8,
                      **DOMAIN_CASES[name])
    one = driver.run(ini, device=cuda, lanes=1 << 14)
    dom = driver.run(ini, device=cuda, lanes=1 << 14, domains=[cuda] * 4)
    assert dom.domains == [cuda] * 4
    assert all(st["route"] == "domains" for st in dom.source_passes)
    for f in ("ctabs", "absorbed", "temperature", "emitted"):
        if getattr(one, f) is not None:
            held(getattr(dom, f), getattr(one, f), f)
    for st in dom.cell_passes:
        assert st["slabs"] == 4
        assert np.abs(driver.pass_balance(st)).max() < 5e-3
    for so, sd in zip(one.source_passes, dom.source_passes):
        np.testing.assert_array_equal(sd["launched"], so["launched"])
        held(sd["tabs"], so["tabs"], so["source"])


@pytest.mark.parametrize("slabs", [0, 4])
def test_graphed_pools_equal_eager(cuda, tmp_path, monkeypatch, slabs):
    """The march block replayed as a CUDA graph (propagate.PoolRun) runs
    the eager block's kernels: on an octree with the split sky, a point
    source and an ALI cell pass, one pool a pass or four slabs on cuda:0,
    the graphed run launches the same packets, serves the same clones and
    holds the tallies to the card's atomic order (1e-4 relative or 1e-6
    of the maximum)."""
    from soc_tpu_torch.transport import propagate
    replays = []
    replay = propagate.PoolRun._replay

    def counted(self, lane_c):
        replays.append(1)
        return replay(self, lane_c)

    monkeypatch.setattr(propagate.PoolRun, "_replay", counted)
    runs = {}
    for graphs in (False, True):
        monkeypatch.setattr(propagate, "CUDA_GRAPHS", graphs)
        ini = write_model(str(tmp_path / str(graphs)), 8, kind="eqdust",
                          nfreq=8, octree=(2, 8, 3), hpbg=4,
                          hpbg_weighted=True, split=4,
                          point_sources=[(4.1, 3.9, 4.2, 0.3)],
                          pspackets=2000, cellpackets=1280, iterations=2,
                          extra="ali 1\n")
        runs[graphs] = driver.run(ini, device=cuda, lanes=1 << 12,
                                  domains=[cuda] * slabs if slabs else None)
        assert bool(replays) == graphs
    eager, graphed = runs[False], runs[True]
    for se, sg in zip(eager.source_passes + eager.cell_passes,
                      graphed.source_passes + graphed.cell_passes):
        assert sg.get("clones", 0) == se.get("clones", 0)
        if "launched" in se:
            np.testing.assert_array_equal(sg["launched"], se["launched"])
    assert any(st["clones"] for st in graphed.source_passes)
    for f in ("ctabs", "absorbed", "temperature", "emitted"):
        a, b = getattr(graphed, f), getattr(eager, f)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * np.abs(b).max())


def test_two_processes_on_one_card(cuda, tmp_path):
    """chip_smoke.py phase 19 (a) at a small size: the `pipeline` verb as
    two processes on cuda:0 (soc_tpu's variables, `devices 2`), held to
    one process's `devices 2` run within chip_smoke's rerun bound (1e-4
    relative or 1e-6 of the maximum: the card's atomics add in another
    order); the balance within 0.5% a channel; each process launches
    a2e_all_sizes once and a2e_clamp never; both hold the same absorbed
    and emitted arrays; process 1 writes no file."""
    import json
    import socket
    import subprocess
    import sys
    from soc_tpu_torch.io.fields import read_cell_frequency_array
    here = os.path.dirname(os.path.abspath(__file__))
    kw = dict(kind="gset", nfreq=8, nsize=4, bgpac=24576,
              extra="nenumber 32\ndevices 2\n")
    one = write_model(str(tmp_path / "one"), 16, **kw)
    full.run_pipeline(one, cuda, lanes=1 << 14, devices=[cuda] * 2)
    dirs = [tmp_path / "r0", tmp_path / "r1"]
    inis = [write_model(str(d), 16, **kw) for d in dirs]
    for name in ("TST_simple.dust", "gs_TST.solver"):   # as in a shared
        with open(tmp_path / "one" / name, "rb") as a, \
                open(dirs[1] / name, "wb") as b:        # directory
            b.write(a.read())
    before = sorted(os.listdir(dirs[1]))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for k, ini in enumerate(inis):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0],
            PYTHONPATH=os.path.dirname(here),
            SOC_TPU_COORDINATOR="127.0.0.1:%d" % port,
            SOC_TPU_NUM_PROCESSES="2", SOC_TPU_PROCESS_ID=str(k),
            SOC_TPU_DIST_TIMEOUT="120")
        spec = dict(runs=[["pipeline", os.path.basename(ini), "--lanes",
                           str(1 << 14)]])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "_torch_mp_worker.py"),
             json.dumps(spec)], cwd=str(dirs[k]), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            assert p.returncode == 0 and line, stderr[-3000:]
            out.append(json.loads(line[0][7:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for res in out:
        assert res["foreign"] == [] and res["size"] == 2
        assert (res["a2e_launches"], res["clamp_launches"]) == (1, 0)
        assert res["runs"][0]["digests"]["balance"] <= 5e-3
    for key in ("absorbed", "emitted", "ctabs"):
        assert out[0]["runs"][0]["digests"][key] \
            == out[1]["runs"][0]["digests"][key]
    for name in ("absorbed.data", "emitted.data", "map_dir_00.bin"):
        read = read_cell_frequency_array if name.endswith(".data") \
            else (lambda f: np.fromfile(f, np.float32)[2:])
        got, want = read(str(dirs[0] / name)), \
            read(str(tmp_path / "one" / name))
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())
    assert sorted(os.listdir(dirs[1])) == before


def test_march_graph_form_equals_step_form(cuda, monkeypatch):
    """march_path_lengths on the card: blocks of MARCH_BLOCK steps, a
    block captured as one CUDA graph and replayed (the first block eager),
    against the step-by-step form, bit for bit (the same kernels on the
    same values, a ray that has left masked); through one PathMarch of
    blocks of 4 steps twice, the second call only replaying its captured
    graph."""
    from soc_tpu_torch.ops import traverse
    from soc_tpu_torch.transport.sources import background_entry
    from soc_tpu_torch.utils import graphs
    calls = []
    real = graphs.GraphedBlock.__call__

    def counted(self, *args):
        calls.append(self.graph is not None)
        return real(self, *args)
    monkeypatch.setattr(graphs.GraphedBlock, "__call__", counted)
    from soc_tpu_torch.example_model import octree_cloud
    from soc_tpu_torch.grid import grid_from_arrays
    lcells, values = octree_cloud(16, 4, 8)
    grid = grid_from_arrays(16, 16, 16, lcells, values, cuda)
    stream = torch.arange(1 << 14, device=cuda) * 7919
    pos, d = background_entry(16, 16, 16, stream, 1, 99)
    step = traverse.march_path_lengths(grid, pos, d, block=1)
    torch.testing.assert_close(traverse.march_path_lengths(grid, pos, d),
                               step, rtol=0, atol=0)
    march = traverse.PathMarch(grid, 4)      # blocks of 4: many a march
    del calls[:]
    torch.testing.assert_close(march(pos, d), step, rtol=0, atol=0)
    assert calls[:2] == [False, False] and len(calls) > 2 \
        and all(calls[2:])                   # eager, capture, replays
    del calls[:]
    torch.testing.assert_close(march(pos, d), step, rtol=0, atol=0)
    assert calls and all(calls)


def test_max_iters_stops_on_card(cuda, monkeypatch):
    """transport_run(max_iters=7) on the card: exactly 7 bodies (7 is not
    a multiple of CHECK_EVERY), the march block of each through the
    pool's GraphedBlock (propagate.PoolRun): the first eager, the second
    captured, the third to the seventh graph replays."""
    from soc_tpu_torch.grid import uniform_grid
    from soc_tpu_torch.io.dust import hg_scattering_function
    from soc_tpu_torch.transport import propagate
    from soc_tpu_torch.utils import graphs
    replays = []
    real = graphs.GraphedBlock.__call__

    def counted(self, *args):
        replays.append(self.graph is not None)
        return real(self, *args)
    monkeypatch.setattr(graphs.GraphedBlock, "__call__", counted)
    grid = uniform_grid(16, 16, 16, cuda)
    _, csc = hg_scattering_function(np.linspace(0.0, 0.5, 4), 256)
    phys = dict(kabs=torch.full((4,), 0.05, device=cuda),
                ksca=torch.full((4,), 0.05, device=cuda),
                tw=torch.ones(4, device=cuda),
                csc=torch.as_tensor(csc, device=cuda))
    params = dict(photons=torch.ones(4, device=cuda), per_freq=1 << 20,
                  hi_base=0)
    steps = propagate.transport_steps(
        grid, phys, params, 4 << 20, torch.zeros(grid.cells, device=cuda),
        torch.zeros((1, 1), device=cuda), 5, nlanes=1 << 12, max_iters=7,
        refill_period=8)
    bodies = sum(1 for _ in steps)
    assert bodies == 7 and replays == [False, False] + [True] * 5


def test_sca_devices_two_processes_on_one_card(cuda, tmp_path):
    """chip_smoke.py phase 20 at a small size: `sca` with `devices 4` as
    two processes on cuda:0 (two shards each: SOC_TPU_LOCAL_DEVICE_IDS
    0,0), against one process's devices=[cuda:0] x 4: both processes
    return the same maps (sha256), held to the one process's within
    chip_smoke's rerun bound (1e-4 relative or 1e-6 of the maximum: the
    peel-off's atomics add in another order on every run); process 1
    writes no file."""
    import json
    import socket
    import subprocess
    import sys
    from soc_tpu_torch.pipeline import scattering
    here = os.path.dirname(os.path.abspath(__file__))
    kw = dict(nfreq=8, simum=(0.05, 3.0), extra="devices 4\n")
    one = write_sca_model(str(tmp_path / "one"), 16, **kw)
    want = scattering.run(one, device=cuda, lanes=1 << 14,
                          devices=[cuda] * 4)
    dirs = [tmp_path / "r0", tmp_path / "r1"]
    for d in dirs:
        write_sca_model(str(d), 16, **kw)
    before = sorted(os.listdir(dirs[1]))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for k, d in enumerate(dirs):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0],
            PYTHONPATH=os.path.dirname(here),
            SOC_TPU_COORDINATOR="127.0.0.1:%d" % port,
            SOC_TPU_NUM_PROCESSES="2", SOC_TPU_PROCESS_ID=str(k),
            SOC_TPU_LOCAL_DEVICE_IDS="0,0", SOC_TPU_DIST_TIMEOUT="120")
        spec = dict(runs=[["sca", "run.ini", "--lanes", str(1 << 14)]])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "_torch_mp_worker.py"),
             json.dumps(spec)], cwd=str(d), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            assert p.returncode == 0 and line, stderr[-3000:]
            out.append(json.loads(line[0][7:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(r["foreign"] == [] and r["size"] == 2 for r in out)
    assert out[0]["runs"][0]["digests"] == out[1]["runs"][0]["digests"]
    raw = np.fromfile(str(dirs[0] / "outcoming.socs"), np.float32)
    got = raw[3 + 8:].reshape(want.shape)
    assert np.isfinite(got).all() and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    assert sorted(os.listdir(dirs[1])) == before


# --------------------------------------------- the fused march block

def _root_physics(dev, nfreq, seed=7):
    """A 16^3 root grid of uneven density and nfreq channels of cross
    sections, weights and HG phase functions."""
    from soc_tpu_torch.grid import grid_from_arrays
    from soc_tpu_torch.io.dust import hg_scattering_function
    rs = np.random.default_rng(seed)
    n = 16
    grid = grid_from_arrays(n, n, n, [n ** 3],
                            [rs.uniform(0.2, 2.0, n ** 3)], dev)
    _, csc = hg_scattering_function(np.linspace(0.1, 0.6, nfreq), 256)

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=dev)
    phys = dict(kabs=f32(rs.uniform(0.02, 0.3, nfreq)),
                ksca=f32(rs.uniform(0.05, 0.5, nfreq)),
                tw=f32(rs.uniform(0.5, 2.0, nfreq)), csc=f32(csc))
    return grid, phys


FUSED_CASES = {"plain": dict(per_freq=False), "tally": dict(per_freq=True),
               "ali": dict(per_freq=True, ali=True),
               "col0": dict(per_freq=True, col0=2, ncol=4)}


@pytest.mark.parametrize("name", list(FUSED_CASES))
def test_fused_block_matches_eager_block(cuda, monkeypatch, name):
    """One march block as the kernel (march_kernel.run_block) and as the
    eager block, from one root-grid pool of 2^16 lanes after one eager
    body (frozen, dead and live lanes; with ALI half the lanes sit in
    their emitting cell): ind, pending, scatterings and counter agree on
    99.9% of the lanes or more, the float state there to 1e-6 relative,
    tabs, intf, xab and absd to 1e-5 (the atomics add in another
    order). The lanes the block's service served (frozen at a scattering
    point in the snapshot) count one more step each, and their new
    directions, drawn from the kernel's Threefry words, agree to 1e-6 on
    99.9% of them or more (a wrong word would turn nearly all)."""
    from soc_tpu_torch.transport import propagate
    from soc_tpu_torch.transport.sources import GENERATORS
    case = FUSED_CASES[name]
    monkeypatch.setattr(propagate, "CUDA_GRAPHS", False)
    nfreq, lanes = 8, 1 << 16
    grid, phys = _root_physics(cuda, nfreq)
    ncol = case.get("ncol", nfreq)
    kit = propagate.StepKit(grid, phys, 11, case["per_freq"],
                            with_ali=case.get("ali", False), ncol=ncol,
                            col0=case.get("col0", 0))
    assert kit.fused

    def tallies():
        return (torch.zeros(grid.cells, device=cuda),
                torch.zeros((grid.cells, ncol), device=cuda),
                torch.zeros(grid.cells, device=cuda) if kit.with_ali
                else None)
    tabs, intf, xab = tallies()
    st = propagate.new_pool(lanes, grid, tabs, intf, xab)
    params = dict(photons=torch.ones(nfreq, device=cuda),
                  per_freq=lanes // nfreq, hi_base=0)
    run = propagate.PoolRun(kit, st, GENERATORS["bg"], params,
                            nfreq * (lanes // nfreq) * 4)
    kit.fused = False
    run.body()
    if kit.with_ali:
        half = torch.arange(lanes, device=cuda) % 2 == 0
        st.b.e_cell = torch.where(half, st.b.ind.clamp_min(0), -1)
    ind = st.b.ind
    assert bool((ind < 0).any()) and bool((st.pending & (ind >= 0)).any())
    assert bool(((ind >= 0) & ~st.pending).any())
    snap = {k: v.clone() for k, v in propagate._pool_tensors(st).items()}
    out = {}
    for fused in (True, False):
        kit.fused = fused
        work = propagate.PoolState(**{f: getattr(st, f) for f in (
            "b", "pending", "free_path", "tau", "esc_pending", "spare_cell")},
            tabs=None, intf=None, absd=None)
        propagate._set_pool_tensors(
            work, {k: v.clone() for k, v in snap.items()})
        t, i, x = tallies()
        work.tabs, work.intf, work.xab = t, i.view(-1), x
        run._marches(work, () if fused else kit.lane_const_of(work.b))
        out[fused] = work
    got, want = out[True], out[False]
    agree = torch.ones(lanes, dtype=torch.bool, device=cuda)
    for f in ("ind", "scatterings", "counter"):
        agree &= getattr(got.b, f) == getattr(want.b, f)
    agree &= got.pending == want.pending
    assert float(agree.float().mean()) >= 0.999
    served = snap["pending"] & (snap["b.ind"] >= 0)
    assert bool(served.any())
    for out_b in (got.b, want.b):
        assert torch.equal(out_b.counter[served], snap["b.counter"][served] + 1)
    turned = torch.isclose(got.b.dir[served], want.b.dir[served], rtol=1e-6,
                           atol=0).all(-1)
    assert float(turned.float().mean()) >= 0.999
    for a, b in ((got.b.pos, want.b.pos), (got.b.dir, want.b.dir),
                 (got.b.photons, want.b.photons),
                 (got.free_path, want.free_path), (got.tau, want.tau),
                 (got.esc_pending, want.esc_pending)):
        torch.testing.assert_close(a[agree], b[agree], rtol=1e-6, atol=0)
    assert float(want.tabs.sum()) > 0
    pairs = [(got.tabs, want.tabs), (got.absd, want.absd)]
    if kit.per_freq_tally:
        assert float(want.intf.sum()) > 0
        pairs.append((got.intf, want.intf))
    if kit.with_ali:
        assert float(want.xab.sum()) > 0
        pairs.append((got.xab, want.xab))
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-30)


def test_fused_transport_run_matches_eager(cuda, monkeypatch):
    """A whole transport_run (ALI, the per-frequency tally) with the
    march block as the kernel, inside the pool's captured GraphedBlock
    (the kernel run eagerly at the first body, recorded at the second and
    replayed from then on), against the eager pool: the tallies, the
    escaped weight per channel and absd within 2e-3; every body counts
    `transport.blocks_fused`, and the eager pool's every body
    `transport.blocks_eager`; march_kernel.launches counts one launch
    that ran a body (the capture's recording none), the eager pool's
    none."""
    from soc_tpu_torch.transport import march_kernel, propagate
    from soc_tpu_torch.utils import graphs, trace
    replays = []
    real = graphs.GraphedBlock.__call__

    def counted(self, *args):
        replays.append(self.graph is not None)
        return real(self, *args)
    monkeypatch.setattr(graphs.GraphedBlock, "__call__", counted)
    nfreq = 8
    grid, phys = _root_physics(cuda, nfreq)
    params = dict(photons=torch.ones(nfreq, device=cuda), per_freq=1 << 15,
                  hi_base=0)
    res = {}
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(propagate.StepKit, "fuses_on",
                                lambda self, device: False)
        before, replays[:] = march_kernel.launches, []
        trace.start()
        try:
            out = propagate.transport_run(
                grid, phys, params, nfreq << 15,
                torch.zeros(grid.cells, device=cuda),
                torch.zeros((grid.cells, nfreq), device=cuda), 21,
                nlanes=1 << 14, per_freq_tally=True, with_ali=True)
            torch.cuda.synchronize()
        finally:
            counters = trace.stop()["counters"]
        bodies = len(replays)
        assert bodies > 4 and replays[:2] == [False, False] \
            and all(replays[2:])
        key = "transport.blocks_%s" % ("fused" if fused else "eager")
        assert counters == {key: bodies}
        assert march_kernel.launches - before == (bodies if fused else 0)
        res[fused] = [o.double().cpu() for o in out]
    (tabs, intf, esc, absd, xab), (etabs, eintf, eesc, eabsd, exab) = \
        res[True], res[False]
    for a, b in ((tabs, etabs), (intf.sum(0), eintf.sum(0)), (esc, eesc),
                 (absd, eabsd), (xab, exab), (tabs.sum(), etabs.sum())):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-9 * float(b.abs().max()))


@pytest.mark.parametrize("kind", ["octree", "mirror"])
def test_fallback_pools_run_eager_on_card(cuda, kind):
    """Configurations the kernel does not cover run the eager block on
    the card: an octree and a mirrored root grid count only
    `transport.blocks_eager` and launch no march kernel."""
    from soc_tpu_torch.example_model import octree_cloud
    from soc_tpu_torch.grid import grid_from_arrays
    from soc_tpu_torch.transport import march_kernel, propagate
    from soc_tpu_torch.utils import trace
    nfreq = 4
    grid, phys = _root_physics(cuda, nfreq)
    mirror = 0
    if kind == "octree":
        lcells, values = octree_cloud(16, 4, 8)
        grid = grid_from_arrays(16, 16, 16, lcells, values, cuda)
    else:
        mirror = 1 | 8
    before = march_kernel.launches
    trace.start()
    try:
        out = propagate.transport_run(
            grid, phys, dict(photons=torch.ones(nfreq, device=cuda),
                             per_freq=1 << 12, hi_base=0),
            nfreq << 12, torch.zeros(grid.cells, device=cuda),
            torch.zeros((1, 1), device=cuda), 3, nlanes=1 << 12,
            mirror_mask=mirror)
        torch.cuda.synchronize()
    finally:
        counters = trace.stop()["counters"]
    assert set(counters) == {"transport.blocks_eager"}
    assert march_kernel.launches == before
    assert float(out[0].sum()) > 0
