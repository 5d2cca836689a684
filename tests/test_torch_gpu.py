"""soc_tpu_torch on a CUDA device: the A2E kernels (pre-folded and clamp)
against their plain twin, the wrapper's checks, the probes' four kernels
against their plain versions, and the slice on the card against the slice
on the CPU. Every test here carries the ``gpu`` marker and skips where
there is no CUDA device. This file imports no jax, so it runs on a
machine without it; tests/conftest.py does import jax, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: the kernel and the plain twin do the same float32 arithmetic
in another order (the kernel forms each substitution row from the
pre-folded weights, the twin folds the heating matrix after a cuBLAS
product, TF32 off), so they agree to 1e-4 relative over the cells whose
emission is above 1e-6 of the maximum, as chip_smoke.py demands. The clamp
kernel sums the same products in yet another order (see csrc/a2e.cu): the
same tolerance; its inputs are ones where the clamp changes the result by
more than ten times that. The probe kernels are held to their plain versions with
the limits of ``probes.common`` (gathers bit for bit).
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu_torch.example_model import (gset_solver, negate_one_weight,
                                         synthetic_absorbed,
                                         with_negative_entries, write_model)
from soc_tpu_torch.pipeline import full
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


@pytest.mark.parametrize("ne", [16, 48, 128, 256])
def test_kernel_matches_plain_twin(cuda, tmp_path, ne):
    """All sizes in one launch, with the align-weighted sum; 1000 cells is
    not a multiple of any tile, so the ragged last block is covered."""
    sol, freq = gset_solver(str(tmp_path), nfreq=44, nsize=4, ne=ne)
    assert stochastic.fused_weights_nonneg(sol)
    rng = np.random.default_rng(ne)
    stacks = stochastic.get_fused_stacks(sol, cuda, plain=True)
    ab = torch.as_tensor(synthetic_absorbed(rng, sol, freq, 1000),
                         device=cuda)
    align = torch.as_tensor(rng.uniform(0, 1, (sol.nsize, 1000))
                            .astype(np.float32), device=cuda)
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
        assert launched == (1 if dev.type == "cuda" else 0)
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
