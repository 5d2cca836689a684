"""soc_tpu_torch against soc_tpu: the A2E stochastic-heating solve.

The plain twin of the CUDA kernel is soc_tpu's exact XLA path written in
torch; on the CPU it must match ``stochastic.solve_batch`` at rtol 2e-5
(the tolerance soc_tpu's own fused-vs-XLA test uses: the same float32
math, summed in another order), with and without negative absorbed values
(the per-entry clamp). For non-negative inputs it must also match the
Pallas kernel in interpret mode, exactly as soc_tpu's tests run it. The
kernel itself runs only on a CUDA device (tests/test_torch_gpu.py).
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.solve import stochastic as jsto
from soc_tpu.solve.pallas_a2e import solve_batch_fused

from soc_tpu_torch import convert
from soc_tpu_torch.example_model import negate_one_weight
from soc_tpu_torch.solve import a2e_kernel
from soc_tpu_torch.solve import stochastic as tsto

sys.path.insert(0, "tests")
from test_a2e import random_solver  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _absorbed(nfreq, cells, seed, negative):
    rng = np.random.default_rng(seed)
    a = (rng.random((cells, nfreq)) * 1e4).astype(np.float32)
    if negative:
        a[rng.random(a.shape) < 0.2] *= -0.3
    return a


@pytest.mark.parametrize("ne", [16, 48, 128])
@pytest.mark.parametrize("negative", [False, True])
def test_solve_batch_matches_xla(ne, negative):
    solver = random_solver(ne=ne, nfreq=12, nsize=1, seed=ne)
    absorbed = _absorbed(12, 96, ne + 1, negative)
    w_flat, tdown, ea = jsto.prepare_size_arrays(solver, 0)
    ref = np.asarray(jsto.solve_batch(w_flat, tdown, ea,
                                      jnp.asarray(absorbed), ne))
    tw, ttd, tea = tsto.prepare_size_arrays(solver, 0)
    np.testing.assert_array_equal(tw, np.asarray(w_flat))
    got = tsto.solve_batch(torch.as_tensor(tw), torch.as_tensor(ttd),
                           torch.as_tensor(tea), torch.as_tensor(absorbed),
                           ne).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-25)


def test_plain_twin_matches_pallas_interpret():
    """Non-negative inputs: the plain twin equals the fused Pallas kernel
    (interpret mode) that the CUDA kernel replaces."""
    solver = random_solver(ne=128, nfreq=12, nsize=1, seed=11)
    absorbed = _absorbed(12, 256, 4, False)
    w_t, tdown, ea_n = jsto.prepare_size_arrays_fused(solver, 0)
    fused = np.asarray(solve_batch_fused(w_t, tdown, jnp.asarray(ea_n),
                                         jnp.asarray(absorbed), 128,
                                         tile=128, interpret=True))
    tw, ttd, tea = tsto.prepare_size_arrays(solver, 0)
    got = tsto.solve_batch(torch.as_tensor(tw), torch.as_tensor(ttd),
                           torch.as_tensor(tea), torch.as_tensor(absorbed),
                           128).numpy()
    np.testing.assert_allclose(got, fused, rtol=2e-5, atol=1e-25)
    # the kernel's folded weights are soc_tpu's, bit for bit
    tw_fold, _, _ = tsto.prepare_size_arrays_fused(solver, 0)
    np.testing.assert_array_equal(tw_fold, np.asarray(w_t))


def test_wrapper_cpu_runs_plain_twin_over_sizes():
    """solve_all_sizes on CPU tensors = the per-size plain twin, summed in
    size order, with the align-weighted sum; no kernel launch."""
    solver = random_solver(ne=16, nfreq=8, nsize=3, seed=5)
    absorbed = torch.as_tensor(_absorbed(8, 50, 6, False))
    align = torch.as_tensor(
        np.random.default_rng(7).random((3, 50)).astype(np.float32))
    stacks = tsto.get_fused_stacks(solver, CPU)
    n0 = a2e_kernel.launches
    tot, ptot = a2e_kernel.solve_all_sizes(stacks, absorbed, align)
    assert a2e_kernel.launches == n0
    ref = torch.zeros_like(absorbed)
    pref = torch.zeros_like(absorbed)
    for s in range(3):
        w, td, ea = tsto.prepare_size_arrays(solver, s)
        em = tsto.solve_batch(torch.as_tensor(w), torch.as_tensor(td),
                              torch.as_tensor(ea), absorbed, 16)
        ref += em
        pref += em * align[s][:, None]
    np.testing.assert_array_equal(tot.numpy(), ref.numpy())
    np.testing.assert_array_equal(ptot.numpy(), pref.numpy())


def test_convert_carries_soc_tpu_stacks():
    """soc_tpu's per-size arrays, carried across by convert.py, are the
    stacks the port builds itself."""
    solver = random_solver(ne=16, nfreq=8, nsize=3, seed=5)
    flat = [[np.asarray(a) for a in jsto.prepare_size_arrays(solver, i)]
            for i in range(3)]
    fused = [np.asarray(jsto.prepare_size_arrays_fused(solver, i)[0])
             for i in range(3)]
    got = convert.stacks_from_numpy(
        np.stack([f[0] for f in flat]), np.stack(fused),
        np.stack([f[1] for f in flat]), np.stack([f[2] for f in flat]), CPU)
    port = tsto.get_fused_stacks(solver, CPU)
    assert got.ne == port.ne == 16
    for name in ("w_flat", "w_fold", "tdown", "ea"):
        assert torch.equal(getattr(got, name), getattr(port, name)), name


def test_kernel_only_stacks_carry_no_dense_weights():
    """Stacks built for the kernel alone (the default off the CPU) leave out
    w_flat; the plain twin then refuses them rather than guess."""
    solver = random_solver(ne=16, nfreq=8, nsize=2, seed=5)
    assert tsto.get_fused_stacks(solver, CPU).w_flat is not None
    stacks = tsto.get_fused_stacks(solver, CPU, plain=False)
    assert stacks.w_flat is None
    assert torch.equal(stacks.w_fold,
                       tsto.get_fused_stacks(solver, CPU).w_fold)
    with pytest.raises(ValueError, match="w_flat"):
        a2e_kernel.solve_all_sizes(stacks, torch.zeros((4, 8)))


def test_wrapper_rejects_other_devices():
    solver = random_solver(ne=16, nfreq=8, nsize=1, seed=5)
    stacks = tsto.get_fused_stacks(solver, CPU)
    with pytest.raises(ValueError):
        a2e_kernel.solve_all_sizes(stacks, torch.zeros((4, 8),
                                                       device="meta"))


def test_unfolded_stacks_are_soc_tpu_weights_transposed():
    """The clamp kernel's w_unf [S, NFREQ, NE*NE] (column-major,
    w_unf[s, f, l*NE + u] = W[u, l, f]) is soc_tpu's prepare_size_arrays
    w_flat [NE*NE, NFREQ], transposed; clamp stacks carry no w_fold."""
    ne, nfreq = 16, 8
    solver = random_solver(ne=ne, nfreq=nfreq, nsize=3, seed=5)
    stacks = tsto.get_fused_stacks(solver, CPU, clamp=True)
    assert stacks.w_fold is None
    assert tuple(stacks.w_unf.shape) == (3, nfreq, ne * ne)
    for s in range(3):
        w = np.asarray(jsto.prepare_size_arrays(solver, s)[0])
        ref = w.reshape(ne, ne, nfreq).transpose(2, 1, 0).reshape(nfreq, -1)
        np.testing.assert_array_equal(stacks.w_unf[s].numpy(), ref)
    assert tsto.get_fused_stacks(solver, CPU).w_unf is None


def test_weight_sign_flag_sees_one_negative_weight():
    solver = random_solver(ne=16, nfreq=8, nsize=3, seed=5)
    assert tsto.fused_weights_nonneg(solver)
    neg = negate_one_weight(random_solver(ne=16, nfreq=8, nsize=3, seed=5))
    assert not tsto.fused_weights_nonneg(neg)
    assert not jsto.fused_weights_nonneg(neg)
    # only size 0 holds the flip
    assert all(np.asarray(jsto.prepare_size_arrays(neg, s)[0]).min() >= 0
               for s in (1, 2))


@pytest.mark.parametrize("neg_weight,neg_absorbed", [(True, False),
                                                     (False, True),
                                                     (True, True)])
def test_solve_emission_clamp_route_matches_soc_tpu(monkeypatch, neg_weight,
                                                     neg_absorbed):
    """Negative weights or absorbed values take the clamp route; on the
    CPU that is the plain twin, held to soc_tpu's exact path."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    solver = random_solver(ne=16, nfreq=8, nsize=3, seed=9)
    if neg_weight:
        negate_one_weight(solver)
    absorbed = _absorbed(8, 300, 10, neg_absorbed) * 1e-3
    ref = jsto.solve_emission(solver, absorbed, batch=128)
    n0 = (a2e_kernel.launches, a2e_kernel.clamp_launches)
    got = tsto.solve_emission(solver, absorbed, CPU)
    assert (a2e_kernel.launches, a2e_kernel.clamp_launches) == n0
    assert ("stacks", 3, "cpu", True, True) in getattr(solver, tsto._CACHE)
    np.testing.assert_allclose(got, ref, rtol=2e-5,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("nstoch,aalg", [(999, False), (2, False),
                                         (999, True)])
def test_solve_emission_matches_soc_tpu(monkeypatch, nstoch, aalg):
    """Full solve over sizes (stochastic + equilibrium above nstoch, the
    last-channel clip, the polarised sum) against soc_tpu's exact path."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    solver = random_solver(ne=16, nfreq=8, nsize=3, seed=9)
    solver.size_a[:] = [1e-7, 1e-6, 1e-5]
    absorbed = _absorbed(8, 300, 10, False) * 1e-3
    kw = {}
    if aalg:
        kw["aalg"] = np.full(300, 3e-6, np.float32)
    ref = jsto.solve_emission(solver, absorbed, nstoch=nstoch, batch=128,
                              **kw)
    got = tsto.solve_emission(solver, absorbed, CPU, nstoch=nstoch, **kw)
    for g, r in zip(got if aalg else (got,), ref if aalg else (ref,)):
        np.testing.assert_allclose(g, r, rtol=2e-5,
                                   atol=1e-6 * np.abs(r).max())
