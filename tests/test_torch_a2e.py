"""soc_tpu_torch against soc_tpu: the A2E stochastic-heating solve.

The plain twin of the CUDA kernel is soc_tpu's exact XLA path written in
torch; on the CPU it must match ``stochastic.solve_batch`` at rtol 2e-5
(the tolerance soc_tpu's own fused-vs-XLA test uses: the same float32
math, summed in another order), with and without negative absorbed values
(the per-entry clamp). For non-negative inputs it must also match the
Pallas kernel in interpret mode, exactly as soc_tpu's tests run it. The
kernel itself runs only on a CUDA device (tests/test_torch_gpu.py),
where it is held to the plain twin; these tests close the chain from the
twin to soc_tpu at the same edges of the kernel's tiling.
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
from test_torch_gpu import rescale_count  # noqa: E402

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


# (NE, NFREQ, absorbed scale, whether the 1e-20 rescale fires): NE 2 with
# one column, odd NE, NFREQ not a multiple of 4, NE 128 where soc_tpu runs
# its Pallas kernel, and NE 4 heated 1e6 times harder, where the rescale
# fires though it does not at the plain scale (random_solver's steep
# weights make it fire at NE >= 17 already)
TWIN_CASES = [(2, 5, 1.0, False), (17, 45, 1.0, True), (33, 44, 1.0, True),
              (128, 12, 1.0, True), (4, 5, 1.0, False), (4, 5, 1e6, True)]


@pytest.mark.parametrize("ne,nfreq,scale,fires", TWIN_CASES)
def test_plain_twin_matches_pallas_interpret(ne, nfreq, scale, fires):
    """Non-negative inputs: the plain twin equals what soc_tpu runs for
    this shape: the fused Pallas kernel (interpret mode) that the CUDA
    kernel replaces where NE is a multiple of 128, the XLA solve_batch
    elsewhere (soc_tpu's stochastic.py:262 takes the kernel only there)."""
    solver = random_solver(ne=ne, nfreq=nfreq, nsize=1, seed=11)
    absorbed = (_absorbed(nfreq, 256, 4, False) * scale).astype(np.float32)
    w_t, tdown, ea_n = jsto.prepare_size_arrays_fused(solver, 0)
    if ne % 128 == 0:
        ref = solve_batch_fused(w_t, tdown, jnp.asarray(ea_n),
                                jnp.asarray(absorbed), ne, tile=128,
                                interpret=True)
    else:
        ref = jsto.solve_batch(*jsto.prepare_size_arrays(solver, 0),
                               jnp.asarray(absorbed), ne)
    tw, ttd, tea = tsto.prepare_size_arrays(solver, 0)
    tw, ttd, tab = (torch.as_tensor(a) for a in (tw, ttd, absorbed))
    assert (rescale_count(tw, ttd, tab, ne) > 0) == fires
    got = tsto.solve_batch(tw, ttd, torch.as_tensor(tea), tab, ne).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=1e-25)
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


@pytest.mark.parametrize("nfreq", [8, 5])
def test_folded_stacks_are_soc_tpu_weights_by_row(nfreq):
    """a2e_all_sizes' w_fold [S, NE, NE, NFP] is soc_tpu's folded
    prepare_size_arrays_fused [NFREQ, NE*NE] of each size, with row j's
    column l holding the frequencies, zero-padded to a multiple of 4."""
    ne = 16
    solver = random_solver(ne=ne, nfreq=nfreq, nsize=3, seed=5)
    w = tsto.get_fused_stacks(solver, CPU).w_fold.numpy()
    nfp = a2e_kernel.padded_nfreq(nfreq)
    assert nfp % 4 == 0 and nfp - nfreq < 4
    assert w.shape == (3, ne, ne, nfp)
    assert not w[..., nfreq:].any()
    for s in range(3):
        ref = np.asarray(jsto.prepare_size_arrays_fused(solver, s)[0])
        np.testing.assert_array_equal(
            w[s, :, :, :nfreq], ref.reshape(nfreq, ne, ne).transpose(1, 2, 0))


class _FakeLib:
    """a2e.cu's sizing entry points for a card with ``cap`` bytes of
    shared memory a block and ``sm`` an SM (1 KB kept per block), and
    ``regs`` registers a thread."""

    def __init__(self, cap=232448, sm=233472, regs=168):
        self.cap, self.sm, self.regs, self.queries = cap, sm, regs, 0

    def a2e_max_smem(self, device):
        return self.cap

    def a2e_fold_smem_bytes(self, nf, ne, tile, lc):
        nfp4 = -(-nf // 4)
        multi = nfp4 > 12
        return 16 * 2 * (lc + 1) * nfp4 + 4 * (ne * tile
                                               + (4 * nfp4 * tile if multi
                                                  else 0))

    def a2e_fold_blocks_per_sm(self, nf, ne, tile, lc):
        self.queries += 1
        smem = self.a2e_fold_smem_bytes(nf, ne, tile, lc) + 1024
        return min(self.sm // smem, 65536 // (self.regs * tile))

    def a2e_clamp_smem_bytes(self, nf, ne, tile, lr):
        nfp4 = -(-nf // 4)
        multi = nfp4 > 12
        return 16 * 2 * lr * nfp4 + 4 * (ne * tile
                                         + (4 * nfp4 * tile if multi else 0))

    def a2e_clamp_blocks_per_sm(self, nf, ne, tile, lr):
        self.queries += 1
        smem = self.a2e_clamp_smem_bytes(nf, ne, tile, lr) + 1024
        return min(self.sm // smem, 65536 // (self.regs * tile))


@pytest.mark.parametrize("nfreq,ne,want", [
    (44, 128, (128, 126, 8)),     # the pipeline: whole rows, 2 blocks
    (44, 16, (128, 14, 12)),      # registers, not shared memory, bound it
    (44, 256, (64, 16, 6)),       # 8 warps nowhere: the most warps
    (100, 129, (64, 16, 6)),      # ABS in shared memory too
    (5, 2, (128, 1, 12)),         # one column a row at most
])
def test_fold_config_choice(monkeypatch, nfreq, ne, want):
    """pick_fold_config: the largest tile, then the most columns, that
    keeps 8 warps on an SM, else the most warps; cached per device and
    shape."""
    monkeypatch.setattr(a2e_kernel, "_CONFIG", {})
    monkeypatch.setattr(a2e_kernel, "_SMEM_CAP", {})
    lib = _FakeLib()
    assert a2e_kernel.pick_fold_config(lib, nfreq, ne, 0) == want
    n = lib.queries
    assert a2e_kernel.pick_fold_config(lib, nfreq, ne, 0) == want
    assert lib.queries == n


@pytest.mark.parametrize("nfreq,ne,want", [
    (44, 128, (128, 32, 12)),     # the pipeline: runs of 32, 3 blocks
    (44, 16, (128, 15, 12)),      # registers, not shared memory, bound it
    (44, 256, (64, 32, 6)),       # 12 warps nowhere: the most warps
    (100, 129, (64, 16, 6)),      # ABS in shared memory too
    (5, 2, (128, 1, 12)),         # one row a column at most
])
def test_clamp_config_choice(monkeypatch, nfreq, ne, want):
    """pick_clamp_config: the largest tile, then the most rows, that
    keeps 12 warps on an SM, else the most warps; cached per device and
    shape, apart from pick_fold_config's choice for the same shape."""
    monkeypatch.setattr(a2e_kernel, "_CONFIG", {})
    monkeypatch.setattr(a2e_kernel, "_SMEM_CAP", {})
    lib = _FakeLib()
    assert a2e_kernel.pick_clamp_config(lib, nfreq, ne, 0) == want
    n = lib.queries
    assert a2e_kernel.pick_clamp_config(lib, nfreq, ne, 0) == want
    assert lib.queries == n
    a2e_kernel.pick_fold_config(lib, nfreq, ne, 0)
    assert lib.queries > n


# the A2E kernels' shape ceiling on an H100 (232,448 bytes of shared
# memory a block) by a2e.cu's sizing formulas: (kernel, NFREQ, NE) with
# the one given and the largest other that the picker admits
H100_CEILING = [
    ("fold", 44, 1791), ("fold", 256, 1416), ("fold", 1000, 253),
    ("fold", None, (256, 996)), ("fold", None, (32, 1140)),
    ("clamp", 44, 1794), ("clamp", 256, 1432), ("clamp", 1000, 316),
    ("clamp", None, (256, 1040)), ("clamp", None, (32, 1188)),
]


@pytest.mark.parametrize("kernel,nfreq,want", H100_CEILING)
def test_kernel_shape_ceiling_on_h100(monkeypatch, kernel, nfreq, want):
    """shape_ceiling finds, through the picker, the largest NE at a given
    NFREQ (or the largest NFREQ at a given NE) that a kernel takes in an
    H100's shared memory; one step beyond raises the ValueError that
    names the kernel, the shape and the cap. No configuration of the repo
    comes near it (NE 128-256 at NFREQ 44-100)."""
    monkeypatch.setattr(a2e_kernel, "_CONFIG", {})
    monkeypatch.setattr(a2e_kernel, "_SMEM_CAP", {})
    lib = _FakeLib(cap=232448)
    pick = a2e_kernel.pick_fold_config if kernel == "fold" \
        else a2e_kernel.pick_clamp_config
    name = "a2e_all_sizes" if kernel == "fold" else "a2e_clamp"
    if nfreq is None:
        ne, top = want
        assert a2e_kernel.shape_ceiling(lib, kernel, 0, ne=ne) == top
        shape, beyond = (top, ne), (top + 1, ne)
    else:
        assert a2e_kernel.shape_ceiling(lib, kernel, 0, nfreq=nfreq) == want
        shape, beyond = (nfreq, want), (nfreq, want + 1)
    assert pick(lib, *shape, 0)[2] > 0
    with pytest.raises(ValueError, match=r"%s: NE=%d with NFREQ=%d .*232448"
                       % (name, beyond[1], beyond[0])):
        pick(lib, *beyond, 0)


def test_kernel_shape_limits_name_the_shape(monkeypatch):
    """A shape a kernel cannot take raises, naming the kernel, NE, NFREQ
    and the cap; both take NE 64 in 16 KB."""
    monkeypatch.setattr(a2e_kernel, "_CONFIG", {})
    monkeypatch.setattr(a2e_kernel, "_SMEM_CAP", {})
    lib = _FakeLib(cap=16384, sm=20000)
    with pytest.raises(ValueError, match=r"a2e_all_sizes: NE=1024 with "
                       r"NFREQ=44 .*16384"):
        a2e_kernel.pick_fold_config(lib, 44, 1024, 0)
    with pytest.raises(ValueError, match=r"a2e_clamp: NE=256 with NFREQ=44 "
                       r".*16384"):
        a2e_kernel.pick_clamp_config(lib, 44, 256, 0)
    assert a2e_kernel.pick_fold_config(lib, 44, 64, 0)[2] > 0
    assert a2e_kernel.pick_clamp_config(lib, 44, 64, 0)[2] > 0


@pytest.mark.parametrize("nfreq", [8, 5])
def test_unfolded_stacks_are_soc_tpu_weights_transposed(nfreq):
    """The clamp kernel's w_unf [S, NE, NE, NFP] is soc_tpu's
    prepare_size_arrays w_flat [NE*NE, NFREQ] of each size, column by
    column: w_unf[s, l, u, :NFREQ] = W[u, l, :], the frequencies
    zero-padded to a multiple of 4; clamp stacks carry no w_fold."""
    ne = 16
    solver = random_solver(ne=ne, nfreq=nfreq, nsize=3, seed=5)
    stacks = tsto.get_fused_stacks(solver, CPU, clamp=True)
    assert stacks.w_fold is None
    nfp = a2e_kernel.padded_nfreq(nfreq)
    w = stacks.w_unf.numpy()
    assert w.shape == (3, ne, ne, nfp)
    assert not w[..., nfreq:].any()
    for s in range(3):
        ref = np.asarray(jsto.prepare_size_arrays(solver, s)[0])
        np.testing.assert_array_equal(
            w[s, :, :, :nfreq], ref.reshape(ne, ne, nfreq).transpose(1, 0, 2))
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
