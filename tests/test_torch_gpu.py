"""soc_tpu_torch on a CUDA device: the A2E kernel against its plain twin,
the wrapper's checks, and the slice on the card against the slice on the
CPU. Every test here carries the ``gpu`` marker and skips where there is no
CUDA device. This file imports no jax, so it runs on a machine without it;
tests/conftest.py does import jax, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: the kernel and the plain twin do the same float32 arithmetic
in another order (the kernel forms each substitution row from the
pre-folded weights, the twin folds the heating matrix after a cuBLAS
product, TF32 off), so they agree to 1e-4 relative over the cells whose
emission is above 1e-6 of the maximum, as chip_smoke.py demands.
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu_torch.example_model import (gset_solver, synthetic_absorbed,
                                         write_model)
from soc_tpu_torch.pipeline import full
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


def test_solve_emission_raises_for_negative_absorbed(cuda, tmp_path):
    """The pre-folded kernel cannot apply the exact path's per-entry clamp:
    on the card negative inputs raise instead of running the plain twin."""
    sol, freq = gset_solver(str(tmp_path), nfreq=12, nsize=2, ne=16)
    ab = synthetic_absorbed(np.random.default_rng(2), sol, freq, 32)
    ab[3, 4] = -1.0
    n0 = a2e_kernel.launches
    with pytest.raises(NotImplementedError, match="clamp"):
        stochastic.solve_emission(sol, ab, cuda)
    assert a2e_kernel.launches == n0


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
