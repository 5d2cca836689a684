"""Stochastically heated grain emission: the A2E solve (port of
soc_tpu.solve.stochastic).

Per cell and grain size, a lower-triangular heating-rate matrix is built
from the dense integration weights, folded, and solved by forward
substitution for the steady-state energy-bin populations
(kernel_A2E.c:2-104). The per-size host preparation is NumPy and shared
with soc_tpu's file formats; the solve over all stochastic sizes is the
hand CUDA kernel on the card (``a2e_kernel``) and its plain twin on the
CPU. Sizes at or above ``nstoch`` are solved at equilibrium on the host.

On the card the solve routes as soc_tpu does (stochastic.py:262-272 there):
the pre-folded kernel when every weight and absorbed value is >= 0, the
clamp kernel (the exact path) otherwise.
"""

import numpy as np
import torch

from soc_tpu.solve.solver_file import densify_weights

from . import a2e_kernel
from .a2e_kernel import solve_batch  # noqa: F401  (the plain twin)

_CACHE = "_torch_prep_cache"


def _cache(solver):
    cache = getattr(solver, _CACHE, None)
    if cache is None:
        cache = {}
        setattr(solver, _CACHE, cache)
    return cache


def prepare_size_arrays(solver, isize):
    """Host-side per-size arrays: (w_flat [NE*NE, NFREQ] with the size's
    absorption fraction AF folded in, tdown [NE], ea [NFREQ, NE] with the
    Ibeg masking applied). Cached on the solver object."""
    cache = _cache(solver)
    if isize in cache:
        return cache[isize]
    sd = solver.sizes[isize]
    ne, nfreq = solver.ne, solver.nfreq
    w = densify_weights(sd, ne, nfreq)              # [NE, NE, NFREQ]
    with np.errstate(divide="ignore", invalid="ignore"):
        af = (np.asarray(solver.sk_abs[isize], np.float64)
              / np.asarray(solver.k_abs, np.float64))
        af = af / (solver.s_frac[isize] * solver.grain_density)
    af = np.clip(np.nan_to_num(af, nan=1e-32), 1e-32, 1e100).astype(np.float32)
    w = w * af[None, None, :]
    ea = np.asarray(sd.ea, np.float32).copy()       # [NFREQ, NE]
    for f in range(nfreq):
        ea[f, : sd.ibeg[f]] = 0.0
    out = (w.reshape(ne * ne, nfreq), np.asarray(sd.tdown, np.float32), ea)
    cache[isize] = out
    return out


def prepare_size_arrays_fused(solver, isize):
    """Per-size arrays for the kernel: the fold S[j] = sum_{u>=j} A[u] is
    linear in the weights, so it is applied to them once here in float64.
    Returns (w_fold [NFREQ, NE*NE], tdown [NE], ea [NFREQ, NE])."""
    cache = _cache(solver)
    key = ("fused", isize)
    if key in cache:
        return cache[key]
    w_flat, tdown, ea = prepare_size_arrays(solver, isize)
    ne = solver.ne
    w = np.asarray(w_flat, np.float64).reshape(ne, ne, -1)
    # the exact path clamps each heating entry max(dot, 0) before folding;
    # pre-folding makes that clamp unreachable, so the kernel is exact
    # only when all weights and all absorbed values are >= 0. Record the
    # weight half here; solve_emission checks the absorbed half.
    cache[("fused_nonneg", isize)] = bool(w.min() >= 0.0)
    wf = np.cumsum(w[::-1], axis=0)[::-1]
    w_fold = np.ascontiguousarray(wf.reshape(ne * ne, -1).T.astype(np.float32))
    out = (w_fold, tdown, ea)
    cache[key] = out
    return out


def prepare_size_arrays_unfolded(solver, isize):
    """Per-size weights for the clamp kernel: the dense weights of
    prepare_size_arrays, unfolded, column-major and frequency-first,
    w_unf [NFREQ, NE*NE] with w_unf[f, l*NE + u] = W[u, l, f]."""
    cache = _cache(solver)
    key = ("unfolded", isize)
    if key not in cache:
        w_flat = prepare_size_arrays(solver, isize)[0]
        ne = solver.ne
        cache[key] = np.ascontiguousarray(
            w_flat.reshape(ne, ne, -1).transpose(2, 1, 0)
            .reshape(-1, ne * ne))
    return cache[key]


def solve_equilibrium_size(solver, isize, absorbed, nip=5000):
    """Large grains above the stochastic cutoff: equilibrium treatment
    (kernel_A2E.c:110-154). absorbed [cells, NFREQ] host array; returns
    EMIT [cells, NFREQ] scaled by S_FRAC*GRAIN_DENSITY."""
    from soc_tpu.constants import EMIT_COEFF, FACTOR, H_K, PLANCK, \
        planck_intensity
    if solver.s_frac[isize] <= 0.0:
        return np.zeros_like(np.asarray(absorbed, np.float32))
    freq = np.asarray(solver.freq, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        kabs = (np.asarray(solver.sk_abs[isize], np.float64)
                / (solver.grain_density * solver.s_frac[isize]))
        af = (np.asarray(solver.sk_abs[isize], np.float64)
              / np.asarray(solver.k_abs, np.float64))
        af = np.nan_to_num(af / (solver.s_frac[isize]
                                 * solver.grain_density), nan=1e-32)
    af = np.clip(af, 1e-32, 1e100)
    tgrid = np.logspace(np.log10(1.0), np.log10(2500.0), nip)
    bnu = planck_intensity(freq[None, :], tgrid[:, None])
    eout = FACTOR * 4.0 * np.pi * np.trapezoid(kabs[None, :] * bnu,
                                               freq, axis=1)
    absf = np.asarray(absorbed, np.float64) * af[None, :]
    ein = np.trapezoid(absf * (PLANCK * freq)[None, :], freq, axis=1)
    t = np.interp(ein, eout, tgrid)
    coeff = EMIT_COEFF * FACTOR * solver.grain_density * \
        solver.s_frac[isize]
    x = np.clip(H_K * freq[None, :] / np.maximum(t[:, None], 1e-3), 1e-10, 500)
    emit = coeff * kabs[None, :] * freq[None, :] ** 2 / np.expm1(x)
    return emit.astype(np.float32)


def alignment_weights(solver, isize, aalg):
    """Per-cell fraction of this size's emission that is polarised: grains
    with a >= a_alg are aligned, log-size interpolation in between."""
    a = solver.size_a
    w = np.zeros(len(aalg), np.float32)
    w[a[isize] >= aalg] = 1.0
    if isize < solver.nsize - 1:
        m = (a[isize] < aalg) & (a[isize + 1] > aalg)
        w[m] = ((np.log10(aalg[m]) - np.log10(a[isize]))
                / (np.log10(a[isize + 1]) - np.log10(a[isize])))
    return w


def get_fused_stacks(solver, device, nstoch=999, plain=None, clamp=False):
    """Device-resident A2EStacks of the first min(nstoch, NSIZE) sizes,
    built and cached on the solver per device. They carry the pre-folded
    w_fold, or with ``clamp`` the unfolded w_unf of the clamp kernel
    instead. The dense w_flat, which only the plain twin reads, is carried
    when ``plain`` is true; by default only for the CPU, where the twin is
    the solve."""
    device = torch.device(device)
    if plain is None:
        plain = device.type == "cpu"
    n_stoch = min(nstoch, solver.nsize)
    cache = _cache(solver)
    key = ("stacks", n_stoch, str(device), plain, clamp)
    if key not in cache:
        sizes = range(n_stoch)
        flat = [prepare_size_arrays(solver, i) for i in sizes]
        if clamp:
            w_fold = None
            w_unf = np.stack([prepare_size_arrays_unfolded(solver, i)
                              for i in sizes])
        else:
            w_fold = np.stack([prepare_size_arrays_fused(solver, i)[0]
                               for i in sizes])
            w_unf = None
        cache[key] = a2e_kernel.stacks_from_numpy(
            np.stack([p[0] for p in flat]) if plain else None, w_fold,
            np.stack([p[1] for p in flat]), np.stack([p[2] for p in flat]),
            device, w_unf=w_unf)
    return cache[key]


def fused_weights_nonneg(solver, nstoch=999):
    """True when every stochastic size's heating weights are >= 0 (then
    the pre-folded kernel equals the clamp-then-fold exact solve for
    non-negative absorbed values)."""
    n_stoch = min(nstoch, solver.nsize)
    cache = _cache(solver)
    for i in range(n_stoch):
        if ("fused_nonneg", i) not in cache:
            prepare_size_arrays_fused(solver, i)
    return all(cache[("fused_nonneg", i)] for i in range(n_stoch))


def solve_emission(solver, absorbed, device, nstoch=999, clip_last=True,
                   aalg=None):
    """Full A2E solve: emission summed over all grain sizes.

    absorbed : [CELLS, NFREQ] host array (the absorbed.data payload)
    nstoch   : sizes >= nstoch are treated at equilibrium
    aalg     : optional [CELLS] minimum aligned grain size; then the
               polarised emission PEMITTED is returned too
    On a CUDA device the stochastic sizes go through a hand kernel: the
    pre-folded one when all weights and absorbed values are >= 0, else the
    clamp kernel (negative entries come from the WITH_REFERENCE delta
    fields of a later slice).
    Returns EMITTED [CELLS, NFREQ] float32 (, PEMITTED if aalg given).
    """
    device = torch.device(device)
    cells, nfreq = absorbed.shape
    absorbed = np.asarray(absorbed, np.float32).copy()
    if clip_last and nfreq >= 2:
        # guard against spurious weight on the topmost channel (A2E.py:184)
        absorbed[:, -1] = np.clip(absorbed[:, -1], 0.0,
                                  0.2 * absorbed[:, -2])
    emitted = np.zeros((cells, nfreq), np.float32)
    pemitted = np.zeros((cells, nfreq), np.float32) if aalg is not None \
        else None
    n_stoch = min(nstoch, solver.nsize)
    if n_stoch > 0:
        clamp = not (fused_weights_nonneg(solver, n_stoch)
                     and absorbed.min() >= 0.0)
        stacks = get_fused_stacks(solver, device, n_stoch, clamp=clamp)
        solve = a2e_kernel.solve_all_sizes_clamp if clamp \
            else a2e_kernel.solve_all_sizes
        align = None
        if aalg is not None:
            align = torch.as_tensor(np.stack(
                [alignment_weights(solver, i, np.asarray(aalg))
                 for i in range(n_stoch)]), device=device)
        tot, ptot = solve(stacks, torch.as_tensor(absorbed, device=device),
                          align)
        emitted += tot.cpu().numpy()
        if pemitted is not None:
            pemitted += ptot.cpu().numpy()
    for isize in range(n_stoch, solver.nsize):
        emit_size = solve_equilibrium_size(solver, isize, absorbed)
        emitted += emit_size
        if pemitted is not None:
            w = alignment_weights(solver, isize, np.asarray(aalg))
            pemitted += emit_size * w[:, None]
    if pemitted is not None:
        return emitted, pemitted
    return emitted
