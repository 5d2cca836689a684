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
clamp kernel (the exact path) otherwise; and it splits the cells over every
visible card, or over a given device list, as soc_tpu splits them over its
local devices (stochastic.py:300-353 there).

The solve's spans (utils/trace.py): `a2e.stacks` (the per-size arrays
prepared, stacked and put on a device, on a cache miss only),
`a2e.upload` (the absorbed array's copy to the device), `a2e.kernel`
(the launch up to the host copy of its result) and `a2e.host` (the NumPy
work around them).
"""

import os

import numpy as np
import torch

from ..utils import trace
from .solver_file import densify_weights

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


def solve_equilibrium_size(solver, isize, absorbed, nip=5000):
    """Large grains above the stochastic cutoff: equilibrium treatment
    (kernel_A2E.c:110-154). absorbed [cells, NFREQ] host array; returns
    EMIT [cells, NFREQ] scaled by S_FRAC*GRAIN_DENSITY."""
    from ..constants import EMIT_COEFF, FACTOR, H_K, PLANCK, \
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
    instead (a2e_kernel.unfold_cols of the dense weights). The dense
    w_flat, which only the plain twin reads, is carried when ``plain`` is
    true; by default only for the CPU, where the twin is the solve."""
    device = torch.device(device)
    if plain is None:
        plain = device.type == "cpu"
    n_stoch = min(nstoch, solver.nsize)
    cache = _cache(solver)
    key = ("stacks", n_stoch, str(device), plain, clamp)
    if key not in cache:
        with trace.span("a2e.stacks"):
            sizes = range(n_stoch)
            flat = [prepare_size_arrays(solver, i) for i in sizes]
            w_flat = np.stack([p[0] for p in flat]) if plain or clamp \
                else None
            w_fold = None if clamp else np.stack(
                [prepare_size_arrays_fused(solver, i)[0] for i in sizes])
            cache[key] = a2e_kernel.stacks_from_numpy(
                w_flat if plain else None, w_fold,
                np.stack([p[1] for p in flat]),
                np.stack([p[2] for p in flat]),
                device, w_unf=w_flat if clamp else None)
    return cache[key]


def fused_weights_nonneg(solver, nstoch=999):
    """True when every stochastic size's heating weights are >= 0 (then
    the pre-folded kernel equals the clamp-then-fold exact solve for
    non-negative absorbed values)."""
    n_stoch = min(nstoch, solver.nsize)
    cache = _cache(solver)
    missing = [i for i in range(n_stoch) if ("fused_nonneg", i) not in cache]
    if missing:
        with trace.span("a2e.stacks"):
            for i in missing:
                prepare_size_arrays_fused(solver, i)
    return all(cache[("fused_nonneg", i)] for i in range(n_stoch))


def a2e_devices(device, devices=None):
    """The devices the stochastic sizes' solve is split over, as soc_tpu
    splits it (stochastic.py:300-303 there): the given list, else every
    visible card when ``device`` is CUDA, else ``device`` alone. Under
    several processes (parallel/dist.py) the process's own devices
    whatever the list (a mesh's global list names other processes'
    cards): each solves every cell on its own, as soc_tpu's processes do
    (stochastic.py:294-298 there), and holds EMITTED without a
    collective. The environment variable SOC_TPU_A2E_SHARD=0 turns the
    split off."""
    from ..parallel import dist
    device = torch.device(device)
    if os.environ.get("SOC_TPU_A2E_SHARD", "1") == "0":
        return [device]
    if dist.process_count() > 1:
        return dist.local_devices(device)
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def solve_emission(solver, absorbed, device, nstoch=999, clip_last=True,
                   aalg=None, devices=None):
    """Full A2E solve: emission summed over all grain sizes.

    absorbed : [CELLS, NFREQ] host array (the absorbed.data payload)
    nstoch   : sizes >= nstoch are treated at equilibrium
    aalg     : optional [CELLS] minimum aligned grain size; then the
               polarised emission PEMITTED is returned too
    devices  : devices to split the cells over (see a2e_devices)
    On a CUDA device the stochastic sizes go through a hand kernel: the
    pre-folded one when all weights and absorbed values are >= 0, else the
    clamp kernel (negative entries come from the WITH_REFERENCE delta
    fields of a later slice), one launch per device
    (a2e_kernel.solve_all_sizes_sharded).
    Returns EMITTED [CELLS, NFREQ] float32 (, PEMITTED if aalg given).
    """
    device = torch.device(device)
    cells, nfreq = absorbed.shape
    with trace.span("a2e.host"):
        absorbed = np.asarray(absorbed, np.float32).copy()
        if clip_last and nfreq >= 2:
            # guard against spurious weight on the topmost channel
            # (A2E.py:184)
            absorbed[:, -1] = np.clip(absorbed[:, -1], 0.0,
                                      0.2 * absorbed[:, -2])
        emitted = np.zeros((cells, nfreq), np.float32)
        pemitted = np.zeros((cells, nfreq), np.float32) \
            if aalg is not None else None
    n_stoch = min(nstoch, solver.nsize)
    if n_stoch > 0:
        with trace.span("a2e.host"):
            clamp = not (fused_weights_nonneg(solver, n_stoch)
                         and absorbed.min() >= 0.0)
        align = None
        if aalg is not None:
            align = torch.as_tensor(np.stack(
                [alignment_weights(solver, i, np.asarray(aalg))
                 for i in range(n_stoch)]), device=device)
        with trace.span("a2e.upload"):
            ab = torch.as_tensor(absorbed, device=device)
        shards = a2e_devices(device, devices)
        stacks = {d: get_fused_stacks(solver, d, n_stoch, clamp=clamp)
                  for d in set(shards)}
        with trace.span("a2e.kernel", shards=len(shards)):
            tot, ptot = a2e_kernel.solve_all_sizes_sharded(
                stacks, ab, align, shards, clamp)
            tot = tot.cpu().numpy()
            ptot = None if pemitted is None else ptot.cpu().numpy()
        with trace.span("a2e.host"):
            emitted += tot
            if pemitted is not None:
                pemitted += ptot
    for isize in range(n_stoch, solver.nsize):
        emit_size = solve_equilibrium_size(solver, isize, absorbed)
        emitted += emit_size
        if pemitted is not None:
            w = alignment_weights(solver, isize, np.asarray(aalg))
            pemitted += emit_size * w[:, None]
    if pemitted is not None:
        return emitted, pemitted
    return emitted


def solve_emission_streaming(solver, absorbed_path, emitted_path, device,
                             nstoch=999, batch=None, aalg=None,
                             pemitted_path=None, ifreq=None):
    """Out-of-core A2E solve (soc_tpu's solve_emission_streaming): stream
    absorbed.data through ``device`` in prefetched chunks of rows and write
    emitted.data in the background (soc_tpu_torch.native), so neither file
    has to fit in host memory. Each chunk is one solve_emission call: on
    the card one A2E kernel launch a chunk (a2e_all_sizes, or a2e_clamp
    where a weight or absorbed value is negative) per device of
    a2e_devices. The result equals the in-memory solve_emission of the
    same chunks.

    batch : rows a chunk; by default about 64 MB of rows, in whole
        16,384-row chunks, at least 65,536 rows (soc_tpu's rule)
    aalg  : [CELLS] minimum aligned grain size: the polarised emission
        goes to ``pemitted_path`` (<emitted>.P)
    ifreq : write only this frequency's column (the reference A2E.py
        IFREQ argument: the emitted files get ONE column)
    Returns the number of rows solved.
    """
    from ..native import StreamReader, StreamWriter
    ncols = solver.nfreq if ifreq is None else 1
    if batch is None:
        batch = max(1 << 16,
                    (64 << 20) // (solver.nfreq * 4) // 16384 * 16384)

    def sel(emit):
        return emit if ifreq is None else \
            np.ascontiguousarray(emit[:, ifreq:ifreq + 1])

    with StreamReader(absorbed_path, batch) as rd:
        # the writers open inside the try: a failure opening the second
        # must still close (flush) the first
        wr = wp = None
        row0 = 0
        try:
            wr = StreamWriter(emitted_path, rd.rows, ncols)
            if aalg is not None and pemitted_path:
                wp = StreamWriter(pemitted_path, rd.rows, ncols)
            for chunk in rd:
                if aalg is not None:
                    a_chunk = np.asarray(aalg)[row0:row0 + len(chunk)]
                    emit, pem = solve_emission(solver, chunk, device,
                                               nstoch=nstoch, aalg=a_chunk)
                    wr.put(sel(emit))
                    if wp is not None:
                        wp.put(sel(pem))
                else:
                    wr.put(sel(solve_emission(solver, chunk, device,
                                              nstoch=nstoch)))
                row0 += len(chunk)
        finally:
            if wr is not None:
                wr.close()
            if wp is not None:
                wp.close()
    return row0
