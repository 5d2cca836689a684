"""Multi-dust emission (port of soc_tpu.pipeline.mabu, without cosmic-ray
heating and polarisation).

Splits total absorptions between dust populations in proportion to their
absorption cross sections, solves each population's emission (stochastic
A2E for gset dusts, equilibrium temperature for eqdust) and sums the
abundance-weighted emissions:

    ABS_d[cell, f] = ABS[cell, f] * R[f, d] / sum_d' ABU[cell, d'] R[f, d']
    EMIT[cell, f]  = sum_d ABU[cell, d] * EMIT_d[cell, f]
"""

from dataclasses import dataclass

import numpy as np

from ..constants import EMIT_COEFF, FACTOR, H_K, PLANCK, \
    planck_intensity
from ..solve.solver_file import SolverData

from ..solve import stochastic


@dataclass
class DustComponent:
    """One dust population in a multi-dust run."""

    name: str
    kind: str                      # 'gset' (stochastic) or 'eqdust'
    kabs: np.ndarray               # [NFREQ] cross section per H
    solver: SolverData = None      # for kind == 'gset'
    nstoch: int = 999
    freq: np.ndarray = None        # for kind == 'eqdust'


def split_absorbed(absorbed, rabs, abu, idust, den=None):
    """Per-dust absorption share (per unit abundance of that dust)."""
    if den is None:
        den = np.einsum("cd,fd->cf", abu, rabs)
    return absorbed * rabs[None, :, idust] / np.maximum(den, 1e-40)


def solve_equilibrium_eqdust(kabs, freq, absorbed, ne=30000):
    """Equilibrium dust of one population: per-cell T from the E<->T
    table and the emission per unit density (host NumPy, float64)."""
    freq = np.asarray(freq, np.float64)
    kabs = np.asarray(kabs, np.float64)
    tstep = 1600.0 / ne
    tt = 1.0 + tstep * np.arange(ne)
    bnu = planck_intensity(freq[None, :], tt[:, None])
    tmp = kabs[None, :] * bnu
    df = freq[2:] - freq[:-2]
    res = (tmp[:, 0] * (freq[1] - freq[0]) + tmp[:, -1] * (freq[-1] - freq[-2])
           + np.sum(tmp[:, 1:-1] * df[None, :], axis=1))
    eout = 4.0 * np.pi * FACTOR * 0.5 * res
    absorbed = np.asarray(absorbed, np.float64)
    integ = absorbed * (PLANCK * freq)[None, :]
    ein = 0.5 * np.sum((integ[:, 1:] + integ[:, :-1])
                       * (freq[1:] - freq[:-1])[None, :], axis=1)
    t = np.interp(ein, eout, tt)
    x = np.clip(H_K * freq[None, :] / np.maximum(t[:, None], 1e-3),
                1e-10, 500)
    emit = (EMIT_COEFF * FACTOR) * kabs[None, :] * freq[None, :] ** 2 \
        / np.expm1(x)
    return emit.astype(np.float32), t.astype(np.float32)


def solve_emission_multi(components, absorbed, device, abu=None,
                         devices=None):
    """Full multi-dust solve.

    components : list[DustComponent]
    absorbed   : [CELLS, NFREQ] total absorptions (host array)
    abu        : [CELLS, NDUST] abundances (default: all ones)
    devices    : devices the stochastic solve splits its cells over
                 (stochastic.a2e_devices)
    Returns EMITTED [CELLS, NFREQ] float32.
    """
    cells, nfreq = absorbed.shape
    ndust = len(components)
    if abu is None:
        abu = np.ones((cells, ndust), np.float32)
    rabs = np.zeros((nfreq, ndust))
    for d, comp in enumerate(components):
        rabs[:, d] = np.clip(comp.kabs, 1e-40, 1e30)
    rabs /= (1e-40 + rabs.sum(axis=1))[:, None]
    rabs = np.clip(rabs, 1e-30, 1.0)

    emitted = np.zeros((cells, nfreq), np.float32)
    split_den = np.einsum("cd,fd->cf", abu, rabs)
    for d, comp in enumerate(components):
        absd = split_absorbed(absorbed, rabs, abu, d, den=split_den)
        if comp.kind == "gset":
            emit_d = stochastic.solve_emission(comp.solver, absd, device,
                                               nstoch=comp.nstoch,
                                               devices=devices)
        elif comp.kind == "eqdust":
            emit_d, _ = solve_equilibrium_eqdust(comp.kabs, comp.freq, absd)
        else:
            raise ValueError(f"unknown dust kind {comp.kind!r}")
        emitted += emit_d * abu[:, d][:, None]
    return emitted
