"""Multi-dust emission (port of soc_tpu.pipeline.mabu).

Splits total absorptions between dust populations in proportion to their
absorption cross sections, solves each population's emission (stochastic
A2E for gset dusts, equilibrium temperature for eqdust) and sums the
abundance-weighted emissions:

    ABS_d[cell, f] = ABS[cell, f] * R[f, d] / sum_d' ABU[cell, d'] R[f, d']
    EMIT[cell, f]  = sum_d ABU[cell, d] * EMIT_d[cell, f]

With `CR_HEATING` a cosmic-ray heating rate rides in the last channel;
with `polarisation` the emission of the aligned grains (PEMITTED) is
summed the same way.
"""

import time
from dataclasses import dataclass

import numpy as np

from ..constants import EMIT_COEFF, FACTOR, H_K, PLANCK, \
    planck_intensity
from ..solve.solver_file import SolverData

from ..solve import stochastic
from ..utils import trace


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


def relative_cross_sections(components, nfreq):
    """R [NFREQ, NDUST]: each dust's share of the summed cross section a
    channel (A2E_MABU.py:338-342), the split_absorbed ratios."""
    rabs = np.zeros((nfreq, len(components)))
    for d, comp in enumerate(components):
        rabs[:, d] = np.clip(comp.kabs, 1e-40, 1e30)
    rabs /= (1e-40 + rabs.sum(axis=1))[:, None]
    return np.clip(rabs, 1e-30, 1.0)


def cr_heating_channel(mode, dens, cells):
    """Extra per-cell heating rate [erg/s/H * FACTOR] that `CR_HEATING`
    injects through the LAST channel of the absorbed array
    (A2E_MABU.py:795-817):
      1 : the cosmic-ray rate 1e-27 erg/s/H
      2 : twice that (an upper limit)
      3 : gas-dust coupling 9e-34 n(H) sqrt(Tgas) (Tgas - Tdust), with the
          reference's Tgas(n), dT(n) interpolations
    """
    if mode == 1:
        return np.full(cells, 1.0e-27 * FACTOR, np.float32)
    if mode == 2:
        return np.full(cells, 2.0e-27 * FACTOR, np.float32)
    if mode == 3:
        logn = np.log10(np.clip(np.asarray(dens, np.float64), 1e-8, 1e20))
        xs = [-8.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 20.0]
        tg = np.interp(logn, xs, [15, 15, 15, 15, 14, 12, 10, 7, 6, 6, 6])
        dt = np.interp(logn, xs, [5, 5, 5, 5, 5, 5, 3, 1, 0, 0, 0])
        return (9.0e-34 * np.asarray(dens, np.float64) * np.sqrt(tg) * dt
                * FACTOR).astype(np.float32)
    raise ValueError("CR_HEATING mode %r" % mode)


def solve_equilibrium_eqdust(kabs, freq, absorbed, ne=30000,
                             cr_channel=False):
    """Equilibrium dust of one population: per-cell T from the E<->T
    table and the emission per unit density (host NumPy, float64).
    cr_channel: the last channel holds a direct heating rate (erg/s/H *
    FACTOR), left out of the photon integral and added to Ein as it is
    (kernel_eqsolver.c:27-33)."""
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
    ein_extra = 0.0
    if cr_channel:
        absorbed = absorbed.copy()
        ein_extra = absorbed[:, -1].copy()
        absorbed[:, -1] = 0.0
    integ = absorbed * (PLANCK * freq)[None, :]
    ein = ein_extra + 0.5 * np.sum((integ[:, 1:] + integ[:, :-1])
                                   * (freq[1:] - freq[:-1])[None, :],
                                   axis=1)
    t = np.interp(ein, eout, tt)
    x = np.clip(H_K * freq[None, :] / np.maximum(t[:, None], 1e-3),
                1e-10, 500)
    emit = (EMIT_COEFF * FACTOR) * kabs[None, :] * freq[None, :] ** 2 \
        / np.expm1(x)
    return emit.astype(np.float32), t.astype(np.float32)


def solve_emission_multi(components, absorbed, device, abu=None,
                         devices=None, cr_mode=0, dens=None, pol=None,
                         return_components=False, timings=None):
    """Full multi-dust solve.

    components : list[DustComponent]
    absorbed   : [CELLS, NFREQ] total absorptions (host array)
    abu        : [CELLS, NDUST] abundances (default: all ones)
    devices    : devices the stochastic solve splits its cells over
                 (stochastic.a2e_devices)
    cr_mode    : CR_HEATING 1/2/3: the rate of cr_heating_channel (mode 3
                 from dens [CELLS]) replaces the last channel and is split
                 between the dusts like any absorption; an equilibrium
                 dust adds it to its absorbed energy, a stochastic one
                 takes it as its highest channel's absorptions (which
                 stochastic.solve_emission clips to 0.2 times the channel
                 below, as soc_tpu does)
    pol        : {component index: spec} of the `polarisation` keyword:
                 ('aalg', aalg [CELLS]) for a stochastic dust (the
                 emission of the aligned sizes a >= aalg; the A2E kernel's
                 align path) or ('rfactor', R [CELLS, NFREQ]) for an
                 equilibrium dust (the .rpol fraction, full._rpol_factor)
    return_components : also return the per-dust (absorbed_d, emit_d)
                 pairs, the training pairs of `nnmake`
                 (A2E_MABU.py:1017-1068)
    timings    : a dict, if given, receives each component's solve seconds
                 under 'a2e_<name>'
    Returns EMITTED [CELLS, NFREQ] float32; with return_components,
    (EMITTED, [per-dust (absorbed_d, emit_d)]); with pol, PEMITTED
    appended to the return value.
    """
    cells, nfreq = absorbed.shape
    ndust = len(components)
    with trace.span("a2e.host"):
        if abu is None:
            abu = np.ones((cells, ndust), np.float32)
        if cr_mode > 0:
            absorbed = np.asarray(absorbed).copy()
            absorbed[:, -1] = cr_heating_channel(cr_mode, dens, cells)
        rabs = relative_cross_sections(components, nfreq)
        emitted = np.zeros((cells, nfreq), np.float32)
        pemitted = np.zeros((cells, nfreq), np.float32) if pol else None
        split_den = np.einsum("cd,fd->cf", abu, rabs)
    per_dust = []
    for d, comp in enumerate(components):
        t0 = time.time()
        with trace.span("a2e.host"):
            absd = split_absorbed(absorbed, rabs, abu, d, den=split_den)
        spec = pol.get(d) if pol else None
        pemit_d = None
        if comp.kind == "gset":
            if spec is not None and spec[0] == "aalg":
                emit_d, pemit_d = stochastic.solve_emission(
                    comp.solver, absd, device, nstoch=comp.nstoch,
                    aalg=spec[1], devices=devices)
            else:
                emit_d = stochastic.solve_emission(
                    comp.solver, absd, device, nstoch=comp.nstoch,
                    devices=devices)
        elif comp.kind == "eqdust":
            emit_d, _ = solve_equilibrium_eqdust(comp.kabs, comp.freq, absd,
                                                 cr_channel=cr_mode > 0)
            if spec is not None and spec[0] == "rfactor":
                pemit_d = emit_d * spec[1]
        else:
            raise ValueError(f"unknown dust kind {comp.kind!r}")
        if timings is not None:
            timings["a2e_" + comp.name] = time.time() - t0
        with trace.span("a2e.host"):
            emitted += emit_d * abu[:, d][:, None]
            if pemit_d is not None:
                pemitted += pemit_d * abu[:, d][:, None]
        if return_components:
            per_dust.append((absd, emit_d))
    out = (emitted,)
    if return_components:
        out += (per_dust,)
    if pol:
        out += (pemitted,)
    return out if len(out) > 1 else emitted
