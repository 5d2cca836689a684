"""Equilibrium-temperature dust: E<->T table, T solve, emission (port of
soc_tpu.solve.equilibrium).

The table is built once in float64 on the host; the per-cell solve and
the [CELLS, NFREQ] emission are elementwise float32 tensor code.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (EMIT_COEFF, FACTOR, H_K, PARSEC, PLANCK,
                         planck_intensity)


@dataclass(frozen=True)
class TemperatureTable:
    """Log-spaced energy -> temperature lookup: E[i] = emin * ke**i."""

    ttt: torch.Tensor      # [NE] float32 T values
    emin: float
    ke: float
    ne: int


def table_arrays(freq, abs_gl, gl_pc, ne=30000, tmax=1600.0):
    """Host arrays of the table: E_out(T) = 4 pi FACTOR/(GL pc) *
    trapz(k_abs * B_nu(T)), inverted onto a log-spaced energy grid.
    Returns (ttt float32 [NE], emin, ke)."""
    freq = np.asarray(freq, np.float64)
    abs_gl = np.asarray(abs_gl, np.float64)
    tstep = tmax / ne
    tt = 1.0 + tstep * np.arange(ne)
    bnu = planck_intensity(freq[None, :], tt[:, None])   # [NE, NFREQ]
    tmp = abs_gl[None, :] * bnu
    df = freq[2:] - freq[:-2]
    res = (tmp[:, 0] * (freq[1] - freq[0]) + tmp[:, -1] * (freq[-1] - freq[-2])
           + np.sum(tmp[:, 1:-1] * df[None, :], axis=1))
    eout = (4.0 * np.pi * FACTOR / (gl_pc * PARSEC)) * 0.5 * res
    emin, emax = eout[0], eout[-1] * 0.9999
    ke = (emax / emin) ** (1.0 / (ne - 1.0))
    egrid = emin * ke ** np.arange(ne)
    ttt = np.interp(egrid, eout, tt).astype(np.float32)
    return ttt, float(emin), float(ke)


def build_temperature_table(freq, abs_gl, gl_pc, device, ne=30000,
                            tmax=1600.0):
    ttt, emin, ke = table_arrays(freq, abs_gl, gl_pc, ne, tmax)
    return TemperatureTable(ttt=torch.as_tensor(ttt, device=device),
                            emin=emin, ke=ke, ne=int(ne))


def cell_levels(grid):
    """[CELLS] int64 hierarchy level of every cell."""
    idx = torch.arange(grid.cells, device=grid.device)
    lev = torch.zeros_like(idx)
    off = grid.off.cpu().tolist()
    for l in range(1, grid.levels):
        lev = torch.where(idx >= off[l], l, lev)
    return lev


def temperature_lookup(table, absorbed_integrated, dens, lev, gl_pc_parsec,
                       beta=1.0, cr_heating=0.0):
    """Per-cell E->T lookup: TABS tally -> absorbed energy per H ->
    log-grid interpolation of the TTT table. cr_heating (`CR_HEATING`)
    adds that multiple of the 1e-27 erg/s/H cosmic-ray rate to every
    cell's absorbed energy (kernel_ASOC_aux.c:769-772)."""
    scale = (PLANCK * FACTOR) / gl_pc_parsec
    ein = (scale * absorbed_integrated
           * torch.exp2(3.0 * lev.to(torch.float32))
           / torch.clamp_min(dens, 1e-30)) / beta
    ein = ein + 1.0e-27 * FACTOR * cr_heating
    oplgke = 1.0 / np.log10(table.ke)
    ie = torch.clamp(torch.floor(
        oplgke * torch.log10(torch.clamp_min(ein, 1e-37) / table.emin)),
        0, table.ne - 2).to(torch.int64)
    e_lo = table.emin * torch.pow(
        torch.tensor(table.ke, dtype=torch.float32, device=ein.device),
        ie.to(torch.float32))
    wi = (e_lo * table.ke - ein) / (e_lo * (table.ke - 1.0))
    t = wi * table.ttt[ie] + (1.0 - wi) * table.ttt[ie + 1]
    return torch.where(dens > 1.0e-7, torch.clamp(t, 3.0, 1600.0),
                       torch.full_like(t, 10.0))


def solve_temperature(grid, table, absorbed_integrated, gl_pc_parsec,
                      beta=1.0, cr_heating=0.0):
    """Per-cell equilibrium temperature from integrated absorbed energy.

    absorbed_integrated : [CELLS] the TABS tally; gl_pc_parsec : GL*PARSEC
    in cm. Empty and parent cells get T=10; the rest are clamped to
    [3, 1600] K."""
    return temperature_lookup(table, absorbed_integrated, grid.dens,
                              cell_levels(grid), gl_pc_parsec, beta=beta,
                              cr_heating=cr_heating)


def emission(freq, abs_gl, temperature, gl_pc_parsec):
    """EMITTED[CELLS, NFREQ] = FACTOR * 4 pi /(h nu) * k_abs * B_nu(T) /
    LENGTH: photon counts per Hz per H atom scaled by FACTOR."""
    device = temperature.device
    coeff = float(np.float32(EMIT_COEFF * FACTOR))
    freq = torch.as_tensor(np.asarray(freq, np.float32),
                           device=device)[None, :]
    abs_gl = torch.as_tensor(np.asarray(abs_gl, np.float32), device=device)
    t = torch.clamp_min(temperature, 1e-3)[:, None]
    x = torch.clamp(float(np.float32(H_K)) * freq / t, 1e-30, 80.0)
    return (coeff * abs_gl[None, :] * freq * freq / torch.expm1(x)
            / float(np.float32(gl_pc_parsec)))
