"""Equilibrium dust temperatures and their emission, the reference's: a
cell's absorbed energy per H, E_in = h sum_f ABS[f] TW[f] (TW the
trapezoid weights nu * dnu of the channel grid), matched in float64 to
the emitted energy 4 pi FACTOR / (GL PARSEC) * trapz(k_abs B_nu(T)) over
3-1600 K; the emission of a temperature, photons/Hz/H,
FACTOR 4 pi k_abs B_nu(T) / (h nu) / (GL PARSEC)."""

import numpy as np

from ..frozen.constants import (BOLTZMANN, C_LIGHT, FACTOR, PARSEC,
                                PLANCK)

T_LO, T_HI = 3.0, 1600.0


def trapezoid_weights(freq):
    freq = np.asarray(freq, np.float64)
    d = np.empty_like(freq)
    d[0] = freq[1] - freq[0]
    d[-1] = freq[-1] - freq[-2]
    d[1:-1] = freq[2:] - freq[:-2]
    return 0.5 * freq * d


def planck(freq, t):
    x = PLANCK * freq / (BOLTZMANN * t)
    return 2.0 * PLANCK * freq ** 3 / C_LIGHT ** 2 / np.expm1(
        np.minimum(x, 700.0))


def emitted_energy(freq, abs_gl, gl_pc, t):
    """[N] energy a cell emits per H at temperatures t [N]."""
    b = planck(freq[None, :], t[:, None]) * abs_gl[None, :]
    return 4.0 * np.pi * FACTOR / (gl_pc * PARSEC) * np.trapezoid(
        b, freq, axis=1)


def temperatures(freq, abs_gl, gl_pc, absorbed, low=None):
    """[N] temperatures of the absorbed.data rows [N, NF], whose energy
    per H is h sum_f ABS[f] TW[f] (of_energy). ``low``, a function
    rounding an array to a lower precision, rounds both energies before
    they are matched (the control)."""
    low = low or (lambda x: x)
    ein = PLANCK * np.asarray(absorbed, np.float64) @ trapezoid_weights(
        np.asarray(freq, np.float64))
    return of_energy(freq, abs_gl, gl_pc, low(ein), low)


def of_energy(freq, abs_gl, gl_pc, ein, low=None, points=20001):
    """[N] temperatures of absorbed energies per H [N]: the energy matched
    to the emitted energy tabulated on ``points`` log-spaced temperatures
    over 3-1600 K, interpolated in log E - log T (exact to 1e-8 of T);
    ``low`` rounds the table (the control)."""
    freq = np.asarray(freq, np.float64)
    low = low or (lambda x: x)
    tgrid = np.exp(np.linspace(np.log(T_LO), np.log(T_HI), points))
    eout = low(emitted_energy(freq, abs_gl, gl_pc, tgrid))
    lt = np.interp(np.log(np.maximum(ein, 1e-300)), np.log(eout),
                   np.log(tgrid))
    return np.exp(lt)


def emission(freq, abs_gl, gl_pc, t):
    """[N, NF] photons/Hz/H emitted at temperatures t."""
    freq = np.asarray(freq, np.float64)
    return (FACTOR * 4.0 * np.pi * abs_gl[None, :]
            * planck(freq[None, :], np.asarray(t, np.float64)[:, None])
            / (PLANCK * freq[None, :]) / (gl_pc * PARSEC))
