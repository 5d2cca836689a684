"""Dust optical-property and scattering-function codecs.

The port's own copy of ``soc_tpu.io.dust``, the same code: the port imports
nothing of soc_tpu.

Simple ("eqdust") dust file (ASCII, ASOC_aux.py:557-596): header lines
``eqdust``, grain density [g/cm3], grain size [cm], NFREQ; then rows
``freq  g  Qabs  Qsca``. Cross sections are converted to optical depth per
unit density per grid-length:  tau = Q * GRAIN_DENSITY * pi * a^2 * GL * PARSEC.

Scattering function file (*.dsc, ASOC_aux.py:639-647): float32
``DSC[NFREQ, BINS]`` (discrete phase function over cos-theta bins) followed by
``CSC[NFREQ, BINS]`` (inverse-CDF lookup: CSC[f, floor(u*BINS)] = cos theta).
"""

from dataclasses import dataclass

import numpy as np

from ..constants import PARSEC


@dataclass
class DustOptics:
    """Per-dust optical data on the shared frequency grid."""

    freq: np.ndarray   # [NFREQ] Hz
    g: np.ndarray      # [NFREQ] asymmetry parameter
    abs_gl: np.ndarray  # [NFREQ] absorption tau / unit density / GL
    sca_gl: np.ndarray  # [NFREQ] scattering tau / unit density / GL
    grain_density: float = 0.0
    grain_size: float = 0.0

    @property
    def nfreq(self):
        return len(self.freq)


def read_simple_dust(path, gl_pc):
    """Read an eqdust file; gl_pc is the root cell size in parsec."""
    with open(path) as fp:
        lines = fp.readlines()
    kind = lines[0].split()[0]
    if kind != "eqdust":
        raise ValueError(f"{path}: expected 'eqdust' header, got {kind!r}")
    grain_density = float(lines[1].split()[0])
    grain_size = float(lines[2].split()[0])
    coeff = grain_density * np.pi * grain_size**2 * gl_pc * PARSEC
    data = np.loadtxt(path, skiprows=4)
    return DustOptics(
        freq=np.asarray(data[:, 0], np.float64),
        g=np.asarray(data[:, 1], np.float32),
        abs_gl=np.asarray(data[:, 2] * coeff, np.float32),
        sca_gl=np.asarray(data[:, 3] * coeff, np.float32),
        grain_density=grain_density,
        grain_size=grain_size,
    )


def write_simple_dust(path, optics, gl_pc):
    """Inverse of read_simple_dust (mainly for tests / dust compiler)."""
    coeff = optics.grain_density * np.pi * optics.grain_size**2 * gl_pc * PARSEC
    with open(path, "w") as fp:
        fp.write("eqdust\n")
        fp.write(f" {optics.grain_density:.5e}\n")
        fp.write(f" {optics.grain_size:.5e}\n")
        fp.write(f"{optics.nfreq}\n")
        for i in range(optics.nfreq):
            fp.write(" %12.5e  %8.5f  %12.5e %12.5e\n" % (
                optics.freq[i], optics.g[i],
                optics.abs_gl[i] / coeff, optics.sca_gl[i] / coeff))


def read_scattering_function(path, nfreq, bins):
    """Read a *.dsc file -> (DSC[nfreq, bins], CSC[nfreq, bins]) float32."""
    raw = np.fromfile(path, np.float32)
    expect = 2 * nfreq * bins
    if len(raw) != expect:
        raise ValueError(
            f"{path}: has {len(raw)} float32 values, expected {expect} "
            f"(nfreq={nfreq}, bins={bins})")
    dsc = raw[: nfreq * bins].reshape(nfreq, bins)
    csc = raw[nfreq * bins:].reshape(nfreq, bins)
    return dsc, csc


def write_scattering_function(path, dsc, csc):
    with open(path, "wb") as fp:
        np.asarray(dsc, np.float32).tofile(fp)
        np.asarray(csc, np.float32).tofile(fp)


def hg_scattering_function(g_values, bins):
    """Build (DSC, CSC) tables from Henyey-Greenstein asymmetry parameters.

    DSC[f, j] = HG phase function at cos theta for bin j (uniform cos grid);
    CSC[f, j] = cos theta at cumulative probability (j+0.5)/bins, i.e. the
    inverse CDF the sampler looks up with a uniform deviate. Used for tests
    and as the dust-compiler fallback when no tabulated phase function exists.
    """
    g_values = np.atleast_1d(np.asarray(g_values, np.float64))
    nf = len(g_values)
    dsc = np.zeros((nf, bins), np.float32)
    csc = np.zeros((nf, bins), np.float32)
    mu = np.linspace(-1.0 + 1.0 / bins, 1.0 - 1.0 / bins, bins)
    u = (np.arange(bins) + 0.5) / bins
    for i, g in enumerate(g_values):
        if abs(g) < 1e-5:
            dsc[i] = 1.0 / (4.0 * np.pi)
            csc[i] = 2.0 * u - 1.0
        else:
            dsc[i] = (1.0 - g * g) / (4.0 * np.pi * (1.0 + g * g - 2.0 * g * mu) ** 1.5)
            # analytic inverse CDF of HG in cos theta
            t = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
            csc[i] = (1.0 + g * g - t * t) / (2.0 * g)
    return dsc, csc
