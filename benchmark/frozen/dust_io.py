# Frozen copy of soc_tpu_torch/io/dust.py at commit 6496b8b (the benchmark's yardstick:
# later changes to the program do not reach it). Imports changed; functions
# the benchmark does not call left out.
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

from .constants import PARSEC


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


