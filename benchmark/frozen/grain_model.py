# Frozen copy of soc_tpu_torch/solve/grain_model.py at commit 6496b8b (the benchmark's yardstick:
# later changes to the program do not reach it). Only imports were changed.
"""GSET grain model: sizes, optical data, enthalpies.

The port's own copy of ``soc_tpu.solve.grain_model``, the same code: the
port imports nothing of soc_tpu.

Reads the reference's gs_*.dust container (DustLib.py GSETDust, :2126-2241):
a small text file pointing to three data files --
  sizes       : GRAIN_DENSITY header; rows [a_um, s_frac, tmin, tmax]
  optical     : header "QNSIZE QNFREQ"; per size a size_um line, a header
                line, then QNFREQ rows [freq, Qabs, Qsca, g]
  enthalpies  : C_NSIZE, sizes [um], C_NTEMP, temperatures, E[C_NSIZE,C_NTEMP]

Provides the cross-section and E<->T interpolations the solver-file
generation needs (semantics match DustLib: Q interpolated over size *before*
the pi a^2 scaling; E/a^3 interpolated between enthalpy sizes; T<->E
interpolated on log-log scale).
"""

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class GSETDust:
    grain_density: float      # grains / H
    size_a: np.ndarray        # [NSIZE] cm
    s_frac: np.ndarray        # [NSIZE] fraction per size bin (sum == 1)
    tmin: np.ndarray          # [NSIZE]
    tmax: np.ndarray          # [NSIZE]
    qsize: np.ndarray         # [QNSIZE] cm
    qfreq: np.ndarray         # [QNFREQ] Hz (increasing)
    qabs: np.ndarray          # [QNSIZE, QNFREQ]
    qsca: np.ndarray          # [QNSIZE, QNFREQ]
    g: np.ndarray             # [QNSIZE, QNFREQ]
    c_size: np.ndarray        # [C_NSIZE] cm
    c_temp: np.ndarray        # [C_NTEMP] K
    c_e: np.ndarray           # [C_NSIZE, C_NTEMP] erg (per grain)

    @property
    def nsize(self):
        return len(self.size_a)

    # ---- cross sections --------------------------------------------------
    def _q_at(self, q, isize, freq):
        """Interpolate a Q table to (size_a[isize], freq[]): size first
        (linear in a, Q before the a^2 scaling), then frequency (linear)."""
        a = float(self.size_a[isize])
        qs = np.asarray([np.interp(a, self.qsize, q[:, i])
                         for i in range(q.shape[1])])
        return np.interp(freq, self.qfreq, qs)

    def skabs_int(self, isize, freq):
        """pi a^2 Qabs * S_FRAC * GRAIN_DENSITY (DustLib SKabs_Int)."""
        a = float(self.size_a[isize])
        q = self._q_at(self.qabs, isize, np.asarray(freq, np.float64))
        return (np.pi * a * a * q * self.s_frac[isize] * self.grain_density)

    def skabs(self, isize, freq):
        """pi a^2 Qabs for a single grain (no S_FRAC / GRAIN_DENSITY)."""
        a = float(self.size_a[isize])
        q = self._q_at(self.qabs, isize, np.asarray(freq, np.float64))
        return np.pi * a * a * q

    def kabs(self, freq):
        """Total absorption cross section per H over all sizes."""
        tot = np.zeros(len(np.atleast_1d(freq)))
        for s in range(self.nsize):
            tot = tot + self.skabs_int(s, freq)
        return tot

    # ---- enthalpy <-> temperature ---------------------------------------
    def _e_of_t_vector(self, isize):
        """Enthalpy E(C_TEMP) interpolated to size_a[isize] via E/a^3."""
        a = float(self.size_a[isize])
        i = int(np.searchsorted(self.c_size, a) - 1)
        i = np.clip(i, 0, len(self.c_size) - 2)
        iw = ((self.c_size[i + 1] - a)
              / (self.c_size[i + 1] - self.c_size[i]))
        e = (iw * self.c_e[i] / self.c_size[i] ** 3
             + (1.0 - iw) * self.c_e[i + 1] / self.c_size[i + 1] ** 3)
        return e * a ** 3

    def t2e(self, isize, t):
        e = self._e_of_t_vector(isize)
        return np.exp(np.interp(np.log(t), np.log(self.c_temp), np.log(e)))

    def e2t(self, isize, e_query):
        e = self._e_of_t_vector(isize)
        return np.exp(np.interp(np.log(np.maximum(e_query, 1e-300)),
                                np.log(e), np.log(self.c_temp)))


def read_gset_dust(path):
    fopt = fent = fsize = None
    base = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        return p if os.path.isabs(p) or os.path.exists(p) \
            else os.path.join(base, p)

    for line in open(path):
        s = line.split()
        if len(s) < 2:
            continue
        if s[0] == "optical":
            fopt = resolve(s[1])
        elif s[0] == "enthalpies":
            fent = resolve(s[1])
        elif s[0] == "sizes":
            fsize = resolve(s[1])
    if not (fopt and fent and fsize):
        raise ValueError(f"{path}: needs optical/enthalpies/sizes keywords")

    # sizes
    grain_density = float(open(fsize).readline().split()[0])
    d = np.loadtxt(fsize, skiprows=3, ndmin=2)
    size_a = d[:, 0] * 1.0e-4
    s_frac = d[:, 1] / d[:, 1].sum()
    tmin, tmax = d[:, 2].copy(), d[:, 3].copy()

    # optical
    lines = open(fopt).readlines()
    qnsize, qnfreq = [int(x) for x in lines[0].split()[:2]]
    qsize = np.zeros(qnsize)
    opt = np.zeros((qnsize, qnfreq, 4))
    row = 1
    for isz in range(qnsize):
        qsize[isz] = float(lines[row].split()[0]) * 1.0e-4
        row += 2
        for ifr in range(qnfreq):
            opt[isz, ifr] = [float(x) for x in lines[row].split()[:4]]
            row += 1
    qfreq = opt[0, :, 0]

    # extrapolate optical data down to the smallest size bin (DustLib:2202)
    if size_a[0] < qsize[0]:
        scale = (size_a[0] / qsize[0]) ** 2
        opt[0, :, 1] *= scale
        opt[0, :, 2] *= scale
        qsize[0] = size_a[0]

    # enthalpies
    lines = [ln for ln in open(fent).readlines()]
    i = 0
    while lines[i].startswith("#"):
        i += 1
    c_nsize = int(lines[i].split()[0])
    i += 1
    c_size = np.asarray([float(lines[i + j].split()[0])
                         for j in range(c_nsize)]) * 1.0e-4
    i += c_nsize
    c_ntemp = int(lines[i].split()[0])
    i += 1
    c_temp = np.asarray([float(lines[i + j].split()[0])
                         for j in range(c_ntemp)])
    i += c_ntemp
    c_e = np.loadtxt(fent, skiprows=i, ndmin=2)
    assert c_e.shape == (c_nsize, c_ntemp), (c_e.shape, c_nsize, c_ntemp)

    return GSETDust(grain_density=grain_density, size_a=size_a,
                    s_frac=s_frac, tmin=tmin, tmax=tmax, qsize=qsize,
                    qfreq=qfreq, qabs=opt[:, :, 1], qsca=opt[:, :, 2],
                    g=opt[:, :, 3], c_size=c_size, c_temp=c_temp, c_e=c_e)


def write_gset_dust(path, dust, ne=256):
    """Write a GSET dust container: <base>.dust plus .opt/.ent/.size aux
    files, in the reference's native-CRT text format
    (DustLib.py write_A2E_dustfiles, :1992-2123) so the files are readable
    both by ``read_gset_dust`` and by the reference's ``GSETDust`` class.
    """
    base, _ = os.path.splitext(path)
    name = os.path.basename(base)

    with open(base + ".size", "w") as fp:
        fp.write("%12.5e   # GRAIN_DENSITY\n" % dust.grain_density)
        fp.write("%d %d    # NSIZE NE\n" % (dust.nsize, ne))
        fp.write("#  SIZE [um]    S_FRAC      Tmin [K]   Tmax [K]\n")
        for i in range(dust.nsize):
            fp.write("  %12.5e %12.5e  %10.3e %10.3e\n"
                     % (1.0e4 * dust.size_a[i], dust.s_frac[i],
                        dust.tmin[i], dust.tmax[i]))

    with open(base + ".opt", "w") as fp:
        qnsize, qnfreq = dust.qabs.shape
        fp.write("%d %d  # NSIZE, NFREQ\n" % (qnsize, qnfreq))
        for i in range(qnsize):
            fp.write("%12.5e   # SIZE [um]\n" % (1.0e4 * dust.qsize[i]))
            fp.write("# FREQ      Qabs        Qsca        g\n")
            for j in range(qnfreq):        # increasing frequency
                fp.write("%12.5e %12.5e %12.5e %12.5e\n"
                         % (dust.qfreq[j], dust.qabs[i, j],
                            dust.qsca[i, j], dust.g[i, j]))

    with open(base + ".ent", "w") as fp:
        fp.write("# E[NSIZE, NTEMP] grain enthalpies\n")
        fp.write("%d   #  NSIZE\n" % len(dust.c_size))
        for a in dust.c_size:
            fp.write("   %12.5e\n" % (1.0e4 * a))
        fp.write("%d   #  NTEMP\n" % len(dust.c_temp))
        for t in dust.c_temp:
            fp.write("   %12.5e\n" % t)
        for row in dust.c_e:               # one row per size
            fp.write(" ".join("%12.5e" % e for e in row) + "\n")

    with open(base + ".dust", "w") as fp:
        fp.write("gsetdust\n")
        fp.write("prefix     %s\n" % name)
        fp.write("nstoch     999\n")
        fp.write("optical    %s.opt\n" % name)
        fp.write("enthalpies %s.ent\n" % name)
        fp.write("sizes      %s.size\n" % name)


def gset_effective_optics(dust, freq, gl_pc):
    """Sum the per-size Q tables into single-population simple-dust optics
    (the <name>_simple.dust content the pipeline's RT stage needs,
    ASOC_driver.py:240-245; write_simple_dust semantics DustLib.py:1691).
    """
    from .constants import PARSEC
    from .dust_io import DustOptics
    freq = np.asarray(freq, np.float64)
    kabs = np.zeros(len(freq))
    ksca = np.zeros(len(freq))
    gsum = np.zeros(len(freq))
    for i in range(dust.nsize):
        a = float(dust.size_a[i])
        w = (np.pi * a * a * dust.s_frac[i] * dust.grain_density)
        qa = dust._q_at(dust.qabs, i, freq)
        qs = dust._q_at(dust.qsca, i, freq)
        gg = dust._q_at(dust.g, i, freq)
        kabs += w * qa
        ksca += w * qs
        gsum += w * qs * gg
    gl_cm = gl_pc * PARSEC
    return DustOptics(freq=freq,
                      g=(gsum / np.maximum(ksca, 1e-300)).astype(np.float32),
                      abs_gl=(kabs * gl_cm).astype(np.float32),
                      sca_gl=(ksca * gl_cm).astype(np.float32),
                      grain_density=1.0, grain_size=np.sqrt(1.0 / np.pi))
