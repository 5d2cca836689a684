# Frozen copy of soc_tpu_torch/solve/dust_compiler.py at commit 6496b8b (the benchmark's yardstick:
# later changes to the program do not reach it). Imports changed; functions
# the benchmark does not call left out.
"""DustEM dust compiler (the DustLib.py capability).

The port's own copy of ``soc_tpu.solve.dust_compiler``, the same code: the
port imports nothing of soc_tpu.

Parses DustEM model data -- GRAIN.DAT size-distribution lines, the shared
LAMBDA.DAT wavelength grid, per-species Q_*.DAT / G_*.DAT optical tables and
C_*.DAT heat capacities (formats per DustLib.py:964-1340) -- and compiles:

  * effective single-population optics (sum over the size distribution) for
    the RT stage: tau/H cross sections + asymmetry parameter
    -> io.dust.DustOptics / write_simple_dust / HG dsc tables
  * a GSETDust grain model (sizes, per-size Q, enthalpies E(T) from the
    integrated heat capacity) for the stochastic-heating chain
    -> solver_prep.build_solver

Size-distribution types: 'plaw' power law with optional '-ed' exponential
decay and '-cv' curvature terms, and 'logn' log-normal (DustEM manual;
DustLib.py:1068-1160). Normalization: total dust mass = rmass * m_H per H.
"""

from dataclasses import dataclass

import numpy as np

from .constants import AMU, um2f
from .dust_io import DustOptics
from .grain_model import GSETDust

M_H = 1.0079 * AMU


@dataclass
class DustemDust:
    name: str
    rho: float                  # bulk density [g/cm3]
    size_a: np.ndarray          # [NSIZE] cm
    sfrac: np.ndarray           # grains per H in each size bin
    qfreq: np.ndarray           # [QNFREQ] Hz (increasing)
    qsize: np.ndarray           # [QNSIZE] cm
    qabs: np.ndarray            # [QNSIZE, QNFREQ]
    qsca: np.ndarray            # [QNSIZE, QNFREQ]
    g: np.ndarray               # [QNSIZE, QNFREQ]
    c_temp: np.ndarray = None   # [CNT] K
    c_size: np.ndarray = None   # [CNSIZE] cm
    c_cap: np.ndarray = None    # [CNT, CNSIZE] heat capacity erg/K/cm3

    @property
    def nsize(self):
        return len(self.size_a)


def _skip_comments(lines):
    for i, ln in enumerate(lines):
        if not ln.startswith("#") and ln.strip():
            return i
    return len(lines)


def read_lambda(path):
    """LAMBDA.DAT: wavelengths [um] after 4 header rows -> freq [Hz]
    (decreasing, matching the increasing-wavelength tables)."""
    um = np.loadtxt(path, skiprows=4)
    return um2f(um)


def read_q(path, nfreq):
    """Q_*.DAT: nsize, sizes [um], then NFREQ rows Qabs + NFREQ rows Qsca
    (rows = wavelengths, columns = sizes)."""
    lines = open(path).readlines()
    i = _skip_comments(lines)
    qnsize = int(lines[i].split()[0])
    qsize = np.asarray([float(x) for x in lines[i + 1].split()[:qnsize]])
    x = np.loadtxt(path, skiprows=i + 3)
    qabs = x[:nfreq].T          # -> [QNSIZE, NFREQ]
    qsca = x[nfreq: 2 * nfreq].T
    assert qabs.shape == (qnsize, nfreq), (qabs.shape, qnsize, nfreq)
    return qsize * 1.0e-4, qabs, qsca


def read_g(path, nfreq, skiprows=9):
    """G_*.DAT: g values, rows = wavelengths, columns = sizes."""
    g = np.loadtxt(path, skiprows=skiprows)
    return g[:nfreq].T


def read_c(path):
    """C_*.DAT: nsize, sizes [um], nT, then rows [log T, log C(size)...]."""
    lines = open(path).readlines()
    i = _skip_comments(lines)
    cnsize = int(lines[i].split()[0])
    csize = np.asarray([float(x) for x in lines[i + 1].split()[:cnsize]])
    cnt = int(lines[i + 2].split()[0])
    d = np.loadtxt(path, skiprows=i + 3)
    lgt = d[:, 0]
    lgc = d[:, 1:]
    assert lgc.shape == (cnt, cnsize)
    return (10.0 ** lgt, csize * 1.0e-4,
            10.0 ** np.clip(lgc, 0.0, 21.0))


def size_distribution(typ, amin, amax, params, nsize):
    """dn/da (unnormalized) on a log size grid (DustEM 'plaw[-ed][-cv]' and
    'logn' laws)."""
    a = np.logspace(np.log10(amin), np.log10(amax), nsize)
    typ = typ.lower()
    p = list(params)
    if typ.startswith("logn"):
        a0, sigma = p[0], p[1]
        # exp(-0.5 x^2): the 0.5 "was missing from the documentation"
        # (DustLib.py:1108) but IS in the implementation
        dnda = np.exp(-0.5 * (np.log(a / a0) / sigma) ** 2) / a
    elif typ.startswith("plaw"):
        alpha = p[0]
        dnda = a ** alpha
        k = 1
        if "-ed" in typ:
            at, ac, gamma = p[k], p[k + 1], p[k + 2]
            k += 3
            dnda = dnda * np.where(a <= at, 1.0,
                                   np.exp(-(((a - at) / ac) ** gamma)))
        if "-cv" in typ:
            au, z, eta = p[k], p[k + 1], p[k + 2]
            dnda = dnda * (1.0 + np.abs(z) * (a / au) ** eta) ** np.sign(z)
    elif typ.startswith("size"):
        # tabulated dn/da from a SIZE_<name>.DAT file (DustLib.py:149-163):
        # two columns, a [um] and dn/da/H; interpolated onto the log grid
        if not params or not isinstance(params[-1], str):
            raise ValueError("'size' distribution needs the SIZE file path")
        tab = np.loadtxt(params[-1])
        ta = np.asarray(tab[:, 0], np.float64) * 1.0e-4      # um -> cm
        tf = np.asarray(tab[:, 1], np.float64)
        dnda = np.exp(np.interp(np.log(a), np.log(ta),
                                np.log(np.maximum(tf, 1e-300))))
    else:
        raise ValueError(f"unsupported size-distribution type {typ!r}")
    return a, dnda


def apply_mix(a, sfrac, mix_path):
    """Multiply per-size grain counts by the MIX_<name>.DAT factors
    (DustLib.py:1186-1220): factors given on logspace(amin, amax, len(mix)),
    log-size interpolated onto our grid, applied AFTER normalization."""
    mix = np.ravel(np.loadtxt(mix_path))
    x = np.logspace(np.log10(a[0]), np.log10(a[-1]), len(mix))
    fac = np.interp(np.log(a), np.log(x), mix, left=1.0, right=1.0)
    return sfrac * fac


def parse_grain_line(line, nsize=None, size_path=None, mix_path=None):
    """One GRAIN.DAT row -> (name, normalized size grid + per-bin grain
    counts). Columns: name, nsize, type, Mdust/MH, rho, amin, amax, params
    (DustLib.py:1050-1066). Types: plaw[-ed][-cv], logn, size (tabulated
    dn/da from size_path); a '-mix' suffix applies MIX factors from
    mix_path after the mass normalization."""
    s = line.split()
    name = s[0]
    nsize_file = int(s[1])
    typ = s[2]
    rmass = float(s[3])
    rho = float(s[4])
    amin, amax = float(s[5]), float(s[6])
    params = [float(x) for x in s[7:]]
    n = nsize or nsize_file
    if typ.lower().startswith("size"):
        params = params + [size_path]
    a, dnda = size_distribution(typ, amin, amax, params, n)
    dln = np.log(a[1] / a[0]) if n > 1 else 1.0
    sfrac = dnda * a * dln                  # grains per H (unnormalized)
    mass = np.sum(sfrac * (4.0 * np.pi / 3.0) * a**3 * rho)
    sfrac = sfrac * (M_H * rmass / mass)    # dust mass = rmass * m_H
    if "mix" in typ.lower():
        if not mix_path:
            raise ValueError("'-mix' distribution needs the MIX file path")
        sfrac = apply_mix(a, sfrac, mix_path)
    return name, rho, a, sfrac


def compile_dust(grain_line, lambda_path, q_path, g_path, c_path=None,
                 nsize=None, g_skiprows=9, size_path=None, mix_path=None):
    """Full DustEM -> DustemDust compilation for one species."""
    name, rho, a, sfrac = parse_grain_line(grain_line, nsize,
                                           size_path=size_path,
                                           mix_path=mix_path)
    qfreq_dec = read_lambda(lambda_path)     # decreasing with row index
    nfreq = len(qfreq_dec)
    qsize, qabs, qsca = read_q(q_path, nfreq)
    g = read_g(g_path, nfreq, skiprows=g_skiprows)
    # re-sort everything to increasing frequency
    order = np.argsort(qfreq_dec)
    dust = DustemDust(name=name, rho=rho, size_a=a, sfrac=sfrac,
                      qfreq=qfreq_dec[order], qsize=qsize,
                      qabs=qabs[:, order], qsca=qsca[:, order],
                      g=g[:, order])
    if c_path:
        dust.c_temp, dust.c_size, dust.c_cap = read_c(c_path)
    return dust


def _q_on_sizes(q, qsize, sizes):
    """Interpolate a Q table from the optical-data sizes onto the
    size-distribution grid (Q before the a^2 scaling, DustLib convention)."""
    out = np.zeros((len(sizes), q.shape[1]))
    for f in range(q.shape[1]):
        out[:, f] = np.interp(sizes, qsize, q[:, f])
    return out


def effective_optics(dust, freq, gl_pc):
    """Sum the size distribution into single-population optics on `freq`.

    Returns a DustOptics with abs_gl/sca_gl in tau / unit density / GL and
    the scattering-cross-section-weighted asymmetry parameter.
    """
    from .constants import PARSEC
    qabs = _q_on_sizes(dust.qabs, dust.qsize, dust.size_a)
    qsca = _q_on_sizes(dust.qsca, dust.qsize, dust.size_a)
    gtab = _q_on_sizes(dust.g, dust.qsize, dust.size_a)
    area = np.pi * dust.size_a**2
    w = dust.sfrac[:, None] * area[:, None]
    kabs_q = (w * qabs).sum(axis=0)          # cm^2 / H on dust.qfreq
    ksca_q = (w * qsca).sum(axis=0)
    g_q = (w * qsca * gtab).sum(axis=0) / np.maximum(ksca_q, 1e-300)
    kabs = np.interp(freq, dust.qfreq, kabs_q)
    ksca = np.interp(freq, dust.qfreq, ksca_q)
    g_eff = np.interp(freq, dust.qfreq, g_q)
    gl_cm = gl_pc * PARSEC
    return DustOptics(freq=np.asarray(freq, np.float64),
                      g=g_eff.astype(np.float32),
                      abs_gl=(kabs * gl_cm).astype(np.float32),
                      sca_gl=(ksca * gl_cm).astype(np.float32),
                      grain_density=1.0, grain_size=np.sqrt(1.0 / np.pi))


def to_gset(dust, tmin=3.0, tmax=2000.0):
    """DustemDust -> GSETDust for the stochastic-heating chain.

    Enthalpy per grain E(T) = (4 pi/3) a^3 * integral_0^T C(T') dT' from the
    volumetric heat capacities (write_A2E_dustfiles semantics).
    """
    if dust.c_cap is None:
        raise ValueError("no heat-capacity data (C_*.DAT) was compiled")
    ct, csz, cc = dust.c_temp, dust.c_size, dust.c_cap
    # cumulative integral of C over T per tabulated size
    e_per_vol = np.zeros_like(cc)
    for i in range(cc.shape[1]):
        e_per_vol[:, i] = np.concatenate(
            [[0.0], np.cumsum(0.5 * (cc[1:, i] + cc[:-1, i]) * np.diff(ct))])
    e_per_vol = np.maximum(e_per_vol, 1e-300)
    c_e = (e_per_vol.T * (4.0 * np.pi / 3.0) * csz[:, None] ** 3)
    sfrac = dust.sfrac / dust.sfrac.sum()
    return GSETDust(
        grain_density=float(dust.sfrac.sum()),
        size_a=dust.size_a, s_frac=sfrac,
        tmin=np.full(dust.nsize, tmin), tmax=np.full(dust.nsize, tmax),
        qsize=dust.qsize, qfreq=dust.qfreq,
        qabs=dust.qabs, qsca=dust.qsca, g=dust.g,
        c_size=csz, c_temp=ct, c_e=c_e)


def _hg(g, mu):
    """Henyey-Greenstein pdf per unit solid angle at cos(theta)=mu."""
    g = np.asarray(g, np.float64)[..., None]
    return (1.0 - g * g) / (4.0 * np.pi
                            * (1.0 + g * g - 2.0 * g * mu) ** 1.5)


def tabulated_scattering_function(dust, freq, bins=2500):
    """Size-weighted tabulated phase function (DustLib DSF/DSF2 role).

    The per-frequency phase function is the Ksca(a)-weighted MIXTURE of
    HG(g(a)) over the size distribution -- genuinely non-HG in shape
    (broader wings than HG at the effective <g>), unlike the effective-g
    fallback. Returns (DSC[NFREQ, BINS] pdf over a uniform cos-theta grid,
    CSC[NFREQ, BINS] inverse-CDF lookup), the *.dsc table pair
    (combined_scattering_function* + SFlookupCT_CRT, DustLib.py:1358-1601).
    """
    freq = np.asarray(freq, np.float64)
    nf = len(freq)
    mu = np.linspace(-1.0 + 1.0 / bins, 1.0 - 1.0 / bins, bins)
    u = (np.arange(bins) + 0.5) / bins
    qsca = _q_on_sizes(dust.qsca, dust.qsize, dust.size_a)
    gtab = _q_on_sizes(dust.g, dust.qsize, dust.size_a)
    area = np.pi * dust.size_a ** 2
    dsc = np.zeros((nf, bins), np.float32)
    csc = np.zeros((nf, bins), np.float32)
    for i, f in enumerate(freq):
        w = dust.sfrac * area * np.asarray(
            [np.interp(f, dust.qfreq, qsca[k]) for k in range(dust.nsize)])
        g = np.asarray(
            [np.interp(f, dust.qfreq, gtab[k]) for k in range(dust.nsize)])
        pdf = (w[:, None] * _hg(g, mu)).sum(axis=0) / max(w.sum(), 1e-300)
        dsc[i] = pdf
        cdf = np.cumsum(pdf)
        cdf = cdf / cdf[-1]
        csc[i] = np.interp(u, cdf, mu)
    return dsc, csc


def write_scattering_file(path, dsc, csc):
    """Write the reference *.dsc container: float32 DSC then CSC
    (ASOC_aux.py:639-647)."""
    with open(path, "wb") as fp:
        np.asarray(dsc, np.float32).tofile(fp)
        np.asarray(csc, np.float32).tofile(fp)


# --------------------------------------------------------------------------
# whole-model compilation (the DE_to_GSET.jl / write_DUSTEM_files workflow)

