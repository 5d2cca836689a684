"""Synthetic input models for examples, tests and the GPU smoke run.

Writes a complete model directory from a few parameters: a uniform
density cloud, a dust built from DustEM-format files through soc_tpu's
NumPy dust compiler, its scattering function, an isotropic background and
an ini file. Two dust kinds:

* ``"gset"``: a stochastically heated dust (GSET container), run through
  the ``pipeline`` verb (absorption run -> A2E -> map);
* ``"eqdust"``: the same grains as one equilibrium (simple) dust, run
  through the ``rt`` verb.

The dust follows the power-law grain model of a DustEM GRAIN.DAT line with
a Debye-like heat capacity; the background is a diluted 7500 K black body.
"""

import os

import numpy as np

from soc_tpu.constants import FACTOR, PLANCK, planck_intensity, um2f
from soc_tpu.io.dust import write_simple_dust
from soc_tpu.solve import dust_compiler as dc
from soc_tpu.solve import solver_prep
from soc_tpu.solve.grain_model import write_gset_dust

from .io.cloud import write_hierarchy

GRAIN_LINE = "TST {nsize} plaw-ed 0.0065 3.3 1.0e-7 5.0e-5 -3.5 1.0e-5 5e-6 3.0"

INI = """\
gridlength      {gl}
cloud           tmp.cloud
mapping         {npix} {npix} {map_dx}
density         3.0e4
seed            1.0
directions      0.0 0.0
optical         {dust}
dsc             tmp.dsc 2500
background      bg.bin
bgpackets       {bgpac}
iterations      1
prefix          tmp
absorbed        absorbed.data
emitted         emitted.data
temperature     tmp.T
{extra}"""


def _dustem_files(d, um):
    """Synthetic DustEM inputs (LAMBDA, Q, G, C files) in directory d."""
    nlam = len(um)
    lam = os.path.join(d, "LAMBDA.DAT")
    with open(lam, "w") as fp:
        fp.write("# lambda\n#\n#\n#\n"
                 + "\n".join("%.6e" % u for u in um) + "\n")
    qsize_um = np.asarray([1e-3, 1e-2, 0.1, 1.0])
    # geometric-optics-flavoured Qabs: Q = x/(1+x) with x = 2 pi a/lambda
    qabs = np.zeros((nlam, 4))
    for j, su in enumerate(qsize_um):
        x = 2 * np.pi * su / um
        qabs[:, j] = x / (1.0 + x)
    qsca = 0.5 * qabs
    qtxt = ["# synthetic Q", "#", "4",
            " ".join("%.4e" % s for s in qsize_um), "# Qabs then Qsca"]
    qtxt += [" ".join("%.6e" % v for v in row) for row in qabs]
    qtxt += [" ".join("%.6e" % v for v in row) for row in qsca]
    qf = os.path.join(d, "Q_TST.DAT")
    with open(qf, "w") as fp:
        fp.write("\n".join(qtxt) + "\n")
    gtxt = ["#"] * 9 + [" ".join("%.4f" % v for v in row)
                        for row in np.full((nlam, 4), 0.4)]
    gf = os.path.join(d, "G_TST.DAT")
    with open(gf, "w") as fp:
        fp.write("\n".join(gtxt) + "\n")
    # heat capacities: Debye-like C ~ T^3 per cm3
    ct = np.logspace(0, 3.3, 40)
    lgc = np.log10(1e4 * ct**3)
    ctxt = ["# synthetic C", "4", " ".join("%.4e" % s for s in qsize_um),
            "40"]
    ctxt += ["%.6e " % np.log10(t) + " ".join("%.6e" % lgc[i]
                                              for _ in range(4))
             for i, t in enumerate(ct)]
    cf = os.path.join(d, "C_TST.DAT")
    with open(cf, "w") as fp:
        fp.write("\n".join(ctxt) + "\n")
    return lam, qf, gf, cf


def frequencies(nfreq):
    """The models' frequency grid [Hz]: nfreq log-spaced over 0.1-3000 um,
    ascending in frequency."""
    return np.sort(um2f(np.logspace(np.log10(0.1), np.log10(3000.0), nfreq)))


def background(freq):
    """Isotropic background intensity: a diluted 7500 K black body."""
    return 1.0e-14 * planck_intensity(freq, 7500.0)


def _compiled_dust(d, nfreq, nsize):
    um = np.logspace(np.log10(0.1), np.log10(3000.0), nfreq)
    lam, qf, gf, cf = _dustem_files(d, um)
    return dc.compile_dust(GRAIN_LINE.format(nsize=nsize), lam, qf, gf, cf)


def gset_solver(d, nfreq=44, nsize=24, ne=128):
    """(A2E solver data, frequencies) of the models' GSET dust; the DustEM
    files are written into directory d."""
    freq = frequencies(nfreq)
    gset = dc.to_gset(_compiled_dust(d, nfreq, nsize))
    return solver_prep.build_solver(gset, freq, ne=ne), freq


def synthetic_absorbed(rng, solver, freq, cells):
    """[cells, NFREQ] absorbed photons per H like a background-heated
    cloud's: the optically thin rate FACTOR 4 pi I/(h nu) k_abs of the
    models' background, times a per-cell factor 10^U(-2, 1) and a per-cell
    reddening exp(-U(0, 3) (nu/nu_max)^0.5)."""
    base = FACTOR * 4 * np.pi * background(freq) / (PLANCK * freq) \
        * solver.k_abs
    scale = 10.0 ** rng.uniform(-2.0, 1.0, cells)
    tau = rng.uniform(0.0, 3.0, cells)[:, None] \
        * np.sqrt(freq / freq.max())[None, :]
    return (base[None, :] * scale[:, None] * np.exp(-tau)).astype(np.float32)


def negate_one_weight(solver, isize=0):
    """Flip the sign of one heating weight of size ``isize`` (the middle
    entry of its sparse stream), the kind of input that needs the A2E
    clamp path. Call before any A2E preparation: the per-size arrays are
    cached on the solver."""
    iw = solver.sizes[isize].iw
    k = len(iw) // 2
    iw[k] = -abs(iw[k]) if iw[k] != 0 else -1.0
    return solver


def with_negative_entries(rng, absorbed, share=0.2):
    """A copy of ``absorbed`` with a share of its entries times -0.3, as a
    reference-subtracted (delta) field has them."""
    out = np.array(absorbed, np.float32)
    out[rng.random(out.shape) < share] *= -0.3
    return out


def write_model(d, n, kind="gset", nfreq=44, nsize=24, npix=None,
                bgpac=None, map_dx=1.0, gl_pc=0.01, extra=""):
    """Write a model into directory d and return the ini path.

    n      : root grid size (n^3 cells, uniform density)
    kind   : "gset" (stochastic dust, for `pipeline`) or "eqdust" (`rt`)
    nfreq  : frequencies, log-spaced over 0.1-3000 um
    nsize  : grain sizes of the GSET dust
    npix   : map size (default n); bgpac: ini `bgpackets` (default
             8*6*n*n, one packet batch per surface element)
    extra  : more ini lines
    """
    os.makedirs(d, exist_ok=True)
    freq = frequencies(nfreq)
    dust = _compiled_dust(d, nfreq, nsize)
    dsc, csc = dc.tabulated_scattering_function(dust, freq, bins=2500)
    dc.write_scattering_file(os.path.join(d, "tmp.dsc"), dsc, csc)
    if kind == "gset":
        dust_name = "gs_TST.dust"
        write_gset_dust(os.path.join(d, dust_name), dc.to_gset(dust))
    elif kind == "eqdust":
        dust_name = "tst.dust"
        write_simple_dust(os.path.join(d, dust_name),
                          dc.effective_optics(dust, freq, gl_pc), gl_pc)
    else:
        raise ValueError("kind must be 'gset' or 'eqdust'")
    background(freq).astype(np.float32).tofile(os.path.join(d, "bg.bin"))
    write_hierarchy(os.path.join(d, "tmp.cloud"), n, n, n, [n ** 3],
                    [np.ones(n ** 3, np.float32)])
    ini = os.path.join(d, "run.ini")
    with open(ini, "w") as fp:
        fp.write(INI.format(gl=gl_pc, npix=npix or n, map_dx=map_dx,
                            dust=dust_name, bgpac=bgpac or 8 * 6 * n * n,
                            extra=extra))
    return ini
