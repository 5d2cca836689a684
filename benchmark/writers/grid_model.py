"""Model writer of the regular-grid configurations.

A frozen copy of soc_tpu_torch/example_model.py's writers (write_model
and the synthetic DustEM dust) at commit 6496b8b, with
soc_tpu_torch/bench.py prepare_workdir's soc_example file names
(my.ini, tmp.cloud, tmp.dust, tmp.dsc, bg_intensity.bin). The dust is the
port's synthetic DustEM-format grain model: a GSET container (gs_TST.dust)
for the `pipeline` verb, its one-population equilibrium twin (tmp.dust)
for `rt`. The model is the same for every seed: the seed draws the
packets.
"""

import os

import numpy as np

from ..frozen import dust_compiler as dc
from ..frozen.constants import planck_intensity, um2f
from ..frozen.dust_io import write_simple_dust
from ..frozen.grain_model import write_gset_dust

GRAIN_LINE = ("TST {nsize} plaw-ed 0.0065 3.3 1.0e-7 5.0e-5 -3.5 1.0e-5 "
              "5e-6 3.0")


def frequencies(nfreq, um_lo, um_hi):
    """nfreq log-spaced channels over [um_lo, um_hi] um, ascending in Hz."""
    return np.sort(um2f(np.logspace(np.log10(um_lo), np.log10(um_hi),
                                    nfreq)))


def background(freq):
    """Isotropic background intensity: a diluted 7500 K black body."""
    return 1.0e-14 * planck_intensity(freq, 7500.0)


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


def write_hierarchy(path, nx, ny, nz, lcells, values):
    """The hierarchy file: int32 [NX, NY, NZ, LEVELS, CELLS], then per
    level an int32 count and its float32 values."""
    lcells = np.asarray(lcells, np.int32)
    with open(path, "wb") as fp:
        np.asarray([nx, ny, nz, len(lcells), int(np.sum(lcells))],
                   np.int32).tofile(fp)
        for lvl, vals in enumerate(values):
            np.asarray([lcells[lvl]], np.int32).tofile(fp)
            np.asarray(vals, np.float32).tofile(fp)


def ini_text(lines):
    """Ini text of (keyword, value) pairs; a value of None writes the
    keyword alone."""
    out = []
    for key, val in lines:
        if val is None:
            out.append("%s\n" % key)
        elif isinstance(val, (list, tuple)):
            out.append("%-15s %s\n" % (key, " ".join(str(v) for v in val)))
        else:
            out.append("%-15s %s\n" % (key, val))
    return "".join(out)


def write(d, model, dust_kind, seed):
    """Write the model of ``model`` (a configuration's "model" object) into
    directory d with a dust of ``dust_kind`` ("gset" or "eqdust"); returns
    the model's ini lines as (keyword, value) pairs, without `seed`."""
    os.makedirs(d, exist_ok=True)
    nfreq = int(model["nfreq"])
    um_lo, um_hi = model["um_range"]
    gl = float(model["gridlength"])
    freq = frequencies(nfreq, um_lo, um_hi)
    um = np.logspace(np.log10(um_lo), np.log10(um_hi), nfreq)
    dust = dc.compile_dust(GRAIN_LINE.format(nsize=int(model["nsize"])),
                           *_dustem_files(d, um))
    bins = int(model["dsc_bins"])
    dsc, csc = dc.tabulated_scattering_function(dust, freq, bins=bins)
    dc.write_scattering_file(os.path.join(d, "tmp.dsc"), dsc, csc)
    if dust_kind == "gset":
        dust_name = "gs_TST.dust"
        write_gset_dust(os.path.join(d, dust_name), dc.to_gset(dust))
    elif dust_kind == "eqdust":
        dust_name = "tmp.dust"
        write_simple_dust(os.path.join(d, dust_name),
                          dc.effective_optics(dust, freq, gl), gl)
    else:
        raise ValueError("dust kind must be 'gset' or 'eqdust'")
    background(freq).astype(np.float32).tofile(
        os.path.join(d, "bg_intensity.bin"))
    n = int(model["root"])
    write_hierarchy(os.path.join(d, "tmp.cloud"), n, n, n, [n ** 3],
                    [np.ones(n ** 3, np.float32)])
    npix = model["mapping"]
    ne = [("nenumber", int(model["ne"]))] if dust_kind == "gset" else []
    return ne + [("gridlength", gl), ("cloud", "tmp.cloud"),
            ("mapping", npix), ("density", model["density"]),
            ("directions", model["directions"]), ("optical", dust_name),
            ("dsc", ["tmp.dsc", bins]), ("background", "bg_intensity.bin"),
            ("bgpackets", model["bgpackets"]), ("prefix", "tmp"),
            ("absorbed", "absorbed.data"), ("emitted", "emitted.data"),
            ("temperature", "tmp.T")]
