"""The final temperatures: the mean over the leaves of each level and
depth layer of the program's temperatures against the reference's solve
of the program's own heating (the external star's TABS and the cell
pass's, divided by ALI's escape probability beta = clip((XEM - XAB) /
XEM, 1e-2, 1) of the cell pass's self-absorbed energy XAB and emitted
energy XEM of the emission it was fed), each relative to the reference's
mean."""

import numpy as np

from ..frozen.constants import FACTOR, PARSEC, PLANCK
from ..reference import temperature as rt
from ._slab import cell_pass, energy, geometry, host
from .common import bf16, model

NUMBERS = ("temperature.groups",)


def escape(ctx, emit, xab):
    """ALI's beta a cell of the emission fed and its XAB energy."""
    xem = energy(ctx, emit)
    beta = np.clip((xem - xab) / np.maximum(xem, 1e-30), 1e-2, 1.0)
    beta[xem <= 0] = 1.0
    return beta


def solve(ctx, heating, beta, low=None):
    """[CELLS] temperatures of TABS energies ``heating`` (0 on parents,
    which the group means leave out)."""
    cloud, optics, _ = model(ctx)
    gl = float(ctx["ini"]["gridlength"])
    leaf = cloud.dens > 0
    ein = np.zeros(cloud.cells)
    ein[leaf] = (PLANCK * FACTOR / (gl * PARSEC) * heating[leaf]
                 * 8.0 ** cloud.level[leaf] / cloud.dens[leaf] / beta[leaf])
    t = np.zeros(cloud.cells)
    t[leaf] = rt.of_energy(optics.freq, optics.abs_gl, gl,
                           ein[leaf] if low is None else low(ein[leaf]), low)
    return t


def compare(ctx, t_prog, t_ref):
    g = geometry(ctx)
    key = np.where(g["leaf"], g["level"] * (int(g["layer"].max()) + 1)
                   + g["layer"], -1)
    m = key >= 0
    _, grp = np.unique(key[m], return_inverse=True)
    n = np.bincount(grp)
    mp = np.bincount(grp, t_prog[m]) / n
    mr = np.bincount(grp, t_ref[m]) / n
    return {"temperature.groups": float(np.max(np.abs(mp - mr) / mr))}


def reference(ctx, low=None):
    p = cell_pass(ctx)
    heating = host(ctx["products"]["ps_tabs"]) + p["tabs"]
    return solve(ctx, heating, escape(ctx, p["emit"], p["xab"]), low)


def run(ctx):
    return compare(ctx, host(ctx["products"]["temperature"]),
                   reference(ctx))


def control(ctx):
    """The reference's solve with its energies and table rounded to
    bfloat16."""
    return compare(ctx, reference(ctx, low=bf16), reference(ctx))
