"""The ALI cell pass: from the emission the program fed its first cell
pass, the pass's absorbed energy a cell (its TABS, the emitting cell's
own deposits left out) summed per level, per depth layer, per ring about
the star's axis in each layer and per column of the face (checks/
_slab.py), relative to the reference's total, and the self-absorbed
energy (XAB) per level, relative to the reference's XAB total, against
the reference's march of the same emission."""

import torch

from ._slab import cell_pass, energy, geometry, group_gap, reference_cells

NUMBERS = ("cell.levels", "cell.layers", "cell.self", "cell.rings",
           "cell.columns")


def compare(ctx, tabs, xab, ref_tabs, ref_xab):
    g = geometry(ctx)
    layer = g["layer"].copy()
    layer[~g["leaf"]] = -1
    tot = ref_tabs.sum()
    return {"cell.levels": group_gap(g["level"], tabs, ref_tabs, tot),
            "cell.layers": group_gap(layer, tabs, ref_tabs, tot),
            "cell.self": group_gap(g["level"], xab, ref_xab,
                                   max(ref_xab.sum(), 1e-300)),
            "cell.rings": group_gap(g["ring"], tabs, ref_tabs, tot),
            "cell.columns": group_gap(g["column"], tabs, ref_tabs, tot)}


def reference(ctx, emit):
    """(absorbed, xab) energy a cell of the reference; cached in ctx."""
    if "ref_cells" not in ctx:
        ab, xab = reference_cells(ctx, emit)
        ctx["ref_cells"] = (energy(ctx, ab), energy(ctx, xab))
    return ctx["ref_cells"]


def run(ctx):
    p = cell_pass(ctx)
    return compare(ctx, p["tabs"], p["xab"], *reference(ctx, p["emit"]))


def control(ctx):
    """The reference's march at the program's packets (one a cell and
    channel), with bfloat16 weights and tallies."""
    p = cell_pass(ctx)
    ab, xab = reference_cells(ctx, p["emit"], 1, wdtype=torch.bfloat16,
                              tdtype=torch.bfloat16)
    return compare(ctx, energy(ctx, ab), energy(ctx, xab),
                   *reference(ctx, p["emit"]))
