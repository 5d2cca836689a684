"""The external star's pass: the program's absorbed energy a cell from
it (the pass's own TABS) against the reference's isotropic star, summed
per level, per depth layer under the lit face, per child slot of each
level's refined parents (each child's whole subtree: light from +z makes
the upper slots differ from the lower), per ring about the star's axis
in each layer (the radial profile that on-axis light gives the slab) and
per column of the face (where across the slab the deposits land: a
descent that sends them to the wrong root cell at the right depth moves
a column's sum at first order, a ring's only at second, since the
profile is round), each relative to the reference's total but the slots,
which are relative to their level's."""

import torch

from ._slab import energy, geometry, group_gap, level_slot_gap, \
    reference_star
from .common import model

NUMBERS = ("point.levels", "point.layers", "point.slots", "point.rings",
           "point.columns")


def compare(ctx, prog, ref):
    """The numbers of two [CELLS] energies."""
    g = geometry(ctx)
    tot = ref.sum()
    leaf_layer = g["layer"].copy()
    leaf_layer[~g["leaf"]] = -1
    return {"point.levels": group_gap(g["level"], prog, ref, tot),
            "point.layers": group_gap(leaf_layer, prog, ref, tot),
            "point.slots": level_slot_gap(ctx, prog, ref),
            "point.rings": group_gap(g["ring"], prog, ref, tot),
            "point.columns": group_gap(g["column"], prog, ref, tot)}


def reference(ctx):
    """The reference's energy a cell from the star; cached in ctx."""
    if "ref_star" not in ctx:
        ctx["ref_star"] = energy(ctx, reference_star(ctx))
    return ctx["ref_star"]


def run(ctx):
    prog = ctx["products"]["ps_tabs"]
    return compare(ctx, prog, reference(ctx))


def control(ctx):
    """The reference's star at the program's packets a channel (its
    isotropic draws scaled by the share that meets the model), with
    bfloat16 weights and tallies, against the float64 reference."""
    from ..reference.star import position, visible_fraction
    tree = model(ctx)[2]
    share = visible_fraction(tree, position(ctx["ini"]))
    n = int(round(int(ctx["ini"]["pspackets"]) / share))
    low = energy(ctx, reference_star(ctx, n, wdtype=torch.bfloat16,
                                     tdtype=torch.bfloat16))
    return compare(ctx, low, reference(ctx))
