"""The A2E emission of a sample of cells, drawn from the seed, against the
reference's solve of the same cells' absorptions (the program's
absorbed.data rows: the stage's input, itself held to the reference by
the absorbed check)."""

import os

import torch

from ..reference.a2e import Solver
from .common import leaf_sample, model, spectrum_gap

NUMBERS = ("a2e.emission",)


def solver(ctx, **kw):
    optics = model(ctx)[1]
    ne = int(ctx["ini"].get("nenumber", ctx["model"]["ne"]))
    return Solver(os.path.join(ctx["workdir"], ctx["ini"]["optical"]),
                  optics.freq, ne, ctx["device"], **kw)


def run(ctx, dtype=None):
    """{"a2e.emission": gap}; ``dtype`` computes the program's side as the
    reference's solve in that precision (the control)."""
    cloud, optics, _ = model(ctx)
    cells = leaf_sample(ctx, cloud, int(ctx["cfile"]["a2e_cells"]), 2)
    rows = ctx["products"]["absorbed"][cells]
    ref = solver(ctx).emission(rows)
    prog = ctx["products"]["emitted"][cells] if dtype is None else \
        solver(ctx, dtype=dtype).emission(rows)
    return {"a2e.emission": spectrum_gap(prog, ref, optics.freq)}


def control(ctx):
    return run(ctx, dtype=torch.bfloat16)
