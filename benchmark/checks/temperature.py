"""Equilibrium temperatures and their emission for a sample of cells,
drawn from the seed, against the reference's solve of the same cells'
absorptions (the program's absorbed.data rows)."""

import numpy as np

from ..reference import temperature as rt
from .common import bf16, leaf_sample, model, spectrum_gap

NUMBERS = ("temperature", "emitted")


def run(ctx, low=None):
    """{"temperature": gap, "emitted": gap}; ``low``, a function rounding
    to a lower precision, computes the program's side as the reference
    with its energies and emission so rounded (the control)."""
    cloud, optics, _ = model(ctx)
    gl = float(ctx["ini"]["gridlength"])
    cells = leaf_sample(ctx, cloud, int(ctx["cfile"]["temperature_cells"]),
                        3)
    p = ctx["products"]
    t_ref = rt.temperatures(optics.freq, optics.abs_gl, gl,
                            p["absorbed"][cells])
    e_ref = rt.emission(optics.freq, optics.abs_gl, gl, t_ref)
    if low is None:
        t_prog = np.asarray(p["temperature"], np.float64)[cells]
        e_prog = p["emitted"][cells]
    else:
        t_prog = rt.temperatures(optics.freq, optics.abs_gl, gl,
                                 p["absorbed"][cells], low=low)
        e_prog = low(rt.emission(optics.freq, optics.abs_gl, gl, t_ref))
    return {"temperature": float(np.max(np.abs(t_prog - t_ref) / t_ref)),
            "emitted": spectrum_gap(e_prog, e_ref, optics.freq)}


def control(ctx):
    return run(ctx, low=bf16)
