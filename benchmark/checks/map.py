"""The orthographic map: a sample of pixels, drawn from the seed, against
the reference's line-of-sight integral of the program's emission (the
emission is the A2E or temperature check's to judge)."""

import numpy as np
import torch

from ..reference.maps import pixel_spectra
from .common import model, rng

NUMBERS = ("map",)
GRAZE = 1e-3


def run(ctx, dtype=None):
    """{"map": gap}; ``dtype`` computes the program's side as the
    reference in that precision (the control)."""
    cloud, optics, tree = model(ctx)
    ini = ctx["ini"]
    nx, ny, dx = ini["mapping"]
    theta, phi = (float(v) for v in ini["directions"])
    n = int(ctx["cfile"]["map_pixels"])
    g = rng(ctx, 4)
    pix = np.stack([g.integers(0, int(nx), n), g.integers(0, int(ny), n)], 1)

    def spectra(p, dt=torch.float64):
        return pixel_spectra(tree, ctx["products"]["emitted"],
                             optics.abs_gl + optics.sca_gl, optics.freq,
                             float(ini["gridlength"]), theta, phi,
                             (int(nx), int(ny)), float(dx), p,
                             ctx["device"], dt)
    ref = spectra(pix.astype(np.float64))
    # a ray that runs along a cell face (an octree's child faces meet the
    # pixel centres) has no well-defined point sample: a pixel whose
    # spectrum moves by more than GRAZE when its ray moves 1e-3 pixels
    # across is not judged
    peak = np.max(np.abs(ref), 1)
    judged = np.ones(n, bool)
    for off in ((1e-3, 0.0), (-1e-3, 0.0), (0.0, 1e-3), (0.0, -1e-3)):
        moved = spectra(pix + np.asarray(off)[None, :])
        judged &= np.max(np.abs(moved - ref), 1) <= GRAZE * np.maximum(
            peak, 1e-300)
    if not judged.any():
        return {"map": float("inf")}
    pix, ref, peak = pix[judged], ref[judged], peak[judged]
    if dtype is None:
        prog = np.asarray(ctx["products"]["map"], np.float64)[
            :, pix[:, 1], pix[:, 0]].T
    else:
        prog = spectra(pix.astype(np.float64), dtype)
    gap = np.max(np.abs(prog - ref), 1)
    return {"map": float(np.max(np.where(peak > 0, gap / np.maximum(
        peak, 1e-300), np.where(gap > 0, np.inf, 0.0))))}


def control(ctx):
    return run(ctx, dtype=torch.bfloat16)
