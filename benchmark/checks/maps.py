"""Both orthographic maps of the run (the ini's two directions): each a
sample of pixels, drawn from the seed, against the reference's
line-of-sight integral of the program's final emission, as
benchmark/checks/map.py judges one, with the map's centre (`mapcentre`,
root cells) and an oblique view: a ray whose spectrum moves by more than
GRAZE of its peak when the ray moves SHIFT pixels across runs along a
cell face and is not judged (an oblique ray through cells of unequal
emission moves by about SHIFT times the emission's contrast)."""

import math

import numpy as np
import torch

from ..reference.maps import observer_axes, pixel_spectra
from .common import model, rng

NUMBERS = ("map.dir0", "map.dir1")
GRAZE = 1e-3
SHIFT = 1e-6


def one(ctx, k, dtype=None):
    """The gap of direction k; ``dtype`` computes the program's side as
    the reference in that precision (the control)."""
    cloud, optics, tree = model(ctx)
    ini = ctx["ini"]
    nx, ny, dx = (float(v) for v in ini["mapping"][:3])
    d = [float(v) for v in ini["directions"]]
    theta, phi = math.radians(d[2 * k]), math.radians(d[2 * k + 1])
    # the centre's offset from the model's, in pixels along RA and DE
    _, ra, de = observer_axes(theta, phi)
    centre = np.asarray([float(v) for v in ini.get(
        "mapcentre", [0.5 * cloud.nx, 0.5 * cloud.ny, 0.5 * cloud.nz])])
    off = centre - 0.5 * np.asarray([cloud.nx, cloud.ny, cloud.nz], float)
    shift = np.asarray([off @ ra, off @ de]) / dx
    n = int(ctx["cfile"]["map_pixels"])
    g = rng(ctx, 4 + k)
    pix = np.stack([g.integers(0, int(nx), n), g.integers(0, int(ny), n)], 1)

    def spectra(p, dt=torch.float64):
        return pixel_spectra(tree, ctx["products"]["emitted"],
                             optics.abs_gl + optics.sca_gl, optics.freq,
                             float(ini["gridlength"]), theta, phi,
                             (int(nx), int(ny)), dx, p + shift[None, :],
                             ctx["device"], dt)
    ref = spectra(pix.astype(np.float64))
    peak = np.max(np.abs(ref), 1)
    judged = np.ones(n, bool)
    for o in ((SHIFT, 0.0), (-SHIFT, 0.0), (0.0, SHIFT), (0.0, -SHIFT)):
        moved = spectra(pix + np.asarray(o)[None, :])
        judged &= np.max(np.abs(moved - ref), 1) <= GRAZE * np.maximum(
            peak, 1e-300)
    if not judged.any():
        return float("inf")
    pix, ref, peak = pix[judged], ref[judged], peak[judged]
    if dtype is None:
        prog = np.asarray(ctx["products"]["maps"][k], np.float64)[
            :, pix[:, 1], pix[:, 0]].T
    else:
        prog = spectra(pix.astype(np.float64), dtype)
    gap = np.max(np.abs(prog - ref), 1)
    return float(np.max(np.where(peak > 0, gap / np.maximum(peak, 1e-300),
                                 np.where(gap > 0, np.inf, 0.0))))


def run(ctx):
    return {name: one(ctx, k) for k, name in enumerate(NUMBERS)}


def control(ctx):
    return {name: one(ctx, k, torch.bfloat16)
            for k, name in enumerate(NUMBERS)}
