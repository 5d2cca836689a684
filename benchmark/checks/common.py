"""What the checks share: the model as the reference reads it, the
samples drawn from the run's seed, the relative gaps, and the control's
rounding to bfloat16.

A check module names the numbers it gives (NUMBERS), computes them for a
run of the window (run(ctx), ctx["products"] the program's outputs) and
for the control (control(ctx), ctx["products"] the reference's own
outputs and ctx["reference_raw"] its background tally, the program's side
computed as the reference in bfloat16; benchmark/control.py)."""

import os

import numpy as np
import torch

from ..frozen.constants import FACTOR, PARSEC
from ..reference.inputs import device_tree, load_cloud, load_optics


def model(ctx):
    """(cloud, optics, tree) of the run's model files; cached in ctx."""
    if "cloud" not in ctx:
        ini = ctx["ini"]
        ctx["cloud"] = load_cloud(os.path.join(ctx["workdir"], ini["cloud"]),
                                  float(ini["density"]))
        ctx["optics"] = load_optics(ctx["workdir"], ini)
        ctx["tree"] = device_tree(ctx["cloud"], ctx["device"])
    return ctx["cloud"], ctx["optics"], ctx["tree"]


def rng(ctx, salt):
    """A generator of the run's seed, the window's run and a salt."""
    return np.random.default_rng([int(ctx["seed"]) % (1 << 63),
                                  int(ctx["run"]), salt])


def stream_seed(ctx, salt):
    return int(rng(ctx, salt).integers(0, 1 << 62))


def leaf_sample(ctx, cloud, n, salt):
    """n leaf cells drawn from the seed (all of them when fewer)."""
    leaves = np.nonzero(cloud.dens > 0)[0]
    if n >= len(leaves):
        return leaves
    return np.sort(rng(ctx, salt).choice(leaves, n, replace=False))


def payload(cloud, raw, gl):
    """Photons absorbed a cell [CELLS, NF] as absorbed.data's payload."""
    coeff = (8.0 ** cloud.level) * (FACTOR / (gl * PARSEC))
    return np.where(cloud.dens[:, None] > 0, raw * coeff[:, None]
                    / np.maximum(cloud.dens, 1e-300)[:, None], 0.0)


def bf16(x):
    """x rounded to bfloat16, as float64."""
    return torch.as_tensor(np.asarray(x, np.float64)).to(
        torch.bfloat16).to(torch.float64).numpy()


def spectrum_gap(prog, ref, freq):
    """Largest gap between two [N, NF] spectra, in nu F_nu, relative to
    each row's peak of the reference's nu F_nu."""
    nu = np.asarray(freq, np.float64)[None, :]
    d = np.abs(np.asarray(prog, np.float64) - ref) * nu
    peak = np.max(np.abs(ref) * nu, 1)
    return float(np.max(np.max(d, 1) / np.maximum(peak, 1e-300)))
