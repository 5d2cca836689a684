"""How far `rt`'s phase-2 variants move the temperatures of BASELINE
config 2's octree, and what their cell passes cost.

    python -m soc_tpu_torch.profile_phase2              # on a CUDA device

The model is chip_smoke.py phase 10's: example_model's octree (a 64^3 root
with its central 8^3 block refined and a 64-cell cascade below, 266,752
cells), the equilibrium dust at 44 channels, bgpackets 999999,
`cellpackets` 533,504 (2 packets a cell a channel), written into
``_profile_work/`` beside the package and removed afterwards. Five `rt`
runs (driver.run): plain at iterations 3 and 4, `reference 1`, `ali 1`,
and `ali 1` with `reference 1`, all at iterations 3 unless said. Prints
each run's seconds and each cell pass's route, seconds and packets/s, then
for pairs of runs the relative temperature differences over the leaf
cells (max, mean, 50th/99th/99.9th percentiles, cells beyond 2%) and per
level (max, where, mean). Plain at 3 against plain at 4 is the scatter of
one scheme between two iterations: the Monte-Carlo noise floor the other
pairs are read against. Every timing line carries the card's name and
power limit.
"""

import os
import shutil
import sys
import time

import numpy as np
import torch

from .example_model import write_model
from .pipeline import driver
from .profile_transport import ROOT, card_line
from .solve import equilibrium

OCTREE = (8, 64, 3)
CELLPACKETS = 533504
RUNS = {"plain3": ("", 3), "plain4": ("", 4), "ref": ("reference 1\n", 3),
        "ali": ("ali 1\n", 3), "ali+ref": ("ali 1\nreference 1\n", 3)}
PAIRS = (("plain4", "plain3"), ("ref", "plain3"), ("ali", "plain3"),
         ("ali+ref", "plain3"), ("ali+ref", "plain4"))


def compare(t, ref, leaf, lev, dens):
    """Lines describing the relative differences of t against ref."""
    d = (t - ref) / ref
    a = np.abs(d[leaf])
    out = ["max |rel| %.4e, mean %.3e, p50 %.2e p99 %.2e p99.9 %.2e, "
           "cells beyond 2%%: %d of %d"
           % (a.max(), d[leaf].mean(), *np.percentile(a, [50, 99, 99.9]),
              int((a > 0.02).sum()), int(leaf.sum()))]
    for lvl in range(int(lev.max()) + 1):
        m = leaf & (lev == lvl)
        i = int(np.argmax(np.where(m, np.abs(d), -1.0)))
        out.append("  level %d: max |rel| %.4e at T %.3f K (density %.3e), "
                   "mean %.3e, beyond 2%%: %d"
                   % (lvl, abs(d[i]), ref[i], dens[i], d[m].mean(),
                      int((np.abs(d[m]) > 0.02).sum())))
    return out


def main():
    if not torch.cuda.is_available():
        print("profile_phase2: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print("card: %s (torch %s, CUDA %s)" % (card, torch.__version__,
                                            torch.version.cuda), flush=True)
    work = os.path.join(ROOT, "_profile_work")
    shutil.rmtree(work, ignore_errors=True)
    temps = {}
    try:
        for tag, (extra, iters) in RUNS.items():
            ini = write_model(os.path.join(work, tag), 64, kind="eqdust",
                              nfreq=44, npix=64, bgpac=999999, octree=OCTREE,
                              cellpackets=CELLPACKETS, iterations=iters,
                              extra=extra)
            t0 = time.time()
            res = driver.run(ini, device=device)
            torch.cuda.synchronize()
            print("%s: %.2f s; cell passes: %s [%s]" % (
                tag, time.time() - t0, ", ".join(
                    "%s %.2f s (%.0f packets/s)"
                    % (s["route"], s["seconds"],
                       s["packets"] / s["seconds"])
                    for s in res.cell_passes), card), flush=True)
            temps[tag] = res.temperature.astype(np.float64)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dens = res.grid.dens.cpu().numpy()
    lev = equilibrium.cell_levels(res.grid).cpu().numpy()
    for a, b in PAIRS:
        print("%s against %s: " % (a, b)
              + "\n".join(compare(temps[a], temps[b], dens > 0, lev, dens)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
