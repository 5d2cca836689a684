"""What chip_smoke.py phase 13's gates read on BASELINE config 2's octree:
the step and direction weighting's temperatures against the plain run,
seed to seed and with a planted fault, and the background's cost of the
ROI save and of `mmapabs`.

    python -m soc_tpu_torch.profile_phase13            # on a CUDA device

The model is phase 13's: example_model's octree (a 64^3 root with its
central 8^3 block refined and a 64-cell cascade below, 266,752 cells), the
equilibrium dust at 44 channels, bgpackets 999999, no cell packets,
written into ``_profile_work/`` beside the package and removed afterwards.
`rt` runs (driver.run), in this order:

- the cost split, each configuration twice in the order P R M4 M1 M1 M4 R
  P: P plain, R with `roi 8 15 8 15 8 15`, `roisave` and `roinside 8` in
  memory, M4 that with `mmapabs` in four device blocks of 11 channels
  (SOC_TPU_TALLY_BYTES), M1 with `mmapabs` in one block; the background's
  seconds (the constant-source stage) of each run and each
  configuration's mean;
- the spread: plain at seed 0.5, and phase 13 (c1)'s weighted run
  (`stepweight 2 1.3 0.4`, `direweight 1 0.5`, `split 4`) at seeds 1.0
  and 0.5;
- the planted faults, at seed 1.0: (c1) with the free-path weight of a
  scattering's service dropped (the birth's kept), and (c1) with
  `direweight`'s p_DSC / p_HG dropped; the transport's own methods are
  wrapped for these runs only.

Then for pairs of runs the readings phase 13 (c1) gates on (weight_readings):
each lit channel's absorption over the leaf cells, the leaf cells' mean
|relative temperature difference|, each level's signed mean, and the
share of leaf cells beyond 5%. Plain at 0.5 against plain at 1.0 and
(c1) at 0.5 against (c1) at 1.0 are the seed-to-seed spread; (c1) at 1.0
against plain at 1.0 is phase 13's own pair. Every timing line carries the
card's name and power limit.
"""

import contextlib
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
from .transport import propagate

OCTREE = (8, 64, 3)
OCTREE_CELLS = 266752
ROI = "roi 8 15 8 15 8 15\nroisave roi.bin 1\nroinside 8\n"
MMAP_BLOCK = 11
WEIGHTED = "stepweight 2 1.3 0.4\ndireweight 1 0.5\nsplit 4\n"
COST_ORDER = ("P", "R", "M4", "M1", "M1", "M4", "R", "P")
SPREAD = {"plain@0.5": ("", "0.5", None), "c1@1.0": (WEIGHTED, "1.0", None),
          "c1@0.5": (WEIGHTED, "0.5", None),
          "fault:service-weight": (WEIGHTED, "1.0", "service_weight"),
          "fault:dsc-ratio": (WEIGHTED, "1.0", "dsc_ratio")}
PAIRS = (("plain@0.5", "P"), ("c1@0.5", "c1@1.0"), ("c1@1.0", "P"),
         ("c1@0.5", "P"), ("fault:service-weight", "P"),
         ("fault:dsc-ratio", "P"))


def weight_readings(t, ref, absorbed, absorbed_ref, leaf, lev, lit,
                    rtol=0.05):
    """Phase 13 (c1)'s readings of a run (temperatures t, absorbed file)
    against a reference run: dict of the largest |relative difference| of
    a lit channel's absorption over the leaf cells (``channel``), the leaf
    cells' mean |relative temperature difference| (``mean_abs``), the
    largest |signed mean| of one level's leaf cells (``level_mean``, with
    each level's in ``levels``) and the share of leaf cells beyond rtol
    (``beyond``)."""
    rel = (np.asarray(t, np.float64) / ref - 1.0)
    wa = np.asarray(absorbed, np.float64)[leaf].sum(0)
    aa = np.asarray(absorbed_ref, np.float64)[leaf].sum(0)
    levels = [float(rel[leaf & (lev == k)].mean())
              for k in range(int(lev.max()) + 1) if (leaf & (lev == k)).any()]
    r = rel[leaf]
    return dict(channel=float(np.abs(wa[lit] / aa[lit] - 1.0).max()),
                mean_abs=float(np.abs(r).mean()),
                level_mean=float(np.abs(levels).max()), levels=levels,
                beyond=float((np.abs(r) > rtol).mean()))


@contextlib.contextmanager
def planted(fault):
    """A fault in the weighting for the runs inside: ``service_weight``
    drops the free-path weight of a service (a scattering's next path),
    ``dsc_ratio`` the direction weight p_DSC / p_HG; None plants none."""
    kit = propagate.StepKit
    draw, service = kit.draw_fp_weighted, kit.service
    if fault == "service_weight":
        def quiet_draw(self, u):
            fp, w = draw(self, u)
            return fp, (None if getattr(self, "_serving", False) else w)

        def quiet_service(self, st):
            self._serving = True
            try:
                return service(self, st)
            finally:
                self._serving = False
        kit.draw_fp_weighted, kit.service = quiet_draw, quiet_service
    elif fault == "dsc_ratio":
        # p_DSC read as p_HG's own value at every bin: the ratio is 1
        def flat_service(self, st):
            dsc = self.physics["dsc"]
            a = self.dw_a
            nb = dsc.shape[-1]
            cos = (torch.arange(nb, device=dsc.device) + 0.5) / nb * 2 - 1
            self.physics["dsc"] = ((1.0 / (4.0 * np.pi)) * (1.0 - a * a)
                                   / (1.0 + a * a - 2.0 * a * cos) ** 1.5
                                   ).expand_as(dsc).contiguous()
            try:
                return service(self, st)
            finally:
                self.physics["dsc"] = dsc
        kit.service = flat_service
    try:
        yield
    finally:
        kit.draw_fp_weighted, kit.service = draw, service


def main():
    if not torch.cuda.is_available():
        print("profile_phase13: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print("card: %s (torch %s, CUDA %s)" % (card, torch.__version__,
                                            torch.version.cuda), flush=True)
    work = os.path.join(ROOT, "_profile_work")
    shutil.rmtree(work, ignore_errors=True)
    runs = {}

    def run(tag, extra, seed="1.0", budget=None, fault=None):
        d = os.path.join(work, tag.replace(":", "_").replace("@", "_"))
        shutil.rmtree(d, ignore_errors=True)
        ini = write_model(d, 64, kind="eqdust", nfreq=44, npix=64,
                          bgpac=999999, map_dx=1.0, octree=OCTREE,
                          extra=extra)
        with open(ini) as fp:
            text = fp.read()
        with open(ini, "w") as fp:
            fp.write(text.replace("seed            1.0",
                                  "seed            " + seed))
        if budget:
            os.environ["SOC_TPU_TALLY_BYTES"] = str(budget)
        try:
            with planted(fault):
                t0 = time.time()
                res = driver.run(ini, device=device)
                torch.cuda.synchronize()
        finally:
            os.environ.pop("SOC_TPU_TALLY_BYTES", None)
        st = res.source_passes[0]
        print("%s: %.2f s; background %.2f s in %d pool(s), %d packets "
              "(%.0f packets/s), %d clones [%s]"
              % (tag, time.time() - t0, res.timings["constant_sources"],
                 st["pools"], res.packets,
                 res.packets / res.timings["constant_sources"], st["clones"],
                 card), flush=True)
        return res

    try:
        cost = {}
        for tag in COST_ORDER:
            extra = {"P": "", "R": ROI, "M4": ROI + "mmapabs\n",
                     "M1": ROI + "mmapabs\n"}[tag]
            budget = OCTREE_CELLS * 4 * MMAP_BLOCK if tag == "M4" else None
            res = run(tag, extra, budget=budget)
            cost.setdefault(tag, []).append(
                res.timings["constant_sources"])
            if tag == "P" and tag not in runs:
                runs[tag] = res
        for tag in ("P", "R", "M4", "M1"):
            print("background %s: %s s, mean %.2f s (%+.2f s against P) "
                  "[%s]" % (tag, ", ".join("%.2f" % s for s in cost[tag]),
                            np.mean(cost[tag]),
                            np.mean(cost[tag]) - np.mean(cost["P"]), card),
                  flush=True)
        for tag, (extra, seed, fault) in SPREAD.items():
            runs[tag] = run(tag, extra, seed=seed, fault=fault)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    grid = runs["P"].grid
    leaf = grid.dens.cpu().numpy() > 0
    lev = equilibrium.cell_levels(grid).cpu().numpy()
    lit = runs["P"].launched > 0
    for a, b in PAIRS:
        r = weight_readings(runs[a].temperature, runs[b].temperature,
                            runs[a].absorbed, runs[b].absorbed, leaf, lev,
                            lit)
        print("%s against %s: channel absorption max |rel| %.4e; T: mean "
              "|rel| %.4e, level means %s (max |.| %.4e), beyond 5%% %.4e "
              "of %d leaf cells"
              % (a, b, r["channel"], r["mean_abs"],
                 ", ".join("%.3e" % m for m in r["levels"]),
                 r["level_mean"], r["beyond"], int(leaf.sum())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
