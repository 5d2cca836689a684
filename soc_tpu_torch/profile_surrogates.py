"""What chip_smoke.py phase 16's surrogate gates read on BASELINE config 5:
the emission library's and the NN surrogate's envelope against the full
solve, and what moves it.

    python -m soc_tpu_torch.profile_surrogates         # on a CUDA device

The model is phase 16's: example_model's octree (a 64^3 root with its
central 8^3 block refined and a 64-cell cascade below, 266,752 cells),
two GSET dusts with per-cell abundances, 44 channels, written into
``_profile_work/`` beside the package and removed afterwards. For a
quarter of `bgpackets` 999999 (phase 16's) and for all of them, the
`pipeline` verb's makelib mode runs once; then on its absorbed.data and
emitted.data:

- the library (build_library on every row, as soc_tpu's makelib bins
  them with the octree's zeroed parent rows, and on the leaves alone, as
  the port's makelib bins them), keyed on three reference triples:
  soc_tpu's default (0.55, 2.2, 25 um) and two of its sensitivity test's
  (tests/test_library.py:162-171); each axis's floor (log10 of the
  smallest absorption, -33 where a cell absorbed nothing), the share of
  leaf cells with no absorption in each reference channel, the occupancy;
- at a quarter of the packets, the NN surrogate as nnmake trains it
  (every 4th cell of each dust's share, nnnet 13 17 13, 400 epochs,
  batches of 4,096) with nnabs at the default triple and with 250 um
  added (soc_tpu's tests/test_pipeline_modes.py nnabs), solved as
  nnsolve solves it;

each envelope the median and 90th percentile of the relative difference
over the entries at >= 100 um above 1e-3 of their peak (the library's),
or over phase 16's 8 nnemit channels where the solve is positive (the
NN's). Every line carries the card's name and power limit.
"""

import os
import shutil
import sys
import time

import numpy as np
import torch

from . import cli
from .config import RunConfig
from .constants import f2um, um2f
from .example_model import write_model
from .io.fields import read_cell_frequency_array
from .pipeline import full, mabu
from .profile_transport import ROOT, card_line
from .solve import library, nn

OCTREE = (8, 64, 3)
TRIPLES = ((0.55, 2.2, 25.0), (0.35, 1.1, 50.0), (1.0, 5.0, 12.0))
NNABS = ((0.55, 2.2, 25.0), (0.55, 2.2, 25.0, 250.0))
NNEMIT = 8


def _nearest(freq, um):
    return [int(np.argmin(np.abs(freq - um2f(u)))) for u in um]


def _envelope(pred, truth):
    rel = np.abs(pred - truth) / truth
    return float(np.median(rel)), float(np.percentile(rel, 90))


def main():
    if not torch.cuda.is_available():
        print("profile_surrogates: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print("card: %s (torch %s, CUDA %s)" % (card, torch.__version__,
                                            torch.version.cuda), flush=True)
    work = os.path.join(ROOT, "_profile_work")
    shutil.rmtree(work, ignore_errors=True)
    cwd = os.getcwd()
    try:
        for bgpac in (999999 // 4, 999999):
            d = os.path.join(work, "bg%d" % bgpac)
            ini = write_model(d, 64, kind="gset", nfreq=44, npix=64,
                              bgpac=bgpac, octree=OCTREE, abundance=True)
            res = {}
            if cli.main(["pipeline", ini, "makelib"], res) != 0:
                return 1
            freq = res["absorption"].freq
            absorbed = read_cell_frequency_array(os.path.join(
                d, "absorbed.data"))
            emitted = read_cell_frequency_array(os.path.join(
                d, "emitted.data"))
            leaf = absorbed[:, 0] > -1e19
            clean = np.where(leaf[:, None], absorbed, 0.0).astype(np.float32)
            fir = f2um(freq) >= 100.0
            t = emitted[:, fir]
            m = t > 1e-3 * t.max()
            print("bgpackets %d: %d packets; %d entries at >= 100 um above "
                  "1e-3 of the peak [%s]" % (bgpac, res["absorption"].packets,
                                             int(m.sum()), card), flush=True)
            for um in TRIPLES:
                ref = _nearest(freq, um)
                zero = (clean[leaf][:, ref] <= 0.0).mean(0)
                for rows, tag in ((slice(None), "every row"),
                                  (leaf, "the leaves")):
                    t0 = time.time()
                    lib = library.build_library(clean[rows], emitted[rows],
                                                ref)
                    secs = time.time() - t0
                    p = library.lookup_numpy(lib, clean)[:, fir]
                    med, p90 = _envelope(p[m], t[m])
                    print("  library on %s, refs %s um: floors %s, leaves "
                          "with no absorption %s, occupancy %.4g; median "
                          "%.4f, p90 %.4f; build_library %.2f s (host)"
                          % (tag, um, np.round(lib["lo"], 2),
                             np.round(zero, 6), lib["occupancy"], med, p90,
                             secs), flush=True)
            if bgpac != 999999 // 4:
                continue
            os.chdir(d)
            cfg = RunConfig(ini).validate()
            cfg.freq = freq
            comps = full.build_components(cfg, freq)
            abu = full.read_abundances(cfg, len(clean), len(comps))
            em, per = mabu.solve_emission_multi(
                comps, clean, "cuda", abu=abu, return_components=True)
            emit = np.nonzero(fir)[0][-NNEMIT:]
            for um in NNABS:
                iabs = _nearest(freq, um)
                rabs = mabu.relative_cross_sections(comps, len(freq))[iabs]
                den = np.einsum("cd,fd->cf", abu, rabs)
                out = np.zeros((len(clean), len(emit)), np.float32)
                t0 = time.time()
                for k, (absd, emit_d) in enumerate(per):
                    model = nn.nn_fit(absd[::4][:, iabs],
                                      emit_d[::4][:, emit], "cuda")
                    out += nn.nn_solve(model, mabu.split_absorbed(
                        clean[:, iabs], rabs, abu, k, den=den), "cuda") \
                        * abu[:, k:k + 1]
                b = em[:, emit]
                pos = b > 0
                med, p90 = _envelope(out[pos], b[pos])
                print("  NN with nnabs %s um: median %.4f, p90 %.4f; two "
                      "fits and solves %.2f s [%s]"
                      % (um, med, p90, time.time() - t0, card), flush=True)
            os.chdir(cwd)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
