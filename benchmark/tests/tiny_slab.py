"""The slab's cell at a size a CPU test run holds: a root of 8 x 8 x 3
cells of 1 pc, three levels at the lit face (192 + 512 + 2,048 cells), 8
channels, 4 grain sizes, 4,096 star packets a channel, and reference
samples to match."""

import copy
import tempfile

from benchmark import harness

CELL = "trust_slab_tau10.rt-ali"
MODEL = dict(size_pc=[8.0, 8.0, 3.0], gridlength=1.0, refine_pc=[1.0, 0.5],
             nfreq=8, nsize=4, dsc_bins=500, pspackets=4096,
             cellpackets=2752, mapping=[12, 12, 0.5])
# the limits at this size: 4,096 star packets a channel and 2,752 cells
# read Monte-Carlo gaps of a few per cent where the cell's read tenths of
# one, and the maps' cells of 1/4 pc in place of 1/32 pc put more of a
# ray's path in its first cell, where the program's map clamps the entry;
# four columns of 4 x 4 root cells hold a quarter of the deposits each
# (sound seeds read up to 0.014 for the star's, 0.031 for the cell
# pass's, where a shift of one root cell along x reads 0.058)
LIMITS = {"point.levels": 0.05, "point.layers": 0.05, "point.slots": 0.08,
          "point.rings": 0.03, "point.columns": 0.03, "cell.levels": 0.05,
          "cell.layers": 0.05, "cell.self": 0.1, "cell.rings": 0.03,
          "cell.columns": 0.05, "map.dir0": 0.006, "map.dir1": 0.006}


def parts(**model):
    cell, config, traffic, cfile, spec = harness.cell_spec(CELL)
    config = copy.deepcopy(config)
    config["model"].update(MODEL, **model)
    limits = dict(cfile["limits"], **LIMITS)
    cfile = dict(cfile, reference_ps_packets_per_freq=65536,
                 reference_cell_packets=4, map_pixels=16, limits=limits)
    return cell, config, copy.deepcopy(traffic), cfile, spec


def run(seed=123456789012, trace=0, seconds=0.5, workdir=None, **model):
    """The result of a run on the CPU in a work directory of its own."""
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="soc_bench_slab_")
    return harness.execute(CELL, seed, seconds, trace, device="cpu",
                           parts=parts(**model), workdir=workdir,
                           log=lambda msg: None)
