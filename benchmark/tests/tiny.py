"""Cells at a size a CPU test run holds: the cell's files with an 8^3
model, 10 channels, 4 grain sizes at NE 16 and small reference samples."""

import copy
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402


def parts(workload, bgpackets=3072, ref_packets=4096, **model):
    cell, config, traffic, cfile, spec = harness.cell_spec(workload)
    config = copy.deepcopy(config)
    small = dict(root=8, nfreq=10, nsize=4, ne=16, mapping=[8, 8, 1.0],
                 bgpackets=bgpackets)
    config["model"].update(small, **model)
    traffic = copy.deepcopy(traffic)
    if "bgpackets" in traffic.get("ini", {}):
        traffic["ini"]["bgpackets"] = 4 * bgpackets
    # the Monte-Carlo numbers' limits at this size: a few thousand packets
    # a channel read gaps of 1-2% where the cells' millions read 0.3%
    limits = dict(cfile["limits"])
    for key, v in (("absorbed.totals", 0.1), ("absorbed.shells", 0.05)):
        if key in limits:
            limits[key] = v
    cfile = dict(cfile, reference_packets_per_freq=ref_packets, a2e_cells=64,
                 map_pixels=16, temperature_cells=64, limits=limits)
    return cell, config, traffic, cfile, spec


def run(workload, seed=123456789012, trace=0, seconds=0.5, workdir=None,
        **kw):
    """The result of a run on the CPU, in a work directory of its own (a
    new one under TMPDIR unless given), so that tests run side by side."""
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="soc_bench_test_")
    return harness.execute(workload, seed, seconds, trace, device="cpu",
                           parts=parts(workload, **kw), workdir=workdir,
                           log=lambda msg: None)
