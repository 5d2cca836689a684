"""Per-lane gathers from a table on the card against a gather + scatter
loop: the counterpart of scripts/gather_probe.py.

    python -m soc_tpu_torch.probes.gather_probe [mode ...]
      modes: plain (the script's run_xla, as plain PyTorch),
             take  (run_pallas_take, as the gather kernel, beside its
                    plain version and one embedding_bag call); default:
                    both

Needs a CUDA device; a build or launch error, or a kernel that disagrees
with its plain version, exits non-zero.
"""

import argparse
import sys
from functools import partial

import numpy as np
import torch

from . import common
from .common import EXACT, Case
from .kernels import FLAT, KERNELS, LCG_AFTER, PLAIN, gather_library

LANES = 1 << 15
CELLS = 64 ** 3
ITERS = 400
MODES = ("plain", "take")


def inputs(seed, device):
    """(table [CELLS] f32, idx0 [LANES] int32), drawn as the script draws
    them (numpy, seed 0 gives the script's own inputs)."""
    rng = np.random.default_rng(seed)
    table = rng.random(CELLS, np.float32)
    idx0 = rng.integers(0, CELLS, LANES).astype(np.int32)
    return (torch.as_tensor(table, device=device),
            torch.as_tensor(idx0, device=device))


def run_plain(table, idx0, iters=ITERS):
    """run_xla: gather, scatter-add into tabs, accumulate, then step the
    index; returns (acc, tabs, idx)."""
    acc = torch.zeros(idx0.shape, dtype=torch.float32, device=idx0.device)
    tabs = torch.zeros(CELLS, dtype=torch.float32, device=idx0.device)
    idx = idx0
    for i in range(iters):
        k = idx.to(torch.int64)
        v = table[k]
        tabs.index_add_(0, k, v)
        acc = acc + v
        idx = common.lcg(idx, i, CELLS)
    return acc, tabs, idx


def run_take(table, idx0, ops=KERNELS, iters=ITERS):
    """run_pallas_take: acc += table[idx], then the index steps; returns
    (acc, tabs). The Pallas kernel zeroes tabs and never writes it (its
    docstring's scatter round is not in the kernel), so tabs is all zero
    here too: this ports what the kernel computes."""
    acc = ops.gather(table, idx0, LCG_AFTER, FLAT, iters)
    return acc, torch.zeros(CELLS, dtype=torch.float32, device=acc.device)


def take_library(table, idx0, iters=ITERS):
    """run_take as one PyTorch call: embedding_bag over each lane's
    indices (kernels.gather_library), with the same all-zero tabs."""
    call = gather_library(table, idx0, LCG_AFTER, FLAT, iters)
    tabs = torch.zeros(CELLS, dtype=torch.float32, device=table.device)
    return lambda: (call(), tabs)


def cases(table, idx0, modes, iters=ITERS):
    out = []
    for m in modes:
        if m == "plain":
            out.append(Case("baseline gather+scatter",
                            partial(run_plain, iters=iters), (table, idx0),
                            iters * LANES))
        elif m == "take":
            out.append(Case("take", partial(run_take, iters=iters),
                            (table, idx0), iters * LANES, EXACT,
                            "probe_gather",
                            library=partial(take_library, iters=iters)))
        else:
            raise ValueError("unknown mode %r (modes: plain, take)" % m)
    return out


def run(device, modes=MODES):
    """Runs the modes on the card; returns the common.Results."""
    return common.run_cases(cases(*inputs(0, device), modes), KERNELS,
                            PLAIN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("modes", nargs="*", help="plain, take (default both)")
    args = ap.parse_args(argv)
    modes = args.modes or list(MODES)
    if not set(modes) <= set(MODES):
        ap.error("unknown mode in %s (modes: plain, take)" % modes)
    return common.exit_code(run(common.require_cuda(), modes))


if __name__ == "__main__":
    sys.exit(main())
