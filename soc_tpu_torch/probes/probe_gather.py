"""Gather and scatter-add throughput on the card: the counterpart of
scripts/probe_gather.py. Its Pallas kernels A1-A5 run as the gather kernel
and S1 as the scatter kernel (``kernels``); its XLA baselines run as plain
PyTorch. Each kernel's line is printed beside its plain version's, with
the kernel-against-plain error.

    python -m soc_tpu_torch.probes.probe_gather

Needs a CUDA device; a build or launch error, or a kernel that disagrees
with its plain version, exits non-zero.
"""

import argparse
import sys
from functools import partial

import numpy as np
import torch

from . import common
from .common import EXACT, REL_OF_MAX, Case
from .kernels import ADD, COL, FLAT, KERNELS, PLAIN, ROW

CELLS = 64 * 64 * 64            # 262144, the pipeline's grid
N = 1 << 17                     # 131072 lanes
REPS = 64                       # chained reps inside one call


def inputs(seed, device):
    """(tbl [CELLS] f32 in [0, 1), idx [N] int32 in [0, CELLS), vals [N]
    f32 in [0, 1)) from a numpy generator."""
    rng = np.random.default_rng(seed)
    tbl = rng.random(CELLS, np.float32)
    idx = rng.integers(0, CELLS, N).astype(np.int32)
    vals = rng.random(N, np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (tbl, idx, vals))


# ---- the script's XLA baselines, as plain PyTorch

def baseline_gather(tbl, idx, reps=REPS):
    # the index depends on acc (acc // 1e9 is 0 here) to chain the steps
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for _ in range(reps):
        shift = torch.div(acc.to(torch.int32), 10 ** 9, rounding_mode="floor")
        acc = acc + tbl[torch.remainder(idx + shift, CELLS).to(torch.int64)]
    return acc


def baseline_scatter(tbl, idx, vals, reps=REPS):
    out = torch.zeros(CELLS, dtype=torch.float32, device=idx.device)
    for i in range(reps):
        out.index_add_(0, torch.remainder(idx + i, CELLS).to(torch.int64),
                       vals)
    return out


def baseline_both(tbl, idx, vals, reps=REPS):
    out = torch.zeros(CELLS, dtype=torch.float32, device=idx.device)
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for i in range(reps):
        k = torch.remainder(idx + i, CELLS).to(torch.int64)
        acc = acc + tbl[k]
        out.index_add_(0, k, vals + acc * 1e-30)
    return out, acc


# ---- the Pallas rows: ops=KERNELS (CUDA) or ops=PLAIN

def a1(t, ix, ops=KERNELS, reps=REPS):
    """A1 1-D fancy gather: out[n] = sum_i t[(ix[n] + i) % CELLS]."""
    return ops.gather(t, ix, ADD, FLAT, reps)


def a2(t2, ix2, ops=KERNELS, reps=REPS):
    """A2 (row, col) gather from t as [2048, 128]: A1's values."""
    return ops.gather(t2, ix2, ADD, FLAT, reps)


def a3(t, ix2, ops=KERNELS, reps=REPS):
    """A3 take from the flat table with [1024, 128] indices."""
    return ops.gather(t, ix2, ADD, FLAT, reps)


def a4(t, ix2, ops=KERNELS, reps=REPS):
    """A4 take_along lanes: out[s, l] = sum_i t[s, (ix[s, l] % 128 + i)
    % 128], t [1024, 128]."""
    return ops.gather(t, ix2, ADD, ROW, reps)


def a5(t2, ix2, ops=KERNELS, reps=REPS):
    """A5 take_along sublanes: out[s, l] = sum_i t[(ix[s, l] % 2048 + i)
    % 2048, l], t [2048, 128]."""
    return ops.gather(t2, ix2, ADD, COL, reps)


def s1(ix, v, ops=KERNELS):
    """S1 vector scatter-add: out = 0; for i < 4: out[(ix + i) % CELLS]
    += v."""
    return ops.scatter(ix, v, ADD, FLAT, CELLS, 4)


def cases(tbl, idx, vals, reps=REPS):
    """Every line of the script, with its arguments built as the script
    builds them."""
    tbl2 = tbl.reshape(2048, 128)
    idx2 = idx.reshape(1024, 128)
    return [
        Case("baseline gather [N]<-?[CELLS]", partial(baseline_gather,
                                                      reps=reps),
             (tbl, idx), N * reps),
        Case("baseline scatter-add [CELLS]<-[N]",
             partial(baseline_scatter, reps=reps), (tbl, idx, vals),
             N * reps),
        Case("baseline gather+scatter", partial(baseline_both, reps=reps),
             (tbl, idx, vals), N * reps),
        Case("A1 1-D fancy gather", partial(a1, reps=reps), (tbl, idx),
             N * reps, EXACT, "probe_gather"),
        Case("A2 2-D (row,col) gather", partial(a2, reps=reps),
             (tbl2, idx2), N * reps, EXACT, "probe_gather"),
        Case("A3 take flat", partial(a3, reps=reps), (tbl, idx2),
             N * reps, EXACT, "probe_gather"),
        Case("A4 take_along_axis lanes", partial(a4, reps=reps),
             (tbl2[:1024], idx2), N * reps, EXACT, "probe_gather"),
        Case("A5 take_along_axis sublanes", partial(a5, reps=reps),
             (tbl2, idx2), N * reps, EXACT, "probe_gather"),
        Case("S1 vector scatter-add", s1, (idx, vals), N * 4, REL_OF_MAX,
             "probe_scatter"),
    ]


def run(device):
    """Runs every line on the card; returns the common.Results."""
    return common.run_cases(cases(*inputs(0, device)), KERNELS, PLAIN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    return common.exit_code(run(common.require_cuda()))


if __name__ == "__main__":
    sys.exit(main())
