"""Wide-row gathers, row gathers, the lane-local scatter and the one-hot
tensor-core tally deposit on the card: the counterpart of
scripts/probe_gather2.py. Its Pallas kernels run as the gather kernel
(W1-W4), the row-gather kernel (RG), the scatter kernel (S2) and the
one-hot kernel (MX); its XLA baselines as plain PyTorch. Each kernel's
line is printed beside its plain version's, with the kernel-against-plain
error, and beside one PyTorch call computing the same function where
there is one (embedding_bag for W1-W4, index_add_ for S2 and MX); the MX
correctness deposit is also held to an exact float32 scatter.

    python -m soc_tpu_torch.probes.probe_gather2

Needs a CUDA device; a build or launch error, or a kernel that disagrees
with its plain version, exits non-zero.
"""

import argparse
import sys
from functools import partial

import torch

from . import common
from .common import EXACT, REL, REL_OF_MAX, Case
from .kernels import KERNELS, LCG_BEFORE, ONEHOT_SIDE, PLAIN, ROW, \
    _bf16_parts
from .probe_gather import CELLS, N, gather_yardstick, inputs

REPS = 32
RG_ROWS = 128           # RG reads the rows of j[0, :128] only
MX_BLK = 512            # the MX lanes come in blocks of 512
MX_CHECK_LIMIT = 1e-5   # MX bf16x2 against an exact float32 scatter


def perm(ix, i):
    """The probe's index reshuffle, uniform over CELLS (int32 wrap,
    floored mod)."""
    return common.lcg(ix, i, CELLS)


# ---- the script's XLA baselines, as plain PyTorch

def baseline_gather(tbl, ix, reps=REPS):
    acc = torch.zeros(ix.shape, dtype=torch.float32, device=ix.device)
    j = ix
    for i in range(reps):
        j = perm(j, i)
        acc = acc + tbl[j.to(torch.int64)]
    return acc


def baseline_scatter(ix, v, reps=REPS):
    out = torch.zeros(CELLS, dtype=torch.float32, device=ix.device)
    j = ix
    for i in range(reps):
        j = perm(j, i)
        out.index_add_(0, j.to(torch.int64), v)
    return out


# ---- the Pallas rows: ops=KERNELS (CUDA) or ops=PLAIN; the LCG steps the
# index before each gather or deposit

def w1(t8, c8, ops=KERNELS, reps=REPS):
    """W1: the table broadcast over 8 rows [8, CELLS], j [8, N/8]."""
    return ops.gather(t8, c8, LCG_BEFORE, ROW, reps)


def w2(t1, c1, ops=KERNELS, reps=REPS):
    """W2: one row holding the whole table, [1, CELLS], j [1, N]."""
    return ops.gather(t1, c1, LCG_BEFORE, ROW, reps)


def w3(t8, c8, ops=KERNELS, reps=REPS):
    """W3: t [8, 32768], j [8, N/8] stepped mod 32768 within its row."""
    return ops.gather(t8, c8, LCG_BEFORE, ROW, reps)


def w4(t, c, ops=KERNELS, reps=REPS):
    """W4: t[:2560] broadcast [1024, 2560], j [1024, 128] mod 2560."""
    return ops.gather(t, c, LCG_BEFORE, ROW, reps)


def rg(t2, r, ops=KERNELS, reps=REPS):
    """RG: out[0, k] = sum_i sum_l t2[j_i[0, k], l], k < 128, with j
    [8, N/8] stepped mod 2048."""
    return ops.row_gather(t2, r, reps, RG_ROWS)


def s2(c, v, ops=KERNELS):
    """S2 lane-local scatter-add: 4 steps, a[s, j[s, l]] += v[s, l] with
    j stepped mod 128."""
    return ops.scatter(c, v, LCG_BEFORE, ROW, 128, 4)


def mx(ix, v, split, ops=KERNELS, reps=REPS):
    """MX one-hot deposit [512, 512] of [256, 512] lanes, bf16 x split."""
    return ops.onehot(ix, v, split, reps, True)


def mx_check(ix, v, ops=KERNELS):
    """The MX correctness deposit: one step, no LCG, bf16x2."""
    return ops.onehot(ix, v, 2, 1, False)


def exact_deposit(idx, vals):
    """The exact float32 scatter the MX correctness deposit is held to."""
    return torch.zeros(CELLS, dtype=torch.float32, device=idx.device) \
        .index_add_(0, idx.to(torch.int64), vals)


def _lcg_chain(j, reps, mod):
    """The indices j_1 .. j_reps of an LCG chain, concatenated (int64)."""
    out = []
    for i in range(reps):
        j = common.lcg(j, i, mod)
        out.append(j.reshape(-1).to(torch.int64))
    return torch.cat(out)


def s2_library(c, v, reps=4):
    """S2 as one PyTorch call: index_add_ of all steps' row-offset
    indices into the flat [rows * 128] tally."""
    base = (torch.arange(c.shape[0], device=c.device)[:, None] * 128
            ).expand(c.shape).reshape(-1).repeat(reps)
    k = base + _lcg_chain(c, reps, 128)
    vv = v.reshape(-1).repeat(reps)
    return lambda: vv.new_zeros(c.numel()).index_add_(0, k, vv) \
        .view(c.shape)


def mx_library(ix, v, split, reps=REPS, use_lcg=True):
    """MX as one PyTorch call: index_add_ of every step's cell and the
    same bf16-rounded values into the flat 512^2 cells."""
    side2 = ONEHOT_SIDE ** 2
    k = _lcg_chain(ix, reps, side2) if use_lcg \
        else ix.reshape(-1).to(torch.int64)
    d = _bf16_parts(v.reshape(-1), split).repeat(reps if use_lcg else 1)
    return lambda: d.new_zeros(side2).index_add_(0, k, d) \
        .view(ONEHOT_SIDE, ONEHOT_SIDE)


def cases(tbl, idx, vals, reps=REPS):
    """Every line of the script, with its arguments built as the script
    builds them."""
    ixb = idx.reshape(N // MX_BLK, MX_BLK)
    vb = vals.reshape(N // MX_BLK, MX_BLK)
    return [
        Case("baseline gather", partial(baseline_gather, reps=reps),
             (tbl, idx), N * reps),
        Case("baseline scatter-add", partial(baseline_scatter, reps=reps),
             (idx, vals), N * reps),
        Case("W1 take_along rows8 x 262144", partial(w1, reps=reps),
             (tbl[None, :].expand(8, CELLS).contiguous(),
              idx.reshape(8, N // 8)), N * reps, EXACT, "probe_gather",
             library=gather_yardstick(LCG_BEFORE, ROW, reps)),
        Case("W2 take_along rows1 x 262144", partial(w2, reps=reps),
             (tbl.reshape(1, CELLS), idx.reshape(1, N)), N * reps, EXACT,
             "probe_gather", library=gather_yardstick(LCG_BEFORE, ROW, reps)),
        Case("W3 take_along rows8 x 32768", partial(w3, reps=reps),
             (tbl.reshape(8, CELLS // 8),
              torch.remainder(idx, CELLS // 8).reshape(8, N // 8)),
             N * reps, EXACT, "probe_gather",
             library=gather_yardstick(LCG_BEFORE, ROW, reps)),
        Case("W4 take_along rows1024 x 2560", partial(w4, reps=reps),
             (tbl[None, :2560].expand(1024, 2560).contiguous(),
              torch.remainder(idx, 2560).reshape(1024, 128)),
             N * reps, EXACT, "probe_gather",
             library=gather_yardstick(LCG_BEFORE, ROW, reps)),
        # no library call: one embedding_bag of the rows would still
        # leave a sum over their columns, a second call
        Case("RG row gather t[r] 128 rows", partial(rg, reps=reps),
             (tbl.reshape(2048, 128),
              torch.remainder(idx, 2048).reshape(8, N // 8)),
             RG_ROWS * reps, REL, "probe_row_gather",
             # the table the 128 chains walk, their 128 start indices and
             # the output: the rest of r is never read
             nbytes=tbl.numel() * 4 + RG_ROWS * 4 * 2),
        Case("S2 lane-local scatter-add", s2,
             (torch.remainder(idx, 128).reshape(1024, 128),
              vals.reshape(1024, 128)), N * 4, REL_OF_MAX,
             "probe_scatter", library=s2_library),
        Case("MX one-hot deposit bf16x1", partial(mx, split=1, reps=reps),
             (ixb, vb), N * reps, REL_OF_MAX, "probe_onehot",
             library=partial(mx_library, split=1, reps=reps)),
        Case("MX one-hot deposit bf16x2", partial(mx, split=2, reps=reps),
             (ixb, vb), N * reps, REL_OF_MAX, "probe_onehot",
             library=partial(mx_library, split=2, reps=reps)),
        Case("MX correctness deposit bf16x2", mx_check, (ixb, vb), N,
             REL_OF_MAX, "probe_onehot",
             library=partial(mx_library, split=2, reps=1, use_lcg=False)),
    ]


def run(device):
    """Runs every line on the card; returns the common.Results, the MX
    correctness deposit's also held to an exact float32 scatter."""
    tbl, idx, vals = inputs(0, device)
    results = common.run_cases(cases(tbl, idx, vals), KERNELS, PLAIN)
    check = results[-1]
    ref = exact_deposit(idx, vals)
    err = float(torch.abs(check.out.reshape(-1) - ref).max())
    rel = err / max(float(ref.max()), 1e-30)
    print(f"MX bf16x2 correctness: max abs err {err:.3e} rel {rel:.3e} "
          f"(limit {MX_CHECK_LIMIT:.0e})", flush=True)
    check.checks.append(("against an exact float32 scatter", rel,
                         MX_CHECK_LIMIT))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    return common.exit_code(run(common.require_cuda()))


if __name__ == "__main__":
    sys.exit(main())
