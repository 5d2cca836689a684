#!/usr/bin/env python3
"""GPU smoke run of soc_tpu_torch: the quickest proof that the port still
builds, agrees with its plain versions and runs its main path on the card.

    python3 chip_smoke.py            # full size, one CUDA device

Phases (any failure exits non-zero before the final line):
  1. device: a CUDA device must be present (there is no CPU path); prints
     the card's name and power limit as nvidia-smi reports them
  2. build: compiles every soc_tpu_torch/csrc/*.cu source with nvcc, one
     process each, all at once, and prints each kernel's registers and
     spills from ptxas; a spill in a2e_all_sizes or a2e_clamp fails
  3. A2E kernel against its plain twin on the card at NE 16/48/128/256
     (NFREQ 44, all 24 grain sizes), TF32 off; then its tile, staged
     columns and resident warps per SM at the pipeline's shape (fewer
     than 8 warps fail), and both timed there (262,144 cells, NE 128);
     then the shapes both A2E kernels take on this card (their shared
     memory ceiling: the largest NE at NFREQ 1000, the largest NFREQ at
     NE 256 and at NE 32)
  4. the `pipeline` verb (cli.main, as `python -m soc_tpu_torch pipeline`)
     on a 64^3 model with a stochastic (GSET) dust: absorption run ->
     A2E -> 64x64 map, with checks of shapes,
     finiteness, energy balance and the kernel's launch count; then the
     absorption stage again with the same seed and lane pool: the
     run-to-run spread of the tallies (the atomics add in another order),
     max |diff| / max, the largest relative difference above 1e-3 of the
     maximum and the share of entries that differ, and the float64 escape
     totals, within phase 9's bound (1e-4 relative or 1e-6 of the
     maximum)
  5. the `rt` verb on the same grid with the equilibrium dust the
     pipeline's absorption stage wrote
  6. the A2E clamp kernel (negative weights and absorbed values) against
     the plain twin at NE 16/48/128/256 (all 24 sizes), on inputs where
     the clamp takes effect: some heating entries are negative, and the
     pre-folded kernel (which cannot clamp) differs from the twin by more
     than 10x the tolerance; then
     `stochastic.solve_emission` on such inputs at the pipeline's shape,
     which must run the clamp kernel and not the pre-folded one; then the
     clamp kernel's tile, staged rows and resident warps per SM at that
     shape (fewer than 8 warps fail), and both timed there
  7. the gather/scatter probes (soc_tpu_torch.probes: probe_gather,
     probe_gather2, gather_probe) at the scripts' constants: every row
     timed through its CUDA kernel and its plain version and held to it
     (gathers bit for bit, RG at 1e-6 relative, scatters and one-hot
     deposits at 1e-5 of the maximum, the MX correctness deposit also at
     1e-5 of an exact float32 scatter's maximum), and every row but RG
     also through one PyTorch call, its library yardstick (embedding_bag
     for the gathers, index_add_ for the scatters and one-hot deposits);
     each gather, RG and scatter row's device time (best of 3, with the
     spread; a row whose time was not measured fails; with its best
     call's span, first start to last end, and each of its device
     intervals where it has several) beside its plain version's and its
     library call's (with its span), and RG's beside its two-call
     reference (embedding_bag, then a sum: RG has no one-call
     yardstick); for each MX row the deposit rate (deposits per second of
     device time) of the kernel and of index_add_; then the rate of random
     atomics, the scatter kernel's FLAT LCG_BEFORE form over S1's inputs
     (launches outside the counted run)
  8. the sharded A2E solve: `stochastic.solve_emission` at the pipeline's
     shape (262,144 cells x 24 sizes x NE 128 x NFREQ 44, with the
     polarised sum) over all visible cards, then over cuda:0 two and three
     times, on both routes (pre-folded; clamp, with a negative weight and
     negative absorbed values): equal bit for bit to the one-launch solve,
     one launch per shard; then solve_all_sizes_sharded over phase 9's six
     shards timed against the plain twin
  9. the `devices N` path: the `pipeline` verb (full.run_pipeline with a
     device list) at full width over cuda:0 six times, a (dp 3 x freq 2)
     mesh: energy balance per channel, absorbed.data, emitted.data and the
     map against phase 4's one-device run, one A2E launch per shard; then
     the `rt` verb's path (driver.run) over the same mesh with one packet
     batch per surface element
The kernels line gives each kernel's launches on its path (phase 4 for the
A2E kernel, 6 for the clamp kernel, 7 for the probes, 9 for the sharded
A2E, whose other numbers phase 8 takes over the same six shards), its
time, its plain version's, its library call's where one exists, and its
bound: the larger of the bytes it must move over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (an H100 SXM's published peaks). The
last line is a JSON object naming the device.
"""

import argparse
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1e-4          # kernel vs plain twin, relative, see phase 3
CLAMP_EFFECT = 10 * REL_TOL   # least change the clamp must make, phase 6
BALANCE_TOL = 5e-3      # (absorbed + escaped) / injected - 1, per frequency
# phase 9 against phase 4: the same packets on the same streams, the
# card's atomic adds in another order: every entry within 1e-4 relative or
# 1e-6 of the field's maximum
PRODUCT_RTOL, PRODUCT_ATOL = 1e-4, 1e-6
PRODUCT_SHARDS = 6      # phase 9: dp 3 x freq 2 at NFREQ 44
FULL_BGPACKETS = 999999
N = 64                  # root grid size: 64^3 cells, soc_example's
SOURCES = ("a2e", "probe_gather", "probe_scatter", "probe_onehot")
PROBE_KERNELS = {       # kernel -> (source, the Pallas call sites it replaces)
    "probe_gather": ("soc_tpu_torch/csrc/probe_gather.cu",
                     "scripts/probe_gather.py:111,:130,:148,:167,:186; "
                     "scripts/probe_gather2.py:102,:126,:152,:177; "
                     "scripts/gather_probe.py:74"),
    "probe_row_gather": ("soc_tpu_torch/csrc/probe_gather.cu",
                         "scripts/probe_gather2.py:204"),
    "probe_scatter": ("soc_tpu_torch/csrc/probe_scatter.cu",
                      "scripts/probe_gather.py:207; "
                      "scripts/probe_gather2.py:230"),
    "probe_onehot": ("soc_tpu_torch/csrc/probe_onehot.cu",
                     "scripts/probe_gather2.py:292,:332"),
}


def a2e_work(cells, nsize, ne, nf, clamp, align):
    """(float32 operations, bytes) of one A2E solve over all sizes: the
    function's work, counted once (an FMA counts 2, an add 1; the divides
    and the rescale, O(NE) a cell and size, are left out), whatever loops
    a kernel runs (a2e_all_sizes orders its sums otherwise, csrc/a2e.cu),
    so that the bounds of successive designs compare. Pre-folded
    solve, per cell and size: the bottom row NF*NE FMAs; substitution rows
    j = 1 .. NE-2, (NF + 1) FMAs and 1 subtraction for each l < j; the last
    row NE-1 FMAs; the emission NF*NE FMAs and NE adds. Exact (clamp)
    solve: (NF + 1) FMAs for each heating entry below the diagonal,
    NE(NE-1)/2 of them, and (NE-2)(NE-1)/2 adds of suffix sums, then the
    same emission. Bytes: each input read once and each output written
    once."""
    tri = (ne - 2) * (ne - 1) // 2
    if clamp:
        fma = (nf + 1) * ne * (ne - 1) // 2 + nf * ne
    else:
        fma = nf * ne + (nf + 1) * tri + (ne - 1) + nf * ne
    flops = cells * nsize * (2 * fma + tri + ne)
    words = (cells * nf + nsize * nf * ne * ne + nsize * ne + nsize * nf * ne
             + cells * nf)
    if align:
        words += nsize * cells + cells * nf
    return flops, 4 * words


def ptxas_kernels(log):
    """[(kernel, registers, bytes of spill stores and loads)] from nvcc's
    -Xptxas -v output, one entry per compiled kernel."""
    out = []
    for m in re.finditer(r"Function properties for (\S+)\s*\n\s*(\d+) "
                         r"bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads", log):
        regs = re.search(r"Used (\d+) registers", log[m.end():])
        out.append((m.group(1), int(regs.group(1)) if regs else -1,
                    int(m.group(3)) + int(m.group(4))))
    return out


def bound(flops, nbytes):
    """(least ms on the card, "bytes" or "operations"), at the H100's
    published peaks (probes.common.bound_seconds)."""
    from soc_tpu_torch.probes.common import bound_seconds
    seconds, by = bound_seconds(nbytes, flops)
    return 1e3 * seconds, by


def fail(msg):
    print("chip_smoke: FAILED: " + msg, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail("nvidia-smi: " + out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def read_cell_frequency_array(path):
    """[CELLS, NFREQ] float32 file with an int32 [CELLS, NFREQ] header."""
    raw = np.fromfile(path, np.float32)
    cells, nfreq = raw[:2].view(np.int32)
    return raw[2:].reshape(int(cells), int(nfreq))


def read_map_file(path):
    """map_dir_XX.bin: int32 [NX, NY] header, float32 [NF, NY, NX]."""
    raw = np.fromfile(path, np.float32)
    nx, ny = raw[:2].view(np.int32)
    return raw[2:].reshape(-1, int(ny), int(nx))


def timed(fn, reps):
    """(mean ms of ``reps`` calls after a warm-up call, CUDA events; the
    last output)."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, out


def max_rel(got, ref):
    """Largest relative error over the entries above 1e-6 of the maximum."""
    import torch
    sel = ref > 1e-6 * ref.max()
    return float((torch.abs(got - ref)[sel] / ref[sel]).max())


def kernel_phase(dev, work, rng, report):
    """Phase 3; returns {NE: (solver, frequencies)}, copies of the solvers
    taken before any A2E preparation was cached on them."""
    import torch
    from soc_tpu_torch.example_model import gset_solver, synthetic_absorbed
    from soc_tpu_torch.solve import a2e_kernel, stochastic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 3: TF32 off for both (torch.backends.cuda.matmul."
          "allow_tf32 = %s, cudnn.allow_tf32 = %s)"
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32), flush=True)
    ncmp = 4096
    fresh = {}
    for ne in (16, 48, 128, 256):
        sol, freq = gset_solver(work, nfreq=44, nsize=24, ne=ne)
        fresh[ne] = (copy.deepcopy(sol), freq)
        if not stochastic.fused_weights_nonneg(sol):
            fail("NE %d: negative heating weights" % ne)
        stacks = stochastic.get_fused_stacks(sol, dev, plain=True)
        ab = torch.as_tensor(synthetic_absorbed(rng, sol, freq, ncmp),
                             device=dev)
        align = torch.as_tensor(
            rng.uniform(0.0, 1.0, (sol.nsize, ncmp)).astype(np.float32),
            device=dev)
        tot_k, ptot_k = a2e_kernel.solve_all_sizes(stacks, ab, align)
        tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align)
        torch.cuda.synchronize()
        errs = []
        for k, p in ((tot_k, tot_p), (ptot_k, ptot_p)):
            if not bool(torch.isfinite(k).all()):
                fail("NE %d: kernel output not finite" % ne)
            errs.append(max_rel(k, p))
        print("phase 3: NE %3d  S %d  cells %d  max rel err tot %.3e  "
              "ptot %.3e  (tolerance %.0e)"
              % (ne, sol.nsize, ncmp, errs[0], errs[1], REL_TOL),
              flush=True)
        if max(errs) > REL_TOL:
            fail("NE %d: kernel differs from the plain twin" % ne)
        if ne == 128:
            full_sol, full_stacks = sol, stacks

    # the kernel's layout at the pipeline's shape
    tile, lc, warps = a2e_kernel.pick_fold_config(a2e_kernel._lib(), 44, 128,
                                                  dev.index or 0)
    c4 = -(-44 // 4)
    print("phase 3: a2e_all_sizes at NE 128, NFREQ 44: tile %d cells, %d "
          "columns staged at a time, %d resident warps per SM (at least "
          "%d); %d FMAs per %d shared loads a step over l (%.2f)"
          % (tile, lc, warps, a2e_kernel.MIN_WARPS, 4 * c4, c4 + 1,
             4 * c4 / (c4 + 1)), flush=True)
    if warps < a2e_kernel.MIN_WARPS:
        fail("a2e_all_sizes keeps %d warps per SM at the pipeline's shape"
             % warps)
    lib, index = a2e_kernel._lib(), dev.index or 0
    for kernel, name in (("fold", "a2e_all_sizes"), ("clamp", "a2e_clamp")):
        print("phase 3: %s takes, in %d bytes of shared memory a block: NE "
              "<= %d at NFREQ 1000; NFREQ <= %d at NE 256, <= %d at NE 32"
              % (name, a2e_kernel._smem_cap(lib, index),
                 a2e_kernel.shape_ceiling(lib, kernel, index, nfreq=1000),
                 a2e_kernel.shape_ceiling(lib, kernel, index, ne=256),
                 a2e_kernel.shape_ceiling(lib, kernel, index, ne=32)),
              flush=True)

    # timing at the pipeline's shape
    cells = 64 ** 3
    ab = torch.as_tensor(synthetic_absorbed(rng, full_sol, freq, cells),
                         device=dev)
    ms_k, (tot_k, _) = timed(
        lambda: a2e_kernel.solve_all_sizes(full_stacks, ab), 3)
    ms_p, (tot_p, _) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(full_stacks, ab), 1)
    rel = max_rel(tot_k, tot_p)
    abs_err = float(torch.abs(tot_k - tot_p).max())
    if rel > REL_TOL:
        fail("pipeline shape: kernel differs from the plain twin (%.3e)"
             % rel)
    b_ms, b_by = bound(*a2e_work(cells, full_sol.nsize, 128, 44, False,
                                 False))
    report["a2e_all_sizes"] = dict(ms=ms_k, plain_ms=ms_p,
                                   max_abs_err=abs_err, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None)
    print("phase 3: pipeline shape %d cells x %d sizes x NE 128 x NFREQ 44:"
          " kernel %.2f ms, plain %.2f ms, bound %.2f ms (%s), max rel err "
          "%.3e, max abs err %.3e (max %.3e) [%s]"
          % (cells, full_sol.nsize, ms_k, ms_p, b_ms, b_by, rel, abs_err,
             float(tot_p.max()), report["card"]), flush=True)
    return fresh


def pipeline_phase(dev, work, args, report):
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.example_model import write_model
    from soc_tpu_torch.solve import a2e_kernel
    from soc_tpu_torch.pipeline import driver
    n, lanes = N, driver.DEFAULT_LANES
    if args.bgpackets < FULL_BGPACKETS:
        print("phase 4: bgpackets cut from %d to %d"
              % (FULL_BGPACKETS, args.bgpackets), flush=True)
    ini = write_model(work, n, kind="gset", nfreq=44, nsize=24, npix=64,
                      bgpac=args.bgpackets, map_dx=n / 64.0)
    results = {}
    a2e_kernel.launches = 0
    t0 = time.time()
    rc = cli.main(["pipeline", ini, "--device", str(dev)], results)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = a2e_kernel.launches
    if rc != 0:
        fail("pipeline verb returned %d" % rc)
    res_rt, res_map = results["absorption"], results["map"]
    report["a2e_all_sizes"]["launches"] = launches
    if launches < 1:
        fail("the pipeline did not launch the A2E kernel")
    cells = n ** 3
    absorbed = read_cell_frequency_array(os.path.join(work,
                                                      "absorbed.data"))
    emitted_f = read_cell_frequency_array(os.path.join(work, "emitted.data"))
    for name, a in (("absorbed.data", absorbed), ("emitted.data",
                                                  emitted_f)):
        if a.shape != (cells, 44):
            fail("%s has shape %s" % (name, a.shape))
        if not np.isfinite(a).all():
            fail("%s is not finite" % name)
    heated = absorbed.sum(1) > 0
    if not (emitted_f[heated].sum(1) > 0).all():
        fail("emitted is 0 in a cell with absorptions")
    maps = read_map_file(os.path.join(work, "map_dir_00.bin"))
    if not np.isfinite(maps).all() or maps.max() <= 0:
        fail("map_dir_00.bin is not finite with a positive peak")
    bal = (res_rt.absorbed_photons + res_rt.escaped) / res_rt.injected - 1
    print("phase 4: energy balance (absorbed+escaped)/injected-1 per "
          "frequency: max |.| = %.3e (tolerance %.1e)"
          % (np.abs(bal).max(), BALANCE_TOL), flush=True)
    if np.abs(bal).max() > BALANCE_TOL:
        fail("energy balance off")
    t_rt = res_rt.timings["constant_sources"]
    t_a2e = res_map.timings["a2e"]
    card = report["card"]
    print("phase 4: pipeline %d^3 cells, %d packets, lanes %d: absorption "
          "%.2f s (%.0f packets/s), A2E prep %.2f s, A2E solve %.2f s "
          "(%.0f cells/s), %d A2E launches, maps %.2f s, total %.2f s [%s]"
          % (n, res_rt.packets, lanes, t_rt, res_rt.packets / t_rt,
             res_map.timings["a2e_prep"], t_a2e, cells / t_a2e, launches,
             res_map.timings["maps"], wall, card), flush=True)
    report["stages"] = dict(absorption_s=t_rt, a2e_s=t_a2e,
                            maps_s=res_map.timings["maps"], total_s=wall,
                            packets=res_rt.packets)
    absorption_spread(dev, work, res_rt, lanes)
    return {"absorbed.data": absorbed, "emitted.data": emitted_f,
            "map_dir_00.bin": maps}


def absorption_spread(dev, work, first, lanes):
    """Phase 4: the pipeline's absorption stage run again on the same ini,
    seed and lane pool (no files written), its tallies held to the first
    run's ``first``: the same packets on the same streams, the card's
    atomic adds in another order."""
    import torch
    from soc_tpu_torch.config import RunConfig
    from soc_tpu_torch.pipeline import driver, full
    orig = os.getcwd()
    os.chdir(work)
    try:
        cfg = full.absorption_config(RunConfig("run.ini").validate())
        t0 = time.time()
        res = driver.run(cfg=cfg, device=dev, lanes=lanes, write_files=False,
                         workdir=work)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        os.chdir(orig)
    a = np.asarray(first.absorbed, np.float64)
    b = np.asarray(res.absorbed, np.float64)
    if b.shape != a.shape or res.packets != first.packets:
        fail("phase 4: the rerun traced %d packets into %s, the first %d "
             "into %s" % (res.packets, b.shape, first.packets, a.shape))
    peak = np.abs(a).max()
    diff = np.abs(b - a)
    big = np.abs(a) > 1e-3 * peak
    esc = np.abs(res.escaped - first.escaped) \
        / np.maximum(np.abs(first.escaped), 1e-300)
    ok = bool(np.isfinite(b).all()) and np.allclose(
        b, a, rtol=PRODUCT_RTOL, atol=PRODUCT_ATOL * peak) \
        and np.allclose(res.escaped, first.escaped, rtol=PRODUCT_RTOL,
                        atol=0.0)
    print("phase 4: same-seed rerun of the absorption stage (%d packets, "
          "%d lanes) %.2f s: absorbed max |diff| / max = %.3e; largest "
          "relative difference over the entries above 1e-3 of the max = "
          "%.3e; entries that differ: %.4f%% of %d; escape totals "
          "(float64) largest relative difference %.3e; within rtol %.0e or "
          "%.0e of the max: %s"
          % (res.packets, lanes, wall, diff.max() / peak,
             (diff[big] / np.abs(a[big])).max(), 100 * (diff > 0).mean(),
             a.size, esc.max(), PRODUCT_RTOL, PRODUCT_ATOL, ok), flush=True)
    if not ok:
        fail("phase 4: the same-seed rerun of the absorption stage differs "
             "beyond the bound")


def rt_phase(dev, work):
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.io.cloud import read_hierarchy
    with open(os.path.join(work, "run.ini")) as fp:
        text = fp.read()
    text = text.replace("gs_TST.dust", "TST_simple.dust")
    ini = os.path.join(work, "rt.ini")
    with open(ini, "w") as fp:
        fp.write(text)
    for f in ("tmp.T", "map_dir_00.bin"):
        if os.path.exists(os.path.join(work, f)):
            os.remove(os.path.join(work, f))
    t0 = time.time()
    rc = cli.main(["rt", ini, "--device", str(dev)])
    torch.cuda.synchronize()
    if rc != 0:
        fail("rt verb returned %d" % rc)
    _, _, _, _, vals = read_hierarchy(os.path.join(work, "tmp.T"))
    t = np.concatenate(vals)
    if not (np.isfinite(t).all() and (t > 0).all()):
        fail("tmp.T is not finite and positive")
    maps = read_map_file(os.path.join(work, "map_dir_00.bin"))
    if not np.isfinite(maps).all():
        fail("rt map is not finite")
    print("phase 5: rt verb %.2f s, T %.2f-%.2f K (median %.2f), map peak "
          "%.3e" % (time.time() - t0, t.min(), t.max(), np.median(t),
                    maps.max()), flush=True)


def clamp_effect(stacks, fold_stacks, ab, ref):
    """(negative heating entries sum_f ABS W over all sizes, largest
    relative change of ``ref`` when the clamp is left out): the pre-folded
    kernel folds the weights before the product, so it cannot clamp."""
    import torch
    from soc_tpu_torch.solve import a2e_kernel
    nneg = sum(int((ab @ stacks.w_flat[s].T < 0).sum())
               for s in range(stacks.nsize))
    unclamped, _ = a2e_kernel.solve_all_sizes(fold_stacks, ab)
    return nneg, max_rel(torch.nan_to_num(unclamped, nan=float("inf")), ref)


def clamp_phase(dev, solvers, rng, report):
    """Phase 6: the exact (clamp) A2E kernel on inputs with a negative
    weight and negative absorbed values; ``solvers`` as phase 3 returns
    them."""
    import torch
    from soc_tpu_torch.example_model import (negate_one_weight,
                                             synthetic_absorbed,
                                             with_negative_entries)
    from soc_tpu_torch.solve import a2e_kernel, stochastic
    ncmp = 4096
    for ne in (16, 48, 128, 256):
        sol, freq = solvers[ne]
        negate_one_weight(sol)
        if stochastic.fused_weights_nonneg(sol):
            fail("phase 6: NE %d: the negated weight was not seen" % ne)
        stacks = stochastic.get_fused_stacks(sol, dev, plain=True,
                                             clamp=True)
        ab_h = with_negative_entries(
            rng, synthetic_absorbed(rng, sol, freq, ncmp))
        ab = torch.as_tensor(ab_h, device=dev)
        align = torch.as_tensor(
            rng.uniform(0.0, 1.0, (sol.nsize, ncmp)).astype(np.float32),
            device=dev)
        tot_k, ptot_k = a2e_kernel.solve_all_sizes_clamp(stacks, ab, align)
        tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(tot_k).all())
                and bool(torch.isfinite(ptot_k).all())):
            fail("phase 6: NE %d: clamp kernel output not finite" % ne)
        errs = [max_rel(tot_k, tot_p), max_rel(ptot_k, ptot_p)]
        nneg, effect = clamp_effect(
            stacks, stochastic.get_fused_stacks(sol, dev), ab, tot_p)
        print("phase 6: NE %3d  S %d  cells %d  (%.1f%% of absorbed < 0, "
              "%d heating entries < 0, unclamped differs by %.3e, at least "
              "%.0e) clamp kernel max rel err tot %.3e  ptot %.3e  "
              "(tolerance %.0e)" % (ne, sol.nsize, ncmp,
                                    100 * (ab_h < 0).mean(), nneg, effect,
                                    CLAMP_EFFECT, errs[0], errs[1], REL_TOL),
              flush=True)
        if nneg == 0 or not effect > CLAMP_EFFECT:
            fail("phase 6: NE %d: the clamp takes no effect on these inputs"
                 % ne)
        if max(errs) > REL_TOL:
            fail("phase 6: NE %d: clamp kernel differs from the plain twin"
                 % ne)
        if ne == 128:
            full_sol, full_freq = sol, freq

    # the path: solve_emission routes these inputs to the clamp kernel
    cells = 64 ** 3
    ab_h = with_negative_entries(
        rng, synthetic_absorbed(rng, full_sol, full_freq, cells))
    a2e_kernel.launches = a2e_kernel.clamp_launches = 0
    t0 = time.time()
    emitted = stochastic.solve_emission(full_sol, ab_h, dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, folded = a2e_kernel.clamp_launches, a2e_kernel.launches
    if launches < 1 or folded != 0:
        fail("phase 6: solve_emission with negative inputs launched the "
             "clamp kernel %d and the pre-folded kernel %d times"
             % (launches, folded))
    if emitted.shape != (cells, 44) or not np.isfinite(emitted).all():
        fail("phase 6: solve_emission output not finite of shape %s"
             % (emitted.shape,))
    print("phase 6: solve_emission, %d cells with negative entries: %.2f s,"
          " %d clamp kernel launch(es), 0 pre-folded" % (cells, wall,
                                                        launches), flush=True)

    # the kernel's layout at the pipeline's shape
    tile, lr, warps = a2e_kernel.pick_clamp_config(a2e_kernel._lib(), 44, 128,
                                                   dev.index or 0)
    print("phase 6: a2e_clamp at NE 128, NFREQ 44: tile %d cells, %d rows "
          "staged at a time, %d resident warps per SM (at least %d)"
          % (tile, lr, warps, a2e_kernel.MIN_WARPS), flush=True)
    if warps < a2e_kernel.MIN_WARPS:
        fail("a2e_clamp keeps %d warps per SM at the pipeline's shape"
             % warps)

    # timing at the pipeline's shape
    stacks = stochastic.get_fused_stacks(full_sol, dev, plain=True,
                                         clamp=True)
    ab = torch.as_tensor(ab_h, device=dev)
    ms_k, (tot_k, _) = timed(
        lambda: a2e_kernel.solve_all_sizes_clamp(stacks, ab), 3)
    ms_p, (tot_p, _) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(stacks, ab), 1)
    rel = max_rel(tot_k, tot_p)
    abs_err = float(torch.abs(tot_k - tot_p).max())
    if rel > REL_TOL:
        fail("phase 6: pipeline shape: clamp kernel differs from the plain "
             "twin (%.3e)" % rel)
    b_ms, b_by = bound(*a2e_work(cells, full_sol.nsize, 128, 44, True,
                                 False))
    report["a2e_clamp"] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=abs_err,
                               launches=launches, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
    print("phase 6: pipeline shape %d cells x %d sizes x NE 128 x NFREQ 44:"
          " clamp kernel %.2f ms, plain %.2f ms, bound %.2f ms (%s), max rel "
          "err %.3e, max abs err %.3e (max %.3e) [%s]"
          % (cells, full_sol.nsize, ms_k, ms_p, b_ms, b_by, rel, abs_err,
             float(tot_p.max()), report["card"]), flush=True)


def sharded_a2e_phase(dev, fold_sol, clamp_sol, freq, rng, report):
    """Phase 8: solve_emission split over shards against the one-launch
    solve, bit for bit, on both routes; fold_sol has non-negative weights,
    clamp_sol a negated one (phase 6's)."""
    import torch
    from soc_tpu_torch.example_model import (synthetic_absorbed,
                                             with_negative_entries)
    from soc_tpu_torch.solve import a2e_kernel, stochastic
    cells = N ** 3
    card = report["card"]
    visible = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    shard_sets = [visible, [dev] * 2, [dev] * 3]
    ab_fold = synthetic_absorbed(rng, fold_sol, freq, cells)
    ab_clamp = with_negative_entries(
        rng, synthetic_absorbed(rng, clamp_sol, freq, cells))
    a = fold_sol.size_a
    aalg = rng.uniform(a.min(), a.max(), cells).astype(np.float32)
    for route, sol, ab in (("pre-folded", fold_sol, ab_fold),
                           ("clamp", clamp_sol, ab_clamp)):
        count = "clamp_launches" if route == "clamp" else "launches"
        t0 = time.time()
        one = stochastic.solve_emission(sol, ab, dev, aalg=aalg,
                                        devices=[dev])
        torch.cuda.synchronize()
        print("phase 8: %s route, one launch: solve_emission %.2f s [%s]"
              % (route, time.time() - t0, card), flush=True)
        for shards in shard_sets:
            a2e_kernel.launches = a2e_kernel.clamp_launches = 0
            t0 = time.time()
            got = stochastic.solve_emission(sol, ab, dev, aalg=aalg,
                                            devices=shards)
            torch.cuda.synchronize()
            wall = time.time() - t0
            n_sh = len(shards)
            # (this route's launches, the other route's)
            launched = (getattr(a2e_kernel, count),
                        a2e_kernel.launches + a2e_kernel.clamp_launches
                        - getattr(a2e_kernel, count))
            print("phase 8: %s route over %s: solve_emission %.2f s, %d "
                  "launches (%d shards), bit-equal to one launch: %s [%s]"
                  % (route, ",".join(str(d) for d in shards), wall,
                     launched[0], n_sh,
                     all(np.array_equal(x, y) for x, y in zip(got, one)),
                     card), flush=True)
            if launched != (n_sh, 0):
                fail("phase 8: %s route over %d shards launched %s"
                     % (route, n_sh, launched))
            if not all(np.array_equal(x, y) for x, y in zip(got, one)):
                fail("phase 8: %s route over %d shards differs from one "
                     "launch" % (route, n_sh))
            if not np.isfinite(got[0]).all():
                fail("phase 8: %s route: output not finite" % route)

    # the sharded kernel wrapper itself over phase 9's six shards, timed
    # beside the plain twin on the same inputs
    shards = [dev] * PRODUCT_SHARDS
    stacks = stochastic.get_fused_stacks(fold_sol, dev, plain=True)
    ab = torch.as_tensor(ab_fold, device=dev)
    align = torch.as_tensor(np.stack(
        [stochastic.alignment_weights(fold_sol, i, aalg)
         for i in range(fold_sol.nsize)]), device=dev)
    ms_k, (tot_k, ptot_k) = timed(
        lambda: a2e_kernel.solve_all_sizes_sharded(
            {dev: stacks}, ab, align, shards, False), 3)
    ms_p, (tot_p, ptot_p) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(stacks, ab, align), 1)
    rel = max(max_rel(tot_k, tot_p), max_rel(ptot_k, ptot_p))
    abs_err = float(max(torch.abs(tot_k - tot_p).max(),
                        torch.abs(ptot_k - ptot_p).max()))
    if rel > REL_TOL:
        fail("phase 8: the sharded solve differs from the plain twin (%.3e)"
             % rel)
    b_ms, b_by = bound(*a2e_work(cells, fold_sol.nsize, 128, 44, False,
                                 True))
    report["a2e_sharded"] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=abs_err,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None, shards=len(shards))
    print("phase 8: solve_all_sizes_sharded over cuda:0 x%d, %d cells x %d "
          "sizes x NE 128 x NFREQ 44 with the polarised sum: %.2f ms, plain "
          "%.2f ms, bound %.2f ms (%s), max rel err %.3e, max abs err %.3e "
          "[%s]" % (len(shards), cells, fold_sol.nsize, ms_k, ms_p, b_ms,
                    b_by, rel, abs_err, card), flush=True)


def product_phase(dev, work, args, report, ref):
    """Phase 9: the `devices N` path over cuda:0 six times (dp 3 x freq
    2), held to phase 4's one-device outputs ``ref``."""
    import torch
    from soc_tpu_torch.example_model import write_model
    from soc_tpu_torch.pipeline import driver, full
    from soc_tpu_torch.io.cloud import read_hierarchy
    from soc_tpu_torch.solve import a2e_kernel
    card = report["card"]
    sub = os.path.join(work, "devices")
    ini = write_model(sub, N, kind="gset", nfreq=44, nsize=24, npix=64,
                      bgpac=args.bgpackets, map_dx=N / 64.0)
    # phase 4's A2E_pre output for the same dust, frequencies and NE: the
    # pipeline reuses a matching .solver file, as it would in phase 4's
    # directory
    shutil.copy(os.path.join(work, "gs_TST.solver"), sub)
    devices = [dev] * PRODUCT_SHARDS
    names = "%s x%d" % (dev, PRODUCT_SHARDS)
    a2e_kernel.launches = a2e_kernel.clamp_launches = 0
    t0 = time.time()
    res_rt, _, res_map = full.run_pipeline(ini, dev, devices=devices)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (a2e_kernel.launches, a2e_kernel.clamp_launches)
    print("phase 9: pipeline over %s: absorption %.2f s (%d packets, %.0f "
          "packets/s), A2E solve %.2f s, maps %.2f s, total %.2f s; A2E "
          "launches: %d a2e_all_sizes, %d a2e_clamp [%s]"
          % (names, res_rt.timings["constant_sources"], res_rt.packets,
             res_rt.packets / res_rt.timings["constant_sources"],
             res_map.timings["a2e"], res_map.timings["maps"], wall,
             launches[0], launches[1], card), flush=True)
    from soc_tpu_torch.parallel.product import ProductMesh
    pm = ProductMesh(PRODUCT_SHARDS, 44, [dev] * PRODUCT_SHARDS)
    print("phase 9: mesh dp %d x freq %d; the 64-row map is %s"
          % (pm.n_dp, pm.n_freq, "split over the mesh" if 64 % pm.n_dp == 0
             else "rendered on one device (soc_tpu's rule splits rows only "
             "when dp divides them)"), flush=True)
    if launches != (PRODUCT_SHARDS, 0):
        fail("phase 9: expected one A2E launch per shard, got %s"
             % (launches,))
    report["a2e_sharded"]["launches"] = launches[0]
    report["stages_devices"] = dict(
        absorption_s=res_rt.timings["constant_sources"],
        a2e_s=res_map.timings["a2e"], maps_s=res_map.timings["maps"],
        total_s=wall)
    bal = (res_rt.absorbed_photons + res_rt.escaped) / res_rt.injected - 1
    print("phase 9: energy balance per frequency: max |.| = %.3e "
          "(tolerance %.1e)" % (np.abs(bal).max(), BALANCE_TOL), flush=True)
    if np.abs(bal).max() > BALANCE_TOL:
        fail("phase 9: energy balance off")
    readers = {"absorbed.data": read_cell_frequency_array,
               "emitted.data": read_cell_frequency_array,
               "map_dir_00.bin": read_map_file}
    for name, read in readers.items():
        got, want = read(os.path.join(sub, name)), ref[name]
        ok = got.shape == want.shape and np.isfinite(got).all() and \
            np.allclose(got, want, rtol=PRODUCT_RTOL,
                        atol=PRODUCT_ATOL * np.abs(want).max())
        err = float(np.abs(got - want).max() / np.abs(want).max()) \
            if got.shape == want.shape else float("inf")
        print("phase 9: %s against phase 4: max |diff| / max = %.3e, "
              "allclose(rtol %.0e, atol %.0e of the max): %s"
              % (name, err, PRODUCT_RTOL, PRODUCT_ATOL, ok), flush=True)
        if not ok:
            fail("phase 9: %s differs from the one-device run" % name)

    # the rt verb's path over the same mesh, one packet batch per surface
    # element
    with open(ini) as fp:
        text = fp.read()
    batch = 8 * 6 * N * N
    text = re.sub(r"(?m)^bgpackets\s+\d+", "bgpackets %d" % batch,
                  text.replace("gs_TST.dust", "TST_simple.dust"))
    rt_ini = os.path.join(sub, "rt.ini")
    with open(rt_ini, "w") as fp:
        fp.write(text)
    print("phase 9: rt: bgpackets cut from %d to %d (one batch per "
          "surface element)" % (args.bgpackets, batch), flush=True)
    t0 = time.time()
    res = driver.run(rt_ini, device=dev, devices=devices)
    torch.cuda.synchronize()
    _, _, _, _, vals = read_hierarchy(os.path.join(sub, "tmp.T"))
    t = np.concatenate(vals)
    bal = (res.absorbed_photons + res.escaped) / res.injected - 1
    if not (np.isfinite(t).all() and (t > 0).all()) \
            or np.abs(bal).max() > BALANCE_TOL:
        fail("phase 9: rt over the mesh: T not finite and positive, or "
             "energy balance off")
    print("phase 9: rt over %s: %.2f s, %d packets, T %.2f-%.2f K, "
          "energy balance %.3e [%s]"
          % (names, time.time() - t0, res.packets, t.min(), t.max(),
             np.abs(bal).max(), card), flush=True)


def probes_phase(dev, report):
    """Phase 7: the three probe modules, each row through its kernel."""
    import torch
    from soc_tpu_torch.probes import (gather_probe, kernels, probe_gather,
                                      probe_gather2)
    for name in kernels.launches:
        kernels.launches[name] = 0
    t0 = time.time()
    results = (probe_gather.run(dev) + probe_gather2.run(dev)
               + gather_probe.run(dev))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print("phase 7: probes ran in %.2f s [%s]" % (time.time() - t0,
                                                  report["card"]), flush=True)
    bad = [r.name for r in results if not r.ok]
    if bad:
        fail("phase 7: kernels that fail their checks: %s" % ", ".join(bad))
    for r in results:
        if r.kernel == "probe_row_gather":
            other = (r.reference_device_seconds, r.reference_device_spread,
                     r.reference_span)
            label = "no one-call library call; two calls (embedding_bag, sum)"
        elif r.kernel in ("probe_gather", "probe_scatter"):
            other = (r.library_device_seconds, r.library_device_spread,
                     r.library_span)
            label = "embedding_bag" if r.kernel == "probe_gather" \
                else "index_add_"
        else:
            continue
        if r.device_seconds is None:
            fail("phase 7: %s: device time not measured" % r.name)
        if other[0] is None:
            fail("phase 7: %s: %s: device time not measured"
                 % (r.name, label))
        print("phase 7: %s: device time per call (best of 3) kernel %.4f ms "
              "(spread %.4f; span %.4f ms%s), plain %s, %s %.4f ms (spread "
              "%.4f; span %.4f ms), %.2fx [%s]"
              % (r.name, 1e3 * r.device_seconds, 1e3 * r.device_spread,
                 1e3 * r.device_span,
                 "" if len(r.device_intervals) < 2 else ": " + ", ".join(
                     "%s %.4f" % (n, 1e3 * t) for n, t in r.device_intervals),
                 "not measured" if r.plain_device_seconds is None
                 else "%.4f ms" % (1e3 * r.plain_device_seconds), label,
                 1e3 * other[0], 1e3 * other[1], 1e3 * other[2],
                 other[0] / r.device_seconds, report["card"]), flush=True)
    for r in results:
        if r.kernel != "probe_onehot":
            continue
        if r.device_seconds is None or r.library_device_seconds is None:
            fail("phase 7: %s: device time not measured" % r.name)
        print("phase 7: %s: %d deposits: %.4e deposits/s of device time "
              "(%.4f ms), index_add_ %.4e deposits/s (%.4f ms) [%s]"
              % (r.name, r.elems,
                 r.elems / r.device_seconds, 1e3 * r.device_seconds,
                 r.elems / r.library_device_seconds,
                 1e3 * r.library_device_seconds, report["card"]),
              flush=True)
    for name in PROBE_KERNELS:
        rows = [r for r in results if r.kernel == name]
        if launches[name] < 1 or not rows:
            fail("phase 7: %s was not launched" % name)
        # device time per call where the profiler saw the device, else
        # the call's event-timed time (which holds the launch overhead)
        dev_ms = 1e3 * sum(r.seconds if r.device_seconds is None
                           else r.device_seconds for r in rows)
        plain_ms = 1e3 * sum(r.plain_seconds if r.plain_device_seconds is
                             None else r.plain_device_seconds for r in rows)
        bound_ms = 1e3 * sum(r.bound_seconds for r in rows)
        by_bytes = sum(r.bound_seconds for r in rows if r.bound_by == "bytes")
        lib = [r.library_seconds if r.library_device_seconds is None
               else r.library_device_seconds for r in rows]
        report[name] = dict(
            launches=launches[name], max_abs_err=max(r.abs_err for r in rows),
            ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes" if 2 * by_bytes >= bound_ms / 1e3
            else "operations",
            library_ms=None if None in lib else 1e3 * sum(lib))
        print("phase 7: %s: %d rows, %d launches; summed over its rows, "
              "device time per call: kernel %.4f ms, plain %.4f ms, "
              "library call %s, bound %.4f ms (%s); call time (best of 3): "
              "kernel %.4f ms, plain %.4f ms%s"
              % (name, len(rows), launches[name], dev_ms, plain_ms,
                 "none" if report[name]["library_ms"] is None
                 else "%.4f ms" % report[name]["library_ms"], bound_ms,
                 report[name]["bound_by"],
                 1e3 * sum(r.seconds for r in rows),
                 1e3 * sum(r.plain_seconds for r in rows),
                 "" if all(r.device_seconds is not None
                           and r.plain_device_seconds is not None
                           for r in rows)
                 else " (device time not measured for every row: call "
                      "times stand in)"), flush=True)
    random_atomics(dev, report["card"])


def random_atomics(dev, card):
    """Phase 7: the rate of random float atomics into a table in L2, the
    floor of a fused march's deposits (one atomic a deposit, into the
    cells a packet crosses): the scatter kernel's FLAT LCG_BEFORE form
    over S1's inputs, 2^17 lanes x 4 steps into 262,144 cells, each step
    an atomicAdd at an LCG index; held to the plain version. S1 itself
    folds three quarters of its adds into a stencil, since the ADD rule
    puts a lane's steps on consecutive cells. These launches come after
    the counted run."""
    from soc_tpu_torch.probes import common, kernels, probe_gather
    _, idx, vals = probe_gather.inputs(0, dev)
    args = (idx, vals, kernels.LCG_BEFORE, kernels.FLAT, probe_gather.CELLS,
            4)
    err = common.error(kernels.scatter(*args), kernels.scatter_plain(*args),
                       common.REL_OF_MAX)
    best, spread, call = common.device_seconds(lambda: kernels.scatter(*args))
    if best is None:
        fail("phase 7: random atomics: device time not measured")
    atomics = 4 * idx.numel()
    deposit = max(t for n, t in common.intervals(call) if "flat_lcg" in n)
    print("phase 7: random atomics (FLAT LCG_BEFORE over S1's inputs, %d "
          "atomicAdds into %d cells): device time per call (best of 3) "
          "%.4f ms (spread %.4f), %.4e atomics/s; the atomic kernel alone "
          "%.4f ms, %.4e atomics/s; against plain %.3e (limit %.0e) [%s]"
          % (atomics, probe_gather.CELLS, 1e3 * best, 1e3 * spread,
             atomics / best, 1e3 * deposit, atomics / deposit, err,
             common.LIMITS[common.REL_OF_MAX], card), flush=True)
    if err > common.LIMITS[common.REL_OF_MAX]:
        fail("phase 7: random atomics differ from the plain version")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bgpackets", type=int, default=FULL_BGPACKETS)
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()

    # ---- phase 1: device
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs a "
             "CUDA device")
    if not os.path.exists(os.path.join(HERE, "soc_tpu_torch", "csrc",
                                       "a2e.cu")):
        fail("run from a checkout of the repository (soc_tpu_torch/ is "
             "missing next to this script)")
    sys.path.insert(0, HERE)
    from soc_tpu_torch import _build
    dev = torch.device("cuda", 0)
    card = card_line()
    print("phase 1: %s (torch %s, CUDA %s, %d device(s))"
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()), flush=True)
    report = dict(card=card)

    # ---- phase 2: build, one nvcc per source, all started together
    t0 = time.time()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.library, SOURCES))
    print("phase 2: built %d sources in %.2f s" % (len(SOURCES),
                                                   time.time() - t0),
          flush=True)
    for name in SOURCES:
        secs, log = _build.build_log.get(name, (0.0, "cached"))
        print("phase 2: csrc/%s.cu in %.2f s; nvcc says:\n%s"
              % (name, secs, log.strip()), flush=True)
        for kernel, regs, spills in ptxas_kernels(log):
            print("phase 2: %s: %d registers, %d bytes spilled (stores + "
                  "loads)" % (kernel, regs, spills), flush=True)
            for name in ("a2e_all_sizes", "a2e_clamp"):
                if name in kernel and spills:
                    fail("%s spills registers" % name)

    work = os.path.join(HERE, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(args.seed)
    try:
        solvers = kernel_phase(dev, work, rng, report)
        fold_sol, freq = copy.deepcopy(solvers[128])
        ref = pipeline_phase(dev, work, args, report)
        rt_phase(dev, work)
        clamp_phase(dev, solvers, rng, report)
        probes_phase(dev, report)
        sharded_a2e_phase(dev, fold_sol, solvers[128][0], freq, rng, report)
        product_phase(dev, work, args, report, ref)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    sources = dict(PROBE_KERNELS, a2e_all_sizes=(
        "soc_tpu_torch/csrc/a2e.cu", "soc_tpu/solve/pallas_a2e.py:111"),
        a2e_clamp=("soc_tpu_torch/csrc/a2e.cu",
                   "soc_tpu/solve/stochastic.py:100 (exact path, XLA)"),
        a2e_sharded=("soc_tpu_torch/csrc/a2e.cu",
                     "soc_tpu/solve/pallas_a2e.py:193"))
    order = ["a2e_all_sizes", "a2e_clamp", *PROBE_KERNELS, "a2e_sharded"]
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=sources[name][0],
        replaces=sources[name][1],
        **{k: report[name][k] for k in keys + ("shards",)
           if k in report[name]})
        for name in order]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
