#!/usr/bin/env python3
"""GPU smoke run of soc_tpu_torch: the quickest proof that the port still
builds, agrees with its plain versions and runs its main path on the card.

    python3 chip_smoke.py            # full size, one CUDA device

Phases (any failure exits non-zero before the final line):
  1. device: a CUDA device must be present (there is no CPU path); prints
     the card's name and power limit as nvidia-smi reports them
  2. build: compiles every soc_tpu_torch/csrc/*.cu source with nvcc, one
     process each, all at once
  3. A2E kernel against its plain twin on the card at NE 16/48/128/256
     (NFREQ 44, all 24 grain sizes), TF32 off; then both timed at the
     pipeline's shape (262,144 cells, NE 128)
  4. the `pipeline` verb (cli.main, as `python -m soc_tpu_torch pipeline`)
     on a 64^3 model with a stochastic (GSET) dust: absorption run ->
     A2E -> 64x64 map, with checks of shapes,
     finiteness, energy balance and the kernel's launch count
  5. the `rt` verb on the same grid with the equilibrium dust the
     pipeline's absorption stage wrote
  6. the A2E clamp kernel (negative weights and absorbed values) against
     the plain twin at NE 16/48/128/256 (all 24 sizes), on inputs where
     the clamp takes effect: some heating entries are negative, and the
     pre-folded kernel (which cannot clamp) differs from the twin by more
     than 10x the tolerance; then
     `stochastic.solve_emission` on such inputs at the pipeline's shape,
     which must run the clamp kernel and not the pre-folded one; then
     both timed at that shape
  7. the gather/scatter probes (soc_tpu_torch.probes: probe_gather,
     probe_gather2, gather_probe) at the scripts' constants: every row
     timed through its CUDA kernel and its plain version and held to it
     (gathers bit for bit, RG at 1e-6 relative, scatters and one-hot
     deposits at 1e-5 of the maximum, the MX correctness deposit also at
     1e-5 of an exact float32 scatter's maximum)
The last line is a JSON object naming the device.
"""

import argparse
import copy
import json
import os
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
    report["a2e_all_sizes"] = dict(ms=ms_k, plain_ms=ms_p,
                                   max_abs_err=abs_err)
    print("phase 3: pipeline shape %d cells x %d sizes x NE 128 x NFREQ 44:"
          " kernel %.2f ms, plain %.2f ms, max rel err %.3e, max abs err "
          "%.3e (max %.3e) [%s]"
          % (cells, full_sol.nsize, ms_k, ms_p, rel, abs_err,
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
    report["a2e_clamp"] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=abs_err,
                               launches=launches)
    print("phase 6: pipeline shape %d cells x %d sizes x NE 128 x NFREQ 44:"
          " clamp kernel %.2f ms, plain %.2f ms, max rel err %.3e, max abs "
          "err %.3e (max %.3e) [%s]"
          % (cells, full_sol.nsize, ms_k, ms_p, rel, abs_err,
             float(tot_p.max()), report["card"]), flush=True)


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
        report[name] = dict(launches=launches[name],
                            max_abs_err=max(r.abs_err for r in rows),
                            ms=dev_ms, plain_ms=plain_ms)
        print("phase 7: %s: %d rows, %d launches; summed over its rows, "
              "device time per call: kernel %.4f ms, plain %.4f ms; call "
              "time (best of 3): kernel %.4f ms, plain %.4f ms%s"
              % (name, len(rows), launches[name], dev_ms, plain_ms,
                 1e3 * sum(r.seconds for r in rows),
                 1e3 * sum(r.plain_seconds for r in rows),
                 "" if all(r.device_seconds is not None
                           and r.plain_device_seconds is not None
                           for r in rows)
                 else " (device time not measured for every row: call "
                      "times stand in)"), flush=True)


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

    work = os.path.join(HERE, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(args.seed)
    try:
        solvers = kernel_phase(dev, work, rng, report)
        pipeline_phase(dev, work, args, report)
        rt_phase(dev, work)
        clamp_phase(dev, solvers, rng, report)
        probes_phase(dev, report)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    sources = dict(PROBE_KERNELS, a2e_all_sizes=(
        "soc_tpu_torch/csrc/a2e.cu", "soc_tpu/solve/pallas_a2e.py:111"),
        a2e_clamp=("soc_tpu_torch/csrc/a2e.cu",
                   "soc_tpu/solve/stochastic.py:100 (exact path, XLA)"))
    order = ["a2e_all_sizes", "a2e_clamp", *PROBE_KERNELS]
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=sources[name][0],
        replaces=sources[name][1], launches=report[name]["launches"],
        max_abs_err=report[name]["max_abs_err"], ms=report[name]["ms"],
        plain_ms=report[name]["plain_ms"]) for name in order]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
