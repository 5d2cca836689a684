#!/usr/bin/env python3
"""GPU smoke run of soc_tpu_torch: the quickest proof that the port still
builds, agrees with its plain versions and runs its main path on the card.

    python3 chip_smoke.py            # full size, one CUDA device

Phases (any failure exits non-zero before the final line):
  1. device: a CUDA device must be present (there is no CPU path); prints
     the card's name and power limit as nvidia-smi reports them
  2. build: compiles soc_tpu_torch/csrc/a2e.cu with nvcc
  3. A2E kernel against its plain twin on the card at NE 16/48/128/256
     (NFREQ 44, all 24 grain sizes), TF32 off; then both timed at the
     pipeline's shape (262,144 cells, NE 128)
  4. the `pipeline` verb (cli.main, as `python -m soc_tpu_torch pipeline`)
     on a 64^3 model with a stochastic (GSET) dust: absorption run ->
     A2E -> 64x64 map, with checks of shapes,
     finiteness, energy balance and the kernel's launch count
  5. the `rt` verb on the same grid with the equilibrium dust the
     pipeline's absorption stage wrote
The last line is a JSON object naming the device.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1e-4          # kernel vs plain twin, relative, see phase 3
BALANCE_TOL = 5e-3      # (absorbed + escaped) / injected - 1, per frequency
FULL_BGPACKETS = 999999
N = 64                  # root grid size: 64^3 cells, soc_example's


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


def kernel_phase(dev, work, rng, report):
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
    for ne in (16, 48, 128, 256):
        sol, freq = gset_solver(work, nfreq=44, nsize=24, ne=ne)
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
            sel = p > 1e-6 * p.max()
            errs.append(float((torch.abs(k - p)[sel] / p[sel]).max()))
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

    def timed(fn, reps):
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

    ms_k, (tot_k, _) = timed(
        lambda: a2e_kernel.solve_all_sizes(full_stacks, ab), 3)
    ms_p, (tot_p, _) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(full_stacks, ab), 1)
    sel = tot_p > 1e-6 * tot_p.max()
    rel = float((torch.abs(tot_k - tot_p)[sel] / tot_p[sel]).max())
    abs_err = float(torch.abs(tot_k - tot_p).max())
    if rel > REL_TOL:
        fail("pipeline shape: kernel differs from the plain twin (%.3e)"
             % rel)
    report.update(ms=ms_k, plain_ms=ms_p, max_abs_err=abs_err)
    print("phase 3: pipeline shape %d cells x %d sizes x NE 128 x NFREQ 44:"
          " kernel %.2f ms, plain %.2f ms, max rel err %.3e, max abs err "
          "%.3e (max %.3e) [%s]"
          % (cells, full_sol.nsize, ms_k, ms_p, rel, abs_err,
             float(tot_p.max()), report["card"]), flush=True)


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
    report["launches"] = launches
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

    # ---- phase 2: build
    t0 = time.time()
    _build.library("a2e")
    secs, log = _build.build_log.get("a2e", (time.time() - t0, "cached"))
    print("phase 2: built csrc/a2e.cu in %.2f s; nvcc says:\n%s"
          % (secs, log.strip()), flush=True)

    work = os.path.join(HERE, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(args.seed)
    try:
        kernel_phase(dev, work, rng, report)
        pipeline_phase(dev, work, args, report)
        rt_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "a2e_all_sizes", "route": "cuda",
        "source": "soc_tpu_torch/csrc/a2e.cu",
        "replaces": "soc_tpu/solve/pallas_a2e.py:111",
        "launches": report["launches"],
        "max_abs_err": report["max_abs_err"],
        "ms": report["ms"], "plain_ms": report["plain_ms"]}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
