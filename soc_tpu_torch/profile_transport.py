"""Where the eager transport's time goes: a lane sweep of the absorption run
and one profiled window of it.

    python -m soc_tpu_torch.profile_transport            # on a CUDA device

The model is example_model's soc_example-sized equilibrium-dust model (64^3
cells, 44 frequencies, bgpackets 999999, a 64x64 map), written into
``_profile_work/`` beside the package and removed afterwards.

1. Lane sweep: ``driver.run`` (the `rt` verb's path) SWEEP_REPEATS times
   per pool size, the order of the sizes reversed on every pass so that no
   size always runs first; prints each run's absorption seconds, packets/s
   and peak device memory, then each size's median, min and max.
2. Window: ``driver.simulate_background`` over one packet batch per surface
   element and frequency (8*AREA*NFREQ packets) at the default pool, after
   a warm-up, three times:
   a. unprofiled: its wall seconds;
   b. under torch.profiler with device activity only: its wall seconds and
      the union of the device's kernel and copy intervals, so the busy share
      is device time over the wall time of that same window;
   c. under torch.profiler with host activity too: the counts of kernels and
      aten calls, and the ops with the most device time. The host-side
      profiler slows the host, so this pass's share is printed but is not
      the idle share of an unprofiled run.
Every timing line carries the card's name and power limit.
"""

import os
import shutil
import subprocess
import sys
import time

import torch

from .config import RunConfig
from .io.dust import read_scattering_function, read_simple_dust
from .io.fields import read_background_intensity

from .example_model import write_model
from .io.cloud import read_cloud
from .pipeline import driver
from .transport.medium import medium_from_optics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
NFREQ = 44
SWEEP_LANES = (1 << 20, 1 << 21, 1 << 22)
SWEEP_REPEATS = 3               # host-clock times spread +-40% per call
TABLE_ROWS = 14                 # ops listed in the host+device profile


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "card not reported"


def busy_seconds(events):
    """Union of the device intervals (kernels, copies, sets) in seconds,
    and the number of such intervals; (None, 0) when none were recorded."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events
                if e.device_type.name == "CUDA")
    if not iv:
        return None, 0
    busy, (s0, e0) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > e0:
            busy += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    return (busy + e0 - s0) / 1e6, len(iv)


def lane_sweep(ini, device, card):
    times = {lanes: [] for lanes in SWEEP_LANES}
    for rep in range(SWEEP_REPEATS):
        for lanes in SWEEP_LANES[::-1] if rep % 2 else SWEEP_LANES:
            torch.cuda.reset_peak_memory_stats(device)
            res = driver.run(ini, device=device, lanes=lanes)
            t = res.timings["constant_sources"]
            times[lanes].append(t)
            print("sweep: lanes %8d  packets %d  absorption %.3f s  %.0f "
                  "packets/s  run %.3f s  peak device memory %.3f GB [%s]"
                  % (lanes, res.packets, t, res.packets / t,
                     res.timings["total"],
                     torch.cuda.max_memory_allocated(device) / 1e9, card),
                  flush=True)
    for lanes, ts in times.items():
        print("sweep median: lanes %8d  absorption %.3f s (min %.3f, max "
              "%.3f, %d runs) [%s]" % (lanes, sorted(ts)[len(ts) // 2],
                                       min(ts), max(ts), len(ts), card),
              flush=True)


def load_background(ini, device):
    """(cfg, grid, medium, background intensity) of an equilibrium-dust
    model's ini, the inputs of driver.simulate_background."""
    cfg = RunConfig(ini)
    orig = os.getcwd()
    os.chdir(os.path.dirname(ini))
    try:
        grid = read_cloud(cfg.file_cloud, device, cfg.kdensity)
        opt = read_simple_dust(cfg.file_optical[0], cfg.gl)
        cfg.freq = opt.freq
        dsc, csc = read_scattering_function(cfg.file_scafunc[0], NFREQ, 2500)
        med = medium_from_optics([opt], dsc, csc, device, opt.freq)
        ibg = read_background_intensity(cfg.file_background, NFREQ)
    finally:
        os.chdir(orig)
    return cfg, grid, med, ibg


def window(ini, device, lanes, card):
    from torch.profiler import ProfilerActivity, profile
    cfg, grid, med, ibg = load_background(ini, device)
    cfg.bgpac = 8 * int(grid.area)          # one batch per surface element

    def go():
        tabs = torch.zeros(grid.cells, device=device)
        intf = torch.zeros((grid.cells, NFREQ), device=device)
        out = driver.simulate_background(grid, med, cfg, ibg, tabs, intf,
                                         12345, lanes=lanes,
                                         per_freq_tally=True)
        torch.cuda.synchronize(device)
        return out[-1]

    go()                                    # warm-up
    t0 = time.perf_counter()
    packets = go()
    wall = time.perf_counter() - t0
    print("window: %d packets, %d lanes, unprofiled wall %.3f s (%.0f "
          "packets/s) [%s]" % (packets, lanes, wall, packets / wall, card),
          flush=True)
    for label, acts in (("device-only", [ProfilerActivity.CUDA]),
                        ("host+device", [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            go()
            wall = time.perf_counter() - t0
        busy, nkern = busy_seconds(prof.events())
        share = "not measured (no device events recorded)" if busy is None \
            else "%.3f s busy, share %.3f" % (busy, busy / wall)
        line = "window %s profile: wall %.3f s, device %s, %d device " \
            "intervals (%.2f per packet)" % (label, wall, share, nkern,
                                             nkern / packets)
        if ProfilerActivity.CPU in acts:
            ka = prof.key_averages()
            line += ", %d aten calls" % sum(
                e.count for e in ka if e.key.startswith("aten::"))
            print(line + " [%s]" % card, flush=True)
            print(ka.table(sort_by="self_device_time_total",
                           row_limit=TABLE_ROWS), flush=True)
        else:
            print(line + " [%s]" % card, flush=True)


def main():
    if not torch.cuda.is_available():
        print("profile_transport: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)       # start the allocator before its stats
    card = card_line()
    print("card: %s (torch %s, CUDA %s)" % (card, torch.__version__,
                                            torch.version.cuda), flush=True)
    work = os.path.join(ROOT, "_profile_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        ini = write_model(work, N, kind="eqdust", nfreq=NFREQ, npix=64,
                          bgpac=999999)
        lane_sweep(ini, device, card)
        window(ini, device, driver.DEFAULT_LANES, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
