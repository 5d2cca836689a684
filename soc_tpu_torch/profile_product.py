"""Where the `devices N` absorption run's time goes, and whether one host
thread per shard keeps several cards busy.

    python -m soc_tpu_torch.profile_product     # on one card or several

The model is profile_transport's (64^3 cells, 44 frequencies, an
equilibrium dust, bgpackets 999999: 43,253,760 packets), written into
``_profile_work/`` beside the package and removed afterwards. The mesh is
every visible card when there are several, else cuda:0 six times
(chip_smoke.py phase 9's dp 3 x freq 2 layout).

1. Full size: the wall seconds of driver.simulate_background with
   per-frequency tallies
   a. in one pool on cuda:0 (no mesh);
   b. over the mesh, the shards' pools stepped in turn, a refill body
      each, in one thread (ProductMesh.map_steps, the port's way);
   c. over the mesh, each shard's pool drained in turn in one thread, and
      each shard's seconds;
   d. over the mesh, a host thread per shard, each draining its pool;
   e. on one card repeated, a host thread and a stream per shard; on
      several cards, the same number of shards all on cuda:0, as (b).
   Each run's TABS is held to (a)'s: the same packets, atomics in another
   order.
2. Window, one packet batch per surface element (8,650,752 packets): (a),
   (b) and (d) under torch.profiler with device activity only; per device
   the union of its kernel and copy intervals over the window's wall, and
   the number of intervals (an eager sweep launches the same kernels
   whatever its pool holds, so the count follows the sweeps of all
   drains).
3. The A2E solve at 262,144 cells x 24 sizes x NE 128 split over the
   mesh's devices (a2e_kernel.solve_all_sizes_sharded), against one
   launch, and against the same split with each shard's input copied just
   before its launch; wall seconds with every card synchronised, median
   of 3 after a warm-up, and equality with the one launch.
Every timing line carries the card's name and power limit.
"""

import copy
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .example_model import gset_solver, synthetic_absorbed, write_model
from .parallel.product import ProductMesh
from .pipeline import driver
from .transport.propagate import drain
from .profile_transport import (N, NFREQ, ROOT, busy_seconds, card_line,
                                load_background)
from .solve import a2e_kernel, stochastic

ONE_CARD_SHARDS = 6
SEED = 12345
REPS = 3


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def absorption(model, pm, map_steps=None):
    """(wall seconds, TABS on cuda:0, packets) of one background run over
    the mesh ``pm`` (None: one pool on cuda:0); ``map_steps`` stands in
    for the mesh's own for this run."""
    cfg, grid, med, ibg = model
    dev = grid.device
    if map_steps is not None:
        pm.map_steps = map_steps
    try:
        tabs = torch.zeros(grid.cells, device=dev)
        intf = pm.zeros_intf(grid.cells) if pm is not None \
            else torch.zeros((grid.cells, NFREQ), device=dev)
        sync_all()
        t0 = time.perf_counter()
        tabs, intf, _, _, packets = driver.simulate_background(
            grid, med, cfg, ibg, tabs, intf, SEED, lanes=driver.DEFAULT_LANES,
            per_freq_tally=True, pmesh=pm)
        if pm is not None:
            intf = pm.reduce_intf(intf, dev)
        sync_all()
        return time.perf_counter() - t0, tabs, packets
    finally:
        if pm is not None:
            pm.__dict__.pop("map_steps", None)


def in_turn(pm, seconds):
    """A map_steps that drains each shard's pool in turn in the calling
    thread, appending each shard's seconds to ``seconds``."""
    def map_steps(fn):
        out = []
        for i, d in enumerate(pm.devices):
            t0 = time.perf_counter()
            with torch.cuda.device(d):
                out.append(drain(fn(i, d)))
                torch.cuda.synchronize(d)
            seconds.append(time.perf_counter() - t0)
        return out
    return map_steps


def thread_per_shard(pm, own_stream):
    """A map_steps that drains each shard's pool in a host thread of its
    own under its device, with ``own_stream`` on a stream of its own
    joined to the device's current stream before and after."""
    def run(fn, i, dev):
        with torch.cuda.device(dev):
            if not own_stream:
                return drain(fn(i, dev))
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = drain(fn(i, dev))
            main.wait_stream(side)
            return out

    def map_steps(fn):
        with ThreadPoolExecutor(len(pm.devices)) as pool:
            futures = [pool.submit(run, fn, i, d)
                       for i, d in enumerate(pm.devices)]
            return [f.result() for f in futures]
    return map_steps


def rel_diff(tabs, ref):
    return float((tabs - ref).abs().max() / ref.abs().max())


def full_size(model, mesh, card):
    dev = model[1].device
    pm = ProductMesh(len(mesh), NFREQ, mesh)
    names = ",".join(str(d) for d in mesh)
    print("mesh %s: dp %d x freq %d" % (names, pm.n_dp, pm.n_freq),
          flush=True)
    t1, ref, packets = absorption(model, None)
    print("full: one pool on %s: %d packets, %.3f s (%.0f packets/s) [%s]"
          % (dev, packets, t1, packets / t1, card), flush=True)
    seconds = []
    runs = [("pools stepped in turn", pm, None),
            ("pools drained in turn", pm, in_turn(pm, seconds)),
            ("a thread per shard", pm, thread_per_shard(pm, False))]
    if len(set(mesh)) == 1:
        runs.append(("a thread and a stream per shard", pm,
                     thread_per_shard(pm, True)))
    else:
        rep = ProductMesh(len(mesh), NFREQ, [dev] * len(mesh))
        runs.append(("all shards on %s, pools stepped in turn" % dev, rep,
                     None))
    for label, mesh_pm, fn in runs:
        t, tabs, _ = absorption(model, mesh_pm, fn)
        print("full: mesh of %d, %s: %.3f s, %.2fx one pool, TABS within "
              "%.2e of its maximum [%s]" % (len(mesh), label, t, t / t1,
                                            rel_diff(tabs, ref), card),
              flush=True)
        if fn is not None and seconds:
            print("full: pools drained in turn, each shard: %s s"
                  % ", ".join("%.3f" % s for s in seconds), flush=True)
            seconds.clear()
    return pm


def window(model, pm, card):
    from torch.profiler import ProfilerActivity, profile
    n = len(pm.devices)
    for label, mesh_pm, fn in (
            ("one pool", None, None),
            ("mesh of %d, pools stepped in turn" % n, pm, None),
            ("mesh of %d, a thread per shard" % n, pm,
             thread_per_shard(pm, False))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall, _, _ = absorption(model, mesh_pm, fn)
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        parts = []
        for idx in sorted({e.device_index for e in events}):
            busy, n = busy_seconds([e for e in events
                                    if e.device_index == idx])
            parts.append("cuda:%d busy %.3f s (share %.3f), %d intervals"
                         % (idx, busy, busy / wall, n))
        print("window: %s, device-only profile: wall %.3f s; %s [%s]"
              % (label, wall, "; ".join(parts) or
                 "device time not measured (no device events recorded)",
                 card), flush=True)


def a2e_split(work, devices, card):
    sol, freq = gset_solver(work, nfreq=NFREQ, nsize=24, ne=128)
    cells = N ** 3
    d0 = devices[0]
    ab = torch.as_tensor(synthetic_absorbed(np.random.default_rng(0), sol,
                                            freq, cells), device=d0)
    stacks = {d: stochastic.get_fused_stacks(sol, d) for d in set(devices)}
    ranges = a2e_kernel.shard_ranges(cells, len(devices))

    def copy_before_launch():
        parts = [a2e_kernel.solve_all_sizes(stacks[d], ab[c0:c1].to(d))[0]
                 for d, (c0, c1) in zip(devices, ranges)]
        return torch.cat([t.to(d0) for t in parts])

    variants = (
        ("one launch on %s" % d0,
         lambda: a2e_kernel.solve_all_sizes(stacks[d0], ab)[0]),
        ("split over %d, inputs copied first (the wrapper)" % len(devices),
         lambda: a2e_kernel.solve_all_sizes_sharded(stacks, ab, None,
                                                    devices, False)[0]),
        ("split over %d, each input copied before its launch"
         % len(devices), copy_before_launch))
    ref = None
    for label, fn in variants:
        fn()
        sync_all()
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            out = fn()
            sync_all()
            ts.append(time.perf_counter() - t0)
        ref = out if ref is None else ref
        print("a2e: %s: %.2f ms (median of %d; min %.2f, max %.2f), equal "
              "to one launch: %s [%s]"
              % (label, 1e3 * sorted(ts)[REPS // 2], REPS, 1e3 * min(ts),
                 1e3 * max(ts), torch.equal(out, ref), card), flush=True)


def main():
    if not torch.cuda.is_available():
        print("profile_product: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    ncards = torch.cuda.device_count()
    mesh = [torch.device("cuda", i) for i in range(ncards)] if ncards > 1 \
        else [dev] * ONE_CARD_SHARDS
    card = card_line()
    print("card: %s (torch %s, CUDA %s, %d card(s))"
          % (card, torch.__version__, torch.version.cuda, ncards), flush=True)
    work = os.path.join(ROOT, "_profile_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        ini = write_model(work, N, kind="eqdust", nfreq=NFREQ, npix=64,
                          bgpac=999999)
        model = load_background(ini, dev)
        small = copy.copy(model[0])
        small.bgpac = 8 * int(model[1].area)   # one batch per surface element
        absorption((small,) + model[1:], None)           # warm-up
        pm = full_size(model, mesh, card)
        window((small,) + model[1:], pm, card)
        a2e_split(work, mesh, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
