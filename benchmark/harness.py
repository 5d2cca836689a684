"""The benchmark of soc_tpu_torch on NVIDIA GPUs, driven by data.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

BENCHMARK.json (the repository's root) names the cells. A cell names a
configuration, whose file under benchmark/configs/ holds the model and
names its writer (benchmark/writers/<writer>.py), and a traffic mix
(benchmark/traffic/<traffic>.json: the verb, the dust kind, the ini
keywords, the set-up runs, the processes and the checks). A verb's driver
is benchmark/verbs/<verb>.py, a check benchmark/checks/<check>.py (its
numbers, its run and its control), a per-layer metric's reader
benchmark/metrics/<metric>.py (a metric split by cell kind, <name>.<kind>,
may share the reader <name>.py), and a cell's limits and reference sizes
benchmark/cells/<cell>.json. A new cell, verb, check or metric adds files
and entries only. The port builds its CUDA kernels into
soc_tpu_torch/_build inside the checkout, at a fixed path.

A run: set-up writes the model from the seed into a work directory under
TMPDIR and runs the traffic's set-up runs and one whole warm-up run (the
A2E solver file, the kernels' builds, the pools); setup_s ends there,
counted from the process's start. The window then repeats whole runs of
the verb through the functions its CLI calls (benchmark/verbs/), a new
ini seed a run, until --seconds have passed, and ends at the end of the
last run: run_s is the window's seconds over its runs, packets_per_s every
photon packet its runs traced over its seconds. With --trace 1 the first
run of the window runs under torch.profiler (device activity only, kept in
memory) with the harness's spans around the layers' entry points, and the
cell's per-layer metrics are read from the window's runs and that
profile. After the window the peak device memory is read, the program's
state is freed, and the checks compare one run of the window, drawn from
the seed, with the plain reference (benchmark/reference/); each number is
printed beside its limit.
"""

import argparse
import gc
import importlib.util
import json
import math
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "soc_tpu")
PEAK_FP32_FLOPS = 67.0e12           # NVIDIA H100 SXM, outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


class BenchError(Exception):
    """A run that cannot give a result; the message says why."""


def load_json(path):
    with open(path) as fp:
        return json.load(fp)


def load_module(path, name):
    """A benchmark file by its path (metric and check names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_modules = {}


def bench_module(kind, name):
    """benchmark/<kind>/<name>.py (a verb, a check, a metric's reader or a
    writer), found by its name and loaded once."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if kind == "metrics" and not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH_DIR, kind, name.rsplit(".", 1)[0] + ".py")
    if path not in _modules:
        if not os.path.exists(path):
            raise BenchError("no %s file for %r" % (kind, name))
        _modules[path] = load_module(path, "benchmark.%s.%s" % (kind, name))
    return _modules[path]


def cell_spec(workload):
    """(cell, config, traffic, cell file, spec) of a workload, each found
    by its name; raises BenchError for a name BENCHMARK.json lacks."""
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchError("no BENCHMARK.json at %s" % ROOT)
    spec = load_json(path)
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise BenchError("no workload %r in BENCHMARK.json" % workload)
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     cell["traffic"] + ".json"))
    cfile = load_json(os.path.join(BENCH_DIR, "cells", workload + ".json"))
    return cell, config, traffic, cfile, spec


def seed_value(seed, k):
    """The ini's `seed` of run k: a float in [0, 1) from the run's seed."""
    return ((int(seed) * 1000003 + 7919 * k) % (1 << 31)) / float(1 << 31)


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError:
        return "nvidia-smi not available"
    return out.stdout.strip().replace("\n", "; ") or "not reported"


# ---------------------------------------------------------------- spans

class Spans:
    """Host-clock spans (time.time_ns, the profiler's clock) around the
    layers' entry points, installed by wrapping module attributes and
    taken out again by close()."""

    def __init__(self):
        self.spans = []             # (name, start_ns, end_ns)
        self._undo = []
        self.on = False

    def wrap(self, module, attr, name, sync=None):
        orig = getattr(module, attr)
        spans = self

        def wrapped(*a, **kw):
            if not spans.on:
                return orig(*a, **kw)
            if sync:
                sync()
            t0 = time.time_ns()
            try:
                return orig(*a, **kw)
            finally:
                if sync:
                    sync()
                spans.spans.append((name, t0, time.time_ns()))
        setattr(module, attr, wrapped)
        self._undo.append((module, attr, orig))

    def close(self):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo = []

    def of(self, name):
        return [(a, b) for n, a, b in self.spans if n == name]


def install_spans(spans, torch):
    """The harness's spans: the verbs' stages, the transport passes, the
    A2E solve (synchronised, so its kernels lie inside it), the file
    writes and the process group's collectives."""
    from soc_tpu_torch.parallel import dist
    from soc_tpu_torch.pipeline import driver, full
    from soc_tpu_torch.solve import stochastic

    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    spans.wrap(driver, "simulate_background", "background")
    spans.wrap(driver, "simulate_cell_emission", "cell_emission")
    spans.wrap(driver, "_render_phase", "maps")
    spans.wrap(driver, "write_cell_frequency_array", "write")
    spans.wrap(driver, "write_cell_field", "write")
    spans.wrap(full, "write_cell_frequency_array", "write")
    spans.wrap(full, "build_components", "a2e_prep")
    spans.wrap(stochastic, "solve_emission", "a2e_solve", sync=sync)
    for name in ("barrier", "gather_objects", "share", "broadcast", "move"):
        if hasattr(dist, name):
            spans.wrap(dist, name, "collective")


# ------------------------------------------------------------ profiling

def device_intervals(prof):
    """[(name, start_ns, end_ns)] of the device's operations (kernels,
    copies, sets) in a torch.profiler run, from its raw events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns()))
    return out


def union_ns(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between the merged intervals as (start, end)."""
    iv = sorted(intervals)
    if not iv:
        return 0, []
    busy, gaps = 0, []
    s0, e0 = iv[0]
    for s, e in iv[1:]:
        if s > e0:
            busy += e0 - s0
            gaps.append((e0, s))
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    return busy + e0 - s0, gaps


# -------------------------------------------------------------- the cell

class Cell:
    """One cell's model, ini and verb in its work directory."""

    def __init__(self, workload, seed, device, spec_parts, workdir):
        self.cell, self.config, self.traffic, self.cfile, self.spec = \
            spec_parts
        self.workload, self.seed, self.device = workload, int(seed), device
        self.workdir = workdir
        self.ini_path = os.path.join(workdir, "my.ini")
        self.model = dict(self.config["model"])
        self.ini = {}
        self.lines = []

    def write_model(self):
        mod = bench_module("writers", self.config.get("writer", "grid_model"))
        self.lines = mod.write(self.workdir, self.model,
                               self.traffic["dust"], self.seed)

    def write_ini(self, k, extra=None):
        """my.ini of run k: the model's lines, the traffic's keywords (a
        keyword of both takes the traffic's value), `seed`, and extra."""
        from benchmark.writers.grid_model import ini_text
        kw = dict(self.lines)
        kw.update(self.traffic.get("ini", {}))
        kw.update(extra or {})
        kw = {key: v for key, v in kw.items() if v is not False}
        kw["seed"] = repr(seed_value(self.seed, k))
        self.ini = kw
        with open(self.ini_path, "w") as fp:
            fp.write(ini_text(list(kw.items())))

    def run_once(self, k, extra=None):
        """One whole run of the verb; returns (summary, products)."""
        import torch
        self.write_ini(k, extra)
        verb = bench_module("verbs", self.traffic["verb"])
        stages, products, grid = verb.run(self.ini_path, self.device)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        return summarize(stages, grid), products


def summarize(stages, grid):
    """The numbers a run's per-layer metrics read."""
    src = [dict(source=p["source"], packets=int(p["packets"]),
                seconds=float(p["seconds"])) for s in stages
           for p in s.source_passes]
    cel = [dict(packets=int(p["packets"]), seconds=float(p["seconds"]))
           for s in stages for p in s.cell_passes]
    timings = [dict(s.timings) for s in stages]
    leaves = int((grid.dens > 0).sum().item())
    return dict(source_passes=src, cell_passes=cel,
                packets=sum(p["packets"] for p in src + cel),
                timings=timings, leaves=leaves)


# ---------------------------------------------------------------- a run

def execute(workload, seed, seconds, trace, device="cuda", parts=None,
            workdir=None, t_start=None, log=None):
    """Set-up, window, checks of one run; returns the result's dict (the
    last line the benchmark prints). ``parts`` replaces the cell's files
    (tests run small configurations on the CPU)."""
    import torch
    t_start = time.time() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    parts = parts or cell_spec(workload)
    cell = parts[0]
    chips = int(cell["chips"])
    cuda = torch.device(device).type == "cuda"
    from soc_tpu_torch.parallel import dist
    dist.maybe_initialize()
    rank = dist.process_index()
    if workdir is None:
        workdir = os.path.join(tempfile.gettempdir(), "soc_bench",
                               workload + ("" if rank == 0 else
                                           ".rank%d" % rank))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        return _execute(workload, seed, seconds, trace, device, parts,
                        workdir, t_start, log, chips, cuda, rank, torch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _execute(workload, seed, seconds, trace, device, parts, workdir,
             t_start, log, chips, cuda, rank, torch):
    from soc_tpu_torch.parallel import dist
    c = Cell(workload, seed, device, parts, workdir)
    c.write_model()
    for k, extra in enumerate(c.traffic.get("setup_runs", [])):
        c.run_once(-1 - k, extra)
    c.run_once(0)                        # warm-up: builds, solver, pools
    spans = Spans()
    if trace:
        install_spans(spans, torch)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    log("set-up %.3f s" % setup_s)

    pick = random.Random(int(seed) * 7 + 3)
    runs, kept = [], None
    prof_data = None
    t0 = time.perf_counter()
    k = 0
    while True:
        k += 1
        if trace and k == 1:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
            spans.on = True
            with profile(activities=acts) as prof:
                w0 = time.time_ns()
                summary, products = c.run_once(k)
                w1 = time.time_ns()
            spans.on = False
            prof_data = (prof, w0, w1)
            # the profiler's own processing is no part of the window
            t0 = time.perf_counter()
        else:
            summary, products = c.run_once(k)
        runs.append(summary)
        log("run %d: %.3f s after the window's start; %s" % (
            k, time.perf_counter() - t0, " ".join(
                "%s=%.3f" % (key, v) for t in summary["timings"]
                for key, v in t.items() if isinstance(v, float))))
        if pick.random() < 1.0 / k:      # a run drawn from the seed
            kept = (k, products)
        products = None
        done = time.perf_counter() - t0 >= seconds
        if dist.process_count() > 1:
            done = dist.share(done)
        if done:
            break
    elapsed = time.perf_counter() - t0
    spans.close()
    log("window %.3f s, %d runs" % (elapsed, len(runs)))

    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    if dist.process_count() > 1:
        peak = max(dist.gather_objects(peak))
    out = dict(correct=False, attempted=len(runs), failed=0)
    profile_view = None
    if prof_data is not None:
        profile_view = read_profile(prof_data, spans)
        prof_data = None
        if dist.process_count() > 1:
            # busy and window averaged over the processes' cards
            got = dist.gather_objects((profile_view["busy_ns"],
                                       profile_view["window_ns"]))
            profile_view["busy_ns"] = sum(b for b, _ in got) / len(got)
            profile_view["window_ns"] = sum(w for _, w in got) / len(got)
    # the program's state goes before the reference runs
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if rank != 0:
        return None

    checks = run_checks(c, kept, device, log)
    correct = bool(checks) and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    out["correct"] = correct
    metrics = {}
    if not trace:
        packets = sum(r["packets"] for r in runs)
        metrics["run_s"] = dict(value=elapsed / len(runs), unit="s")
        metrics["packets_per_s"] = dict(value=packets / elapsed,
                                        unit="packets/s")
        metrics["setup_s"] = dict(value=setup_s, unit="s")
    else:
        metrics = read_layer_metrics(c, runs, profile_view)
    out["metrics"] = metrics
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=chips, memory_peak_bytes=peak)
    if profile_view is not None:
        dev["busy_s"] = profile_view["busy_ns"] / 1e9
        dev["window_s"] = profile_view["window_ns"] / 1e9
        out["breakdown"] = profile_view["breakdown"]
    out["device"] = dev
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log("check %s %r limit %r" % (k, v, lim))
    return out


def read_profile(prof_data, spans):
    """The profiled run's device intervals, busy and window lengths, the
    A2E span's kernel time and the breakdown (the ten operations with the
    most device time, the ten longest idle gaps by the innermost host
    span around them)."""
    prof, w0, w1 = prof_data
    iv = [x for x in device_intervals(prof) if x[2] > w0 and x[1] < w1]
    busy, gaps = union_ns([(max(s, w0), min(e, w1)) for _, s, e in iv])
    by_name = {}
    for name, s, e in iv:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    ops = [(short_name(n), t) for n, t in ops]
    if iv:
        gaps = [(w0, min(s for _, s, _ in iv))] + gaps + [
            (max(e for _, _, e in iv), w1)]
    else:
        gaps = [(w0, w1)]
    labelled = []
    for a, b in gaps:
        mid = (a + b) // 2
        inner = [(n, s, e) for n, s, e in spans.spans if s <= mid <= e]
        label = min(inner, key=lambda x: x[2] - x[1])[0] if inner \
            else "host"
        labelled.append((label, (b - a) / 1e9))
    labelled.sort(key=lambda x: -x[1])
    a2e = []
    for s, e in spans.of("a2e_solve"):
        a2e.append(union_ns([(max(a, s), min(b, e)) for n, a, b in iv
                             if b > s and a < e and not is_copy(n)])[0])
    return dict(busy_ns=busy, window_ns=w1 - w0, spans=spans,
                a2e_kernel_ns=a2e,
                breakdown=dict(device_ops=[[n, t / 1e9] for n, t in ops],
                               idle_gaps=[[n, t] for n, t in labelled[:10]]))


def short_name(name, width=120):
    """A kernel's name without 'void ', cut to ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def is_copy(name):
    n = name.lower()
    return n.startswith("memcpy") or n.startswith("memset")


def read_layer_metrics(c, runs, profile_view):
    """Every per-layer metric of the cell whose reader finds something."""
    out = {}
    timed = runs[1:] if len(runs) > 1 else runs   # not the profiled run
    view = dict(cell=c.cell, config=c.config, traffic=c.traffic,
                runs=timed, profiled_run=runs[0], profile=profile_view,
                peak_flops=PEAK_FP32_FLOPS, peak_bytes=PEAK_HBM_BYTES)
    for m in c.spec["per_layer"]:
        if "workloads" in m and c.workload not in m["workloads"]:
            continue
        v = bench_module("metrics", m["name"]).read(view)
        if v is not None:
            out[m["name"]] = dict(value=float(v), unit=m["unit"])
    return out


def run_checks(c, kept, device, log):
    """{number: (value, limit)} of the traffic's checks on the kept run."""
    if kept is None:
        return {}
    k, products = kept
    limits = c.cfile["limits"]
    ctx = dict(workdir=c.workdir, ini=c.ini, model=c.model,
               seed=c.seed, run=k, device=device, products=products,
               cfile=c.cfile)
    out = {}
    for name in c.traffic["checks"]:
        t = time.time()
        for key, val in bench_module("checks", name).run(ctx).items():
            out[key] = (float(val), float(limits[key]))
        log("check stage %s %.3f s" % (name, time.time() - t))
    return out


# ------------------------------------------------------------ processes

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(argv, n):
    """Ranks 1..n-1 of a cell over n processes, one card each; this
    process is rank 0 on card 0. Returns the child processes."""
    port = free_port()
    base = dict(os.environ, SOC_TPU_COORDINATOR="127.0.0.1:%d" % port,
                SOC_TPU_NUM_PROCESSES=str(n))
    os.environ.update(SOC_TPU_COORDINATOR=base["SOC_TPU_COORDINATOR"],
                      SOC_TPU_NUM_PROCESSES=str(n), SOC_TPU_PROCESS_ID="0",
                      SOC_TPU_LOCAL_DEVICE_IDS="0")
    procs = []
    for r in range(1, n):
        env = dict(base, SOC_TPU_PROCESS_ID=str(r),
                   CUDA_VISIBLE_DEVICES=str(r), BENCH_RANK=str(r))
        env.pop("SOC_TPU_LOCAL_DEVICE_IDS", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(BENCH_DIR, "run.py")] + argv,
            env=env, stdout=subprocess.DEVNULL))
    return procs


def stop_ranks(procs, timeout=120):
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    return rcs


# ------------------------------------------------------------------ main

def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (sys.modules'),
    each compared whole: soc_tpu_torch is not soc_tpu."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def verdict(rank, rcs, names=None):
    """A process's exit code once the window has closed: 4 where it holds
    a forbidden module (``names``, sys.modules' by default), 5 where a
    rank it started exited otherwise than 0 (a rank's 4 among them), else
    0; the cause goes to standard error."""
    bad = forbidden_modules(names)
    if bad:
        print("benchmark: rank %s loaded %s" % (rank, ", ".join(bad)),
              file=sys.stderr)
        return 4
    if any(rcs):
        print("benchmark: a rank exited with %s" % rcs, file=sys.stderr)
        return 5
    return 0


def main(argv, t_start):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    child = "BENCH_RANK" in os.environ
    try:
        parts = cell_spec(args.workload)
    except BenchError as e:
        print("benchmark: %s" % e, file=sys.stderr)
        return 2
    import torch
    chips = int(parts[0]["chips"])
    if not child:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print("benchmark: the cell needs %d CUDA device(s); %d visible"
                  % (chips, torch.cuda.device_count()
                     if torch.cuda.is_available() else 0), file=sys.stderr)
            return 3
        print("card: %s" % card_line(), file=sys.stderr, flush=True)
    nproc = int(parts[2].get("processes", 1))
    procs = start_ranks(argv, nproc) if nproc > 1 and not child else []
    try:
        out = execute(args.workload, args.seed, args.seconds, args.trace,
                      parts=parts, t_start=t_start)
    finally:
        rcs = stop_ranks(procs)
    rc = verdict(os.environ.get("BENCH_RANK", "0"), rcs)
    if rc or child:
        return rc
    print(json.dumps(out))
    return 0
