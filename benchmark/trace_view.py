"""One cell's traced run read against the program's own spans: what the
harness's breakdown cannot show yet.

    python3 benchmark/trace_view.py --workload <cell> --seed <n> --out DIR

Set-up as the harness makes it (the model from the seed, the traffic's
set-up runs, one warm-up run), then one whole run under torch.profiler
(device activity) with the harness's spans installed and the program's
tracer (soc_tpu_torch/utils/trace.py) started by hand. A cell over
several processes starts its other ranks as the harness does. Each rank
writes DIR/<cell>.rank<k>.json: its spans and counters, and read against
its device intervals: the idle gaps labelled by the innermost program or
harness span over their midpoints, each transport pass's kernels a packet
and the share of the device time within half a second of it that lies
inside it (the shared clock: a skew would move kernels out), whether the
A2E kernel lies inside the `a2e.kernel` span, the A2E stage's parts, the
readback against the writes. Process 0 adds,
for each collective it waited at for 50 ms or more, the rank that arrived
last and the innermost span open on that rank just before it arrived,
and prints its summary as one JSON line.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402

GAP_NS = 50_000_000
MARGIN_NS = 500_000_000


def innermost(spans, t):
    """Name of the shortest (name, start, end) span over time t, or
    'host'."""
    inner = [x for x in spans if x[1] <= t <= x[2]]
    return min(inner, key=lambda x: x[2] - x[1])[0] if inner else "host"


def read_rank(records, harness_spans, iv, w0, w1):
    """The rank's reading of one profiled run (the module's docstring)."""
    spans = records["spans"]
    both = [(r["name"], r["start_ns"], r["end_ns"]) for r in spans] + \
        list(harness_spans)
    busy, gaps = harness.union_ns([(max(s, w0), min(e, w1))
                                   for _, s, e in iv])
    if iv:
        gaps = [(w0, min(s for _, s, _ in iv))] + gaps + [
            (max(e for _, _, e in iv), w1)]
    labelled = sorted(((innermost(both, (a + b) // 2), (b - a) / 1e9)
                       for a, b in gaps), key=lambda x: -x[1])
    kernels = [(n, s, e) for n, s, e in iv if not harness.is_copy(n)]
    passes = []
    for r in spans:
        if r["name"] != "transport.pass":
            continue
        s0, e0 = r["start_ns"], r["end_ns"]
        inside = [k for k in kernels if s0 <= k[1] <= e0]
        lo, hi = s0 - MARGIN_NS, e0 + MARGIN_NS
        dev = [(max(s, lo), min(e, hi)) for _, s, e in iv
               if e > lo and s < hi]
        all_ns = harness.union_ns(dev)[0]
        in_ns = harness.union_ns([(max(s, s0), min(e, e0)) for s, e in dev
                                  if e > s0 and s < e0])[0]
        packets = r["attrs"].get("packets") or 0
        passes.append(dict(
            source=r["attrs"].get("source"), packets=packets,
            seconds=(e0 - s0) / 1e9, kernels=len(inside),
            kernels_per_packet=len(inside) / packets if packets else None,
            device_share_inside=in_ns / all_ns if all_ns else None))
    out = dict(busy_s=busy / 1e9, window_s=(w1 - w0) / 1e9,
               idle_gaps=labelled[:15], passes=passes,
               counters=records["counters"])
    a2e = [k for k in kernels if "a2e_all_sizes" in k[0]]
    spans_k = [r for r in spans if r["name"] == "a2e.kernel"]
    if a2e and spans_k:
        r = spans_k[0]
        out["a2e_kernel"] = dict(
            inside=all(r["start_ns"] <= s and e <= r["end_ns"]
                       for _, s, e in a2e),
            lead_ms=(min(s for _, s, _ in a2e) - r["start_ns"]) / 1e6,
            tail_ms=(r["end_ns"] - max(e for _, _, e in a2e)) / 1e6,
            kernel_ms=sum(e - s for _, s, e in a2e) / 1e6)

    def total(name):
        return sum((r["end_ns"] - r["start_ns"]) / 1e9 for r in spans
                   if r["name"] == name)

    from soc_tpu_torch.utils import trace
    out["parts_s"] = {n: total(n) for n in sorted({r["name"] for r in
                                                   spans})}
    out["a2e_host_s"] = trace.self_s(spans, "a2e.stage", "a2e.kernel")
    out["readback_s"] = trace.union_s(spans, "driver.readback")
    out["write_s"] = trace.union_s(spans, "io.write")
    nbytes = sum(r["attrs"].get("bytes", 0) for r in spans
                 if r["name"] == "io.write")
    out["write_mb"] = nbytes / 1e6
    out["write_mb_per_s"] = nbytes / 1e6 / out["write_s"] \
        if out["write_s"] else None
    out["dist_mb"] = sum(r["attrs"].get("bytes", 0) for r in spans
                         if r["name"].startswith("dist.")) / 1e6
    return out


def last_arrivals(by_rank):
    """For process 0's collectives of 50 ms or more: the rank that arrived
    last and the innermost span open on it 1 ms before it arrived."""
    out = []
    first = {}
    for rank, spans in by_rank.items():
        for r in spans:
            if r["name"].startswith("dist."):
                first.setdefault(r["attrs"]["seq"], {})[rank] = r
    for r in by_rank[0]:
        if not r["name"].startswith("dist.") or \
                r["end_ns"] - r["start_ns"] < GAP_NS:
            continue
        arr = first[r["attrs"]["seq"]]
        late = max(arr, key=lambda k: arr[k]["start_ns"])
        t = arr[late]["start_ns"] - 1_000_000
        doing = innermost([(x["name"], x["start_ns"], x["end_ns"])
                           for x in by_rank[late]], t)
        out.append(dict(op=r["name"], seq=r["attrs"]["seq"],
                        span_s=(r["end_ns"] - r["start_ns"]) / 1e9,
                        wait_s=max(0, arr[late]["start_ns"]
                                   - r["start_ns"]) / 1e9,
                        last_rank=late, last_was_in=doing))
    return out


def rank_main(args):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from soc_tpu_torch.parallel import dist
    from soc_tpu_torch.utils import trace
    t_start = time.time()
    dist.maybe_initialize()
    rank = dist.process_index()
    parts = harness.cell_spec(args.workload)
    workdir = tempfile.mkdtemp(prefix="trace_view_")
    try:
        c = harness.Cell(args.workload, args.seed, "cuda", parts, workdir)
        c.write_model()
        for k, extra in enumerate(c.traffic.get("setup_runs", [])):
            c.run_once(-1 - k, extra)
        c.run_once(0)
        spans = harness.Spans()
        harness.install_spans(spans, torch)
        torch.cuda.synchronize()
        setup_s = time.time() - t_start
        spans.on = True
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace.start()
            w0 = time.time_ns()
            c.run_once(1)
            w1 = time.time_ns()
            records = trace.stop()
        spans.on = False
        spans.close()
        iv = [x for x in harness.device_intervals(prof)
              if x[2] > w0 and x[1] < w1]
        out = read_rank(records, spans.spans, iv, w0, w1)
        out.update(rank=rank, setup_s=setup_s, card=harness.card_line())
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "%s.rank%d.json" % (
                args.workload, rank)), "w") as fp:
            json.dump(dict(out, spans=records["spans"]), fp)
        if dist.process_count() > 1:
            every = dist.gather_objects(records["spans"])
            if rank == 0:
                out["last_arrivals"] = last_arrivals(dict(enumerate(every)))
                out["dist_wait_s"] = trace.collective_waits(
                    {k: [r for r in v if r["name"].startswith("dist.")]
                     for k, v in enumerate(every)})
        if rank == 0:
            print(json.dumps(out))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    nproc = int(harness.cell_spec(args.workload)[2].get("processes", 1))
    procs = []
    if nproc > 1 and "BENCH_RANK" not in os.environ:
        port = harness.free_port()
        base = dict(os.environ, SOC_TPU_COORDINATOR="127.0.0.1:%d" % port,
                    SOC_TPU_NUM_PROCESSES=str(nproc))
        os.environ.update(SOC_TPU_COORDINATOR=base["SOC_TPU_COORDINATOR"],
                          SOC_TPU_NUM_PROCESSES=str(nproc),
                          SOC_TPU_PROCESS_ID="0",
                          SOC_TPU_LOCAL_DEVICE_IDS="0")
        for r in range(1, nproc):
            env = dict(base, SOC_TPU_PROCESS_ID=str(r),
                       CUDA_VISIBLE_DEVICES=str(r), BENCH_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)] + argv,
                env=env, stdout=subprocess.DEVNULL))
    try:
        return rank_main(args)
    finally:
        rcs = harness.stop_ranks(procs)
        if any(rcs):
            print("trace_view: a rank exited with %s" % rcs,
                  file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
