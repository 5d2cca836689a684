"""The A2E solve's share of its roofline: the least time the card needs
for the operations the solve's shapes call for (benchmark/work.py
a2e_work: the cells, sizes, NE and NFREQ, over 67 TFLOP/s float32, or its
bytes over 3.35 TB/s, whichever is longer) over the device time of every
kernel inside the harness's span around stochastic.solve_emission, in the
profiled run."""

from benchmark.work import a2e_work


def read(view):
    p = view["profile"]
    if p is None or not p["a2e_kernel_ns"]:
        return None
    busy = sum(p["a2e_kernel_ns"]) / 1e9
    if busy <= 0:
        return None
    m = view["config"]["model"]
    r = view["profiled_run"]
    flops, nbytes = a2e_work(r["leaves"], int(m["nsize"]), int(m["ne"]),
                             int(m["nfreq"]))
    bound = max(flops / view["peak_flops"], nbytes / view["peak_bytes"])
    return 100.0 * bound * len(p["a2e_kernel_ns"]) / busy
