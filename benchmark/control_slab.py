"""The control of the slab cells' checks (benchmark/control.py's pattern
for a cell lit by a star, with ALI's cell pass): the reference's own
passes stand in for the program's (the star's absorbed energy, the
temperatures and emission it gives, the cell pass of that emission, the
final temperatures and emission), and each of the traffic's checks then
computes the program's side as the reference in bfloat16 (its
control()), judged against the float64 reference. The control has to
fail at least one of a cell's numbers.

    python3 benchmark/control_slab.py --workload <cell> --seed <n> [...]

prints one JSON line of the numbers and their limits a seed; the
benchmark's own runs never run it (benchmark/tests/
test_benchmark_trust_slab.py holds it at a small size on the CPU).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def control(workload, seed, device, parts=None):
    """{number: value} of the control on the cell's model of ``seed``,
    written into a temporary directory that is removed afterwards."""
    workdir = tempfile.mkdtemp(prefix="soc_bench_control_")
    try:
        return _control(workload, seed, device, parts, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def emission(ctx, t):
    """The program's emission of temperatures t: a refined cell at 10 K,
    the channels outside `remit` zero."""
    from benchmark.checks.common import model
    from benchmark.frozen.constants import um2f
    from benchmark.reference import temperature as rtemp
    cloud, optics, _ = model(ctx)
    t = np.where(cloud.dens > 0, t, 10.0)
    e = rtemp.emission(optics.freq, optics.abs_gl,
                       float(ctx["ini"]["gridlength"]), t)
    lo, hi = (float(v) for v in ctx["ini"]["remit"])
    band = (optics.freq >= um2f(hi)) & (optics.freq <= um2f(lo))
    return t, e * band[None, :]


def _control(workload, seed, device, parts, workdir):
    from benchmark.checks import cell_emission, point, slab_temperature
    parts = parts or harness.cell_spec(workload)
    c = harness.Cell(workload, seed, device, parts, workdir)
    c.write_model()
    c.write_ini(1)
    ctx = dict(workdir=workdir, ini=c.ini, model=c.model, seed=seed, run=1,
               device=device, cfile=c.cfile)
    star = point.reference(ctx)
    ones = np.ones_like(star)
    _, emit = emission(ctx, slab_temperature.solve(ctx, star, ones))
    tabs, xab = cell_emission.reference(ctx, emit)
    beta = slab_temperature.escape(ctx, emit, xab)
    t, final = emission(ctx, slab_temperature.solve(ctx, star + tabs, beta))
    ctx.update(run=2,           # the control's own packets and samples
               products=dict(ps_tabs=star, temperature=t, emitted=final,
                             cell=[dict(emit=emit, tabs=tabs, xab=xab)]))
    out = {}
    for name in c.traffic["checks"]:
        out.update(harness.bench_module("checks", name).control(ctx))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    parts = harness.cell_spec(args.workload)
    limits = parts[3]["limits"]
    for seed in args.seed:
        t = time.time()
        nums = control(args.workload, seed, "cuda", parts)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              seconds=time.time() - t,
                              numbers={k: dict(value=v, limit=limits[k])
                                       for k, v in nums.items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
