"""The control of the checks: the reference put in the program's place in
bfloat16, the precision below the program's float32 (the background
Monte Carlo's weights and tallies at the program's packet count, the A2E
solve, the map's integral, the temperatures' energies), each judged by
the cell's checks against the float64 reference. The control has to fail
at least one of a cell's numbers.

    python3 benchmark/control.py --workload <cell> --seed <n> [...]

prints one JSON line of the numbers and their limits a seed; the
benchmark's own runs never run it (benchmark/tests/test_benchmark_control.py
holds it at a small size on the CPU and at the cell's size on the card).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

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


def _control(workload, seed, device, parts, workdir):
    """The reference's own outputs stand in for the program's: its
    background tally (float64), the equilibrium temperatures and emission
    of that tally; each of the traffic's checks then computes the
    program's side as the reference in bfloat16 (its control())."""
    from benchmark.checks.common import model, payload
    from benchmark.reference import temperature as rtemp
    parts = parts or harness.cell_spec(workload)
    c = harness.Cell(workload, seed, device, parts, workdir)
    c.write_model()
    c.write_ini(1)
    ctx = dict(workdir=workdir, ini=c.ini, model=c.model, seed=seed, run=1,
               device=device, cfile=c.cfile)
    cloud, optics, _ = model(ctx)
    absorbed = harness.bench_module("checks", "absorbed")
    ref = absorbed.reference(ctx, int(c.cfile["reference_packets_per_freq"]))
    # the background packets a channel the program traces for bgpackets
    # (SOC's rule: 8 * area * batch, batch rounded from bgpackets)
    area = 2 * (cloud.nx * cloud.ny + cloud.nx * cloud.nz
                + cloud.ny * cloud.nz)
    batch = max(1, int(round(float(c.ini["bgpackets"]) / (8.0 * area))))
    gl = float(c.ini["gridlength"])
    pay = payload(cloud, ref, gl)
    t = rtemp.temperatures(optics.freq, optics.abs_gl, gl, pay)
    ctx.update(run=2,           # the control's own packets and samples
               reference_raw=ref, program_packets=8 * area * batch,
               products=dict(absorbed=pay, temperature=t,
                             emitted=rtemp.emission(optics.freq,
                                                    optics.abs_gl, gl, t)))
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
