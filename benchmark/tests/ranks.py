"""Runs a cell's processes on the CPU (gloo) at a test's size:
python ranks.py <cell> <fault> starts four ranks of itself; a rank runs
harness.execute with the fault of benchmark/tests/faults.py planted and
exits with harness.verdict's code, as the benchmark's ranks do; rank 0
prints the result's line where its code is 0. The exit code is the
largest of the ranks'."""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def rank_main(cell, fault):
    from benchmark import harness
    from benchmark.tests import faults, tiny
    rank = os.environ["SOC_TPU_PROCESS_ID"]
    undo = faults.plant(fault)
    try:
        out = tiny.run(cell, workdir=os.path.join(
            os.environ["RANKS_WORKDIR"], "rank" + rank))
        rc = harness.verdict(rank, [])
    finally:
        undo()
    if out is not None and rc == 0:
        print(json.dumps(out))
    return rc


def main(cell, fault, n=4):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    workdir = tempfile.mkdtemp(prefix="soc_bench_ranks_")
    procs = []
    for r in range(n):
        env = dict(os.environ, SOC_TPU_COORDINATOR="127.0.0.1:%d" % port,
                   SOC_TPU_NUM_PROCESSES=str(n), SOC_TPU_PROCESS_ID=str(r),
                   SOC_TPU_LOCAL_DEVICE_IDS="0", RANKS_CHILD="1",
                   RANKS_WORKDIR=workdir)
        procs.append(subprocess.Popen([sys.executable, __file__, cell, fault],
                                      env=env))
    try:
        return max(p.wait(timeout=540) for p in procs)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    if os.environ.get("RANKS_CHILD"):
        sys.exit(rank_main(sys.argv[1], sys.argv[2]))
    else:
        sys.exit(main(sys.argv[1], sys.argv[2]))
