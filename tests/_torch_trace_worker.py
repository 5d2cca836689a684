"""One process of tests/test_torch_trace.py's two-process group.

    python _torch_trace_worker.py <coordinator> <nproc> <rank>

Each rank joins the gloo group, then twice gathers two arrays with
dist.gather_objects, rank 1 sleeping 0.2 s before it once rank 0 has
posted (through the group's store) that it is about to arrive: first with the
tracer started and stopped by hand (the records then gathered to rank 0
outside tracing), then inside a run that records itself under
torch.profiler (trace.run), whose `dist.*` spans rank 1 posts to the
group's store and rank 0 finds through trace.profiled(). Rank 0 prints
"RESULT <json>": per way, the wait by trace.collective_waits, the spans'
bytes and seq, and the arrays' nbytes.
"""

import json
import sys
import time

import numpy as np
import torch

SLEEP = 0.2


def gather(rank, key):
    from soc_tpu_torch.parallel import dist
    arrays = [np.zeros((64, 8), np.float32), {"t": torch.zeros(100)}]
    if rank == 0:
        dist.post(key, True)
    else:
        while dist.fetch(key) is None:
            time.sleep(0.005)
        time.sleep(SLEEP)
    dist.gather_objects(arrays)
    return 64 * 8 * 4 + 100 * 4


def summary(by_rank):
    from soc_tpu_torch.utils import trace
    own = by_rank[0]
    return dict(wait=trace.collective_waits(by_rank),
                names=[r["name"] for r in own],
                bytes=[r["attrs"]["bytes"] for r in own],
                seq=[r["attrs"]["seq"] for r in own],
                ranks=sorted(by_rank))


def main():
    coord, nproc, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    from torch.profiler import ProfilerActivity, profile
    from soc_tpu_torch.parallel import dist
    from soc_tpu_torch.utils import trace
    dist.initialize(coordinator=coord, num_processes=nproc,
                    process_id=rank, local_device_ids=[0])
    out = {}

    trace.start()
    nbytes = gather(rank, "arrive.by_hand")
    mine = trace.stop()["spans"]
    every = dist.gather_objects(mine)
    out["by_hand"] = summary(dict(enumerate(every)))

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.run("driver.run"):
            gather(rank, "arrive.followed")
    dist.barrier()          # rank 1 has posted its spans
    rec = trace.profiled()
    if rank == 0:
        out["followed"] = summary(rec["ranks"])
        out["nbytes"] = nbytes
        out["enabled_after"] = trace.enabled()
        print("RESULT " + json.dumps(out), flush=True)
    dist.barrier()


if __name__ == "__main__":
    main()
