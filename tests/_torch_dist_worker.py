"""One process of tests/test_torch_dist.py's two-process group.

    python _torch_dist_worker.py <coordinator> <nproc> <rank> <mode>

mode "mesh": joins the group with four CPU shards on rank 0 and two on
rank 1 (initialize twice: it is idempotent), then prints "RESULT <json>"
with the global device list's owners and sha256 digests of what the
collectives of a six-shard mesh give (mesh_digests); mode "raise": rank 1
raises after joining, rank 0 waits at a barrier.
"""

import hashlib
import json
import sys

import numpy as np
import torch

CELLS = 1000
NFREQ = 4


def digest(t):
    a = np.ascontiguousarray(np.asarray(t))
    return hashlib.sha256(a.tobytes()).hexdigest()[:20]


def mesh_digests(pm):
    """Digests of fold_intf, reduce_intf, gather_shards and the solves'
    gather over mesh ``pm``: every shard's slab and pass partial made from
    a seed of its own, so any process can make any shard's."""
    from soc_tpu_torch.parallel import product
    from soc_tpu_torch.solve import equilibrium
    slabs, parts = pm.zeros_intf(CELLS), pm.zeros_intf(CELLS)
    for i, (s, p) in enumerate(zip(slabs, parts)):
        if pm.mine[i]:
            rng = np.random.default_rng(i)
            s.copy_(torch.as_tensor(rng.random(s.shape, np.float32)))
            p.copy_(torch.as_tensor(rng.random(p.shape, np.float32)))
    pm.fold_intf(slabs, parts)
    folded = pm.reduce_intf(slabs, torch.device("cpu"))
    pm.fold_intf(slabs)
    reduced = pm.reduce_intf(slabs, torch.device("cpu"))
    vecs = pm.gather_shards([
        np.random.default_rng(100 + i).random(NFREQ) if pm.mine[i] else None
        for i in range(len(pm.devices))])
    total = np.zeros(NFREQ)
    for v in vecs:
        total += np.asarray(v)
    freq = np.logspace(11.0, 13.0, NFREQ)
    abs_gl = torch.full((NFREQ,), 0.2)
    temp = torch.as_tensor(np.random.default_rng(7).uniform(
        5.0, 50.0, CELLS).astype(np.float32))
    emit = product.emission(pm, freq, abs_gl, temp, 3.0e16)
    one = equilibrium.emission(freq, abs_gl, temp, 3.0e16)
    return dict(folded=digest(folded), reduced=digest(reduced),
                sum=digest(total), emission=digest(emit),
                emission_equal=bool(torch.equal(emit, one)))


def main():
    coord, nproc, rank, mode = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from soc_tpu_torch.parallel import dist, product
    ids = [0, 1, 2, 3] if rank == 0 else [0, 1]
    dist.initialize(coordinator=coord, num_processes=nproc,
                    process_id=rank, local_device_ids=ids)
    if mode == "raise":
        if rank == 1:
            raise RuntimeError("rank 1 fails")
        dist.barrier()
        return
    dist.initialize(coordinator=coord, num_processes=nproc,
                    process_id=rank, local_device_ids=ids)
    devs, owners = dist.global_devices("cpu")
    pm = product.ProductMesh(len(devs), NFREQ, devs, owners=owners)
    # a mesh of process 0's shards only: process 1 owns none and still
    # takes part in every collective
    pm0 = product.ProductMesh(4, NFREQ, devs[:4], owners=owners[:4])
    out = dict(rank=dist.process_index(), size=dist.process_count(),
               owners=owners, local=len(dist.local_devices("cpu")),
               mine=pm.mine, mesh=mesh_digests(pm),
               mesh0=mesh_digests(pm0))
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
