"""One process of a multi-process run of the port, for the tests
(tests/test_torch_multiprocess.py, tests/test_torch_dist.py).

    python _torch_mp_worker.py '<json spec>'

spec: {"runs": [argv, ...]} runs each argv through soc_tpu_torch's CLI
(cli.main, what `python -m soc_tpu_torch` runs) with the process group of
soc_tpu's variables in the environment; "threads" sets
torch.set_num_threads (1 by default); "stop_after" k raises after the
checkpoint's k-th record (a run stopped after its k-th unit); "owners"
N reports the rank of each shard of a CPU `devices N` mesh;
"bench_scaling" {"lanes", "total"} runs soc_tpu_torch.bench's scaling
section over the group's CPU shards and reports it with the process's
bench directory. The
process prints one line "RESULT <json>": its rank and process count, the
A2E kernels' launches, per run the exit code, or the ValueError's words,
and sha256 digests of the run's arrays (with the pipeline's largest
energy imbalance a channel, and `sca`'s events), and the foreign
modules it loaded (soc_tpu, jax: none).
"""

import hashlib
import json
import sys

FOREIGN = ("soc_tpu", "jax", "jaxlib", "flax", "optax")


def digest(a):
    import numpy as np
    if a is None:
        return None
    if hasattr(a, "cpu"):
        a = a.cpu().numpy()
    a = np.ascontiguousarray(a)
    return "%s:%s" % (a.shape, hashlib.sha256(a.tobytes()).hexdigest()[:20])


def digests(verb, results):
    if verb == "rt":
        r = results["rt"]
        return dict(ctabs=digest(r.ctabs), absorbed=digest(r.absorbed),
                    temperature=digest(r.temperature),
                    emitted=digest(r.emitted), map=digest(r.maps.get(0)),
                    escaped=digest(r.escaped))
    if verb == "pipeline":
        a, m = results["absorption"], results["map"]
        bal = (a.absorbed_photons + a.escaped) / a.injected - 1.0
        return dict(ctabs=digest(a.ctabs), absorbed=digest(a.absorbed),
                    emitted=digest(results["emitted"]),
                    map=digest(m.maps.get(0)), escaped=digest(a.escaped),
                    balance=float(abs(bal).max()))
    if verb == "sca":
        return dict(maps=digest(results["sca"]),
                    events=sum(p["events"] for p in results["sca_passes"]))
    return {}


def main():
    spec = json.loads(sys.argv[1])
    import torch
    torch.set_num_threads(int(spec.get("threads", 1)))
    from soc_tpu_torch import cli
    from soc_tpu_torch.parallel import dist
    from soc_tpu_torch.solve import a2e_kernel
    if spec.get("stop_after"):
        from soc_tpu_torch.utils import checkpoint
        real = checkpoint.RunCheckpoint.record_many
        count = [0]

        def record_many(self, *args, **kw):
            real(self, *args, **kw)
            count[0] += 1
            if count[0] >= spec["stop_after"]:
                raise RuntimeError("stopped after %d units" % count[0])
        checkpoint.RunCheckpoint.record_many = record_many
    out = dict(runs=[])
    for argv in spec["runs"]:
        results = {}
        try:
            rc = cli.main(argv, results)
        except ValueError as err:
            out["runs"].append(dict(verb=argv[0], error=str(err)))
            continue
        out["runs"].append(dict(verb=argv[0], rc=rc,
                                digests=digests(argv[0], results)))
    if spec.get("bench_scaling"):
        # soc_tpu_torch.bench's scaling section over the group's CPU shards
        from soc_tpu_torch import bench
        dist.maybe_initialize()
        kw = spec["bench_scaling"]
        out["bench_scaling"] = bench.bench_scaling(
            kw["lanes"], kw["total"], device="cpu")
        out["bench_dir"] = bench._workdir()
    if spec.get("owners"):
        # the ranks owning the shards of a CPU `devices N` mesh
        n = spec["owners"]
        out["owners"] = dist.global_devices("cpu", n)[1][:n]
    out.update(rank=dist.process_index(), size=dist.process_count(),
               a2e_launches=a2e_kernel.launches,
               clamp_launches=a2e_kernel.clamp_launches,
               foreign=sorted(m for m in sys.modules
                              if m.split(".")[0] in FOREIGN))
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
