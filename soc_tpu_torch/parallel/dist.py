"""Several processes: torch.distributed initialisation and the collectives
of the `devices N` mesh (port of soc_tpu.parallel.dist).

soc_tpu scales over hosts with JAX's multi-controller runtime: every
process runs the same command, jax.devices() lists every process's
devices and the (dp, freq) mesh spans them. The port does the same with
torch.distributed: every process (a rank) runs the same command, the
global device list is every rank's local devices in rank order (process
0's first, as jax.devices() orders them), shard i of a mesh lies on
global device i, a rank steps only the shards on its own devices, and the
shards' partial results are combined across ranks so that every rank
holds the replicated result (parallel/product.py).

Initialisation, in soc_tpu's order of sources:
  1. explicit arguments: initialize(coordinator=..., ...)
  2. SOC_TPU_COORDINATOR ("host:port"), SOC_TPU_NUM_PROCESSES and
     SOC_TPU_PROCESS_ID (maybe_initialize, which the CLI calls first)
  3. SOC_TPU_DISTRIBUTED=auto: torch.distributed's env:// method
     (torchrun's MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE), the
     counterpart of JAX's cluster autodetection
Without any of them nothing is initialised and a run is one process.

A rank's local devices are its visible cards (CUDA_VISIBLE_DEVICES
decides, as JAX gives a process its visible GPUs), or the cards that
``local_device_ids`` (SOC_TPU_LOCAL_DEVICE_IDS, comma-separated) names.
On the CPU a rank holds len(local_device_ids) CPU shards, or by default
N / process_count() of a `devices N` mesh (rounded up).

The collectives run on one gloo group, every tensor staged through host
memory: several ranks may share one card (NCCL refuses two ranks on one
GPU), the CPU tests run the code that runs on the card, and a pass moves
few tensors (a TABS, the [CELLS, NFREQ/F] slabs, the escape vectors). A
rank that dies ends the others' collectives with an error at once; one
that hangs ends them after the group's timeout, SOC_TPU_DIST_TIMEOUT
seconds (a deployment setting: the slowest rank's longest pass must fit
in it while the others wait). Nothing retries or falls back.

Each collective is the span `dist.<op>` of utils/trace.py, with the
rank's collective count since tracing began (``seq``) and the bytes of
its payload's tensors and arrays (``bytes``): a rank arrives at a
collective where its span starts. post() and fetch() reach the group's
key-value store, which waits on no other rank.
"""

import datetime
import os
import pickle

import numpy as np
import torch

from ..utils import trace

_state = dict(group=False, rank=0, size=1, table=None)
TIMEOUT_S = 1800.0      # SOC_TPU_DIST_TIMEOUT's default


def is_initialized():
    return _state["group"]


def process_count():
    return _state["size"]


def process_index():
    return _state["rank"]


def _env_ids():
    ids = os.environ.get("SOC_TPU_LOCAL_DEVICE_IDS", "").strip()
    return [int(i) for i in ids.split(",") if i.strip()] if ids else None


def initialize(coordinator=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """Join the process group (idempotent). ``coordinator`` "host:port"
    gives the tcp:// rendezvous with ``num_processes`` and ``process_id``;
    without it torch.distributed's env:// method reads torchrun's
    variables. ``local_device_ids``: the cards (or on the CPU, the count
    of CPU shards) this rank holds."""
    import torch.distributed as tdist
    if _state["group"]:
        return
    timeout = float(os.environ.get("SOC_TPU_DIST_TIMEOUT", TIMEOUT_S))
    kw = dict(backend="gloo", timeout=datetime.timedelta(seconds=timeout))
    if coordinator:
        kw.update(init_method="tcp://%s" % coordinator,
                  world_size=int(num_processes), rank=int(process_id))
    else:
        kw.update(init_method="env://")
    tdist.init_process_group(**kw)
    _state.update(group=True, rank=tdist.get_rank(),
                  size=tdist.get_world_size())
    cuda = list(local_device_ids) if local_device_ids is not None \
        else list(range(torch.cuda.device_count()))
    mine = dict(cuda=cuda, cpu=None if local_device_ids is None
                else len(local_device_ids))
    table = [None] * _state["size"]
    tdist.all_gather_object(table, mine)
    _state["table"] = table


def maybe_initialize():
    """Env-driven init: a no-op unless SOC_TPU_COORDINATOR (explicit) or
    SOC_TPU_DISTRIBUTED=auto (env://) is set. Returns whether it
    initialised."""
    coord = os.environ.get("SOC_TPU_COORDINATOR")
    if coord:
        nproc = os.environ.get("SOC_TPU_NUM_PROCESSES")
        pid = os.environ.get("SOC_TPU_PROCESS_ID")
        if nproc is None or pid is None:
            raise ValueError(
                "SOC_TPU_COORDINATOR is set but multi-process init also "
                "needs SOC_TPU_NUM_PROCESSES and SOC_TPU_PROCESS_ID "
                "(got NUM_PROCESSES=%r, PROCESS_ID=%r)" % (nproc, pid))
        initialize(coordinator=coord, num_processes=int(nproc),
                   process_id=int(pid), local_device_ids=_env_ids())
        return True
    if os.environ.get("SOC_TPU_DISTRIBUTED", "").lower() == "auto":
        initialize(local_device_ids=_env_ids())
        return True
    return False


def local_devices(device, n=None):
    """This rank's devices of ``device``'s type: its cards (cuda:i for
    its ids), or on the CPU its CPU shards (``n``, a `devices N` count,
    sets the default share, N / process_count() rounded up; one without
    it)."""
    device = torch.device(device)
    table = _state["table"]
    if device.type == "cuda":
        ids = table[process_index()]["cuda"] if table \
            else range(torch.cuda.device_count())
        return [torch.device("cuda", i) for i in ids]
    count = table[process_index()]["cpu"] if table else None
    if count is None:
        count = 1 if n is None or n < 1 else -(-n // process_count())
    return [device] * count


def global_devices(device, n=None):
    """(devices, owners): every rank's local devices in rank order and the
    rank that owns each, as jax.devices() lists every process's."""
    if not _state["group"]:
        devs = local_devices(device, n)
        return devs, [0] * len(devs)
    device = torch.device(device)
    devs, owners = [], []
    for rank, row in enumerate(_state["table"]):
        if device.type == "cuda":
            mine = [torch.device("cuda", i) for i in row["cuda"]]
        else:
            count = row["cpu"] if row["cpu"] is not None else \
                (1 if n is None or n < 1 else -(-n // process_count()))
            mine = [device] * count
        devs += mine
        owners += [rank] * len(mine)
    return devs, owners


# ---- collectives (every rank calls each one, in the same order)
def _nbytes(obj):
    """Bytes of the tensors and arrays in ``obj``, walked through lists,
    tuples and dicts (nothing is pickled to count them)."""
    if torch.is_tensor(obj):
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    return 0


def _span(op, payload=None):
    """The collective's span; its attrs only while tracing."""
    if not trace.enabled():
        return trace.span("dist." + op)
    return trace.span("dist." + op, seq=trace.count("dist.collectives"),
                      bytes=_nbytes(payload))


def barrier():
    import torch.distributed as tdist
    if process_count() > 1:
        with _span("barrier"):
            tdist.barrier()


def first(fn, *args, **kw):
    """fn(*args, **kw) on process 0, then on the others: what it writes
    (a file the others then find and read) is written by process 0 alone
    before any other rank looks for it."""
    if process_count() == 1:
        return fn(*args, **kw)
    if process_index() == 0:
        out = fn(*args, **kw)
        barrier()
        return out
    barrier()
    return fn(*args, **kw)


def gather_objects(obj):
    """[every rank's obj] in rank order (picklable host objects)."""
    import torch.distributed as tdist
    with _span("gather_objects", obj):
        out = [None] * process_count()
        tdist.all_gather_object(out, obj)
    return out


def share(obj, src=0):
    """Rank ``src``'s obj on every rank."""
    import torch.distributed as tdist
    with _span("share") as sp:
        box = [obj]
        tdist.broadcast_object_list(box, src=src)
        if sp:
            sp.set(bytes=_nbytes(box[0]))
    return box[0]


def broadcast(t, src, shape, dtype):
    """Rank ``src``'s tensor ``t`` (any device) on every rank: ``t`` itself
    on ``src``, a host copy elsewhere (the others pass None)."""
    import torch.distributed as tdist
    with _span("broadcast") as sp:
        if process_index() == src:
            host_t = t.detach().to("cpu").contiguous()
            tdist.broadcast(host_t, src=src)
            out = t
        else:
            host_t = out = torch.empty(tuple(shape), dtype=dtype)
            tdist.broadcast(out, src=src)
        if sp:
            sp.set(bytes=_nbytes(host_t))
    return out


def move(t, src, dst, shape, dtype):
    """Rank ``src``'s tensor ``t`` onto rank ``dst``: ``t`` itself when
    src == dst, a host copy received on dst; None on every other rank."""
    import torch.distributed as tdist
    me = process_index()
    if src == dst:
        return t if me == src else None
    with _span("move") as sp:
        out = None
        if me == src:
            host_t = t.detach().to("cpu").contiguous()
            tdist.send(host_t, dst=dst)
            if sp:
                sp.set(bytes=_nbytes(host_t))
        elif me == dst:
            out = torch.empty(tuple(shape), dtype=dtype)
            tdist.recv(out, src=src)
            if sp:
                sp.set(bytes=_nbytes(out))
    return out


def _store():
    """The process group's key-value store, or None."""
    from torch.distributed import distributed_c10d
    try:
        return distributed_c10d._get_default_store()
    except (AttributeError, RuntimeError, ValueError):
        return None


def post(key, obj):
    """Put ``obj`` (picklable) under ``key`` in the group's store; waits
    on no other rank."""
    store = _store()
    if store is not None:
        store.set(key, pickle.dumps(obj))


def fetch(key):
    """What a rank posted under ``key``, or None where nothing is there
    yet (never waits)."""
    store = _store()
    if store is None or not store.check([key]):
        return None
    return pickle.loads(store.get(key))


def host(value):
    """A picklable host copy of a shard's result: tensors as NumPy arrays
    (no device travels between ranks)."""
    if torch.is_tensor(value):
        return value.detach().to("cpu").numpy()
    if isinstance(value, (list, tuple)):
        return type(value)(host(v) for v in value)
    if isinstance(value, dict):
        return {k: host(v) for k, v in value.items()}
    return value
