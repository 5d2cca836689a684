"""parallel/dist.py on the CPU: soc_tpu's variables and words, the process
group of two gloo ranks (tests/_torch_dist_worker.py), the global device
list in rank order, the mesh's collectives against one process's sums (bit
for bit: the same additions in the same order), and a failed rank ending
the other within the group's timeout."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from soc_tpu_torch.parallel import dist, product

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")
VARIABLES = ("SOC_TPU_COORDINATOR", "SOC_TPU_NUM_PROCESSES",
             "SOC_TPU_PROCESS_ID", "SOC_TPU_DISTRIBUTED")
GROUP_TIMEOUT = 20


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def two_ranks(mode, timeout=120):
    """The worker's two ranks in ``mode``: [(rc, RESULT dict or None,
    stderr)]; a rank still running after ``timeout`` is killed."""
    coord = "127.0.0.1:%d" % free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               SOC_TPU_DIST_TIMEOUT=str(GROUP_TIMEOUT))
    procs = [subprocess.Popen([sys.executable, WORKER, coord, "2", str(k),
                               mode], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for k in (0, 1)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            out.append((p.returncode,
                        json.loads(line[0][7:]) if line else None, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_maybe_initialize_is_a_noop_without_the_variables(monkeypatch):
    for key in VARIABLES:
        monkeypatch.delenv(key, raising=False)
    assert dist.maybe_initialize() is False
    assert not dist.is_initialized()
    assert (dist.process_count(), dist.process_index()) == (1, 0)


@pytest.mark.parametrize("given", [{}, {"SOC_TPU_NUM_PROCESSES": "2"},
                                   {"SOC_TPU_PROCESS_ID": "0"}])
def test_coordinator_alone_raises_soc_tpus_error(monkeypatch, given):
    """soc_tpu's ValueError, word for word, before any group is joined."""
    from soc_tpu.parallel import dist as jdist
    for key in VARIABLES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("SOC_TPU_COORDINATOR", "127.0.0.1:1")
    for k, v in given.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as port:
        dist.maybe_initialize()
    with pytest.raises(ValueError) as ref:
        jdist.maybe_initialize()
    assert str(port.value) == str(ref.value)
    assert "needs SOC_TPU_NUM_PROCESSES and SOC_TPU_PROCESS_ID" \
        in str(port.value)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def mesh_ranks():
    runs = two_ranks("mesh")
    for rc, res, err in runs:
        assert rc == 0 and res is not None, err[-3000:]
    return [res for _, res, _ in runs]


def test_global_device_list_in_rank_order(mesh_ranks):
    """Process 0's four CPU shards first, then process 1's two; initialize
    ran twice in each (idempotent)."""
    for k, res in enumerate(mesh_ranks):
        assert (res["rank"], res["size"]) == (k, 2)
        assert res["owners"] == [0, 0, 0, 0, 1, 1]
        assert res["local"] == (4, 2)[k]
        assert res["mine"] == [o == k for o in res["owners"]]


def test_collectives_equal_one_process_bit_for_bit(mesh_ranks):
    """fold_intf, reduce_intf, gather_shards and the emission's gather over
    two processes give one process's result bit for bit, on a mesh of
    both processes' shards and on one of process 0's alone."""
    sys.path.insert(0, os.path.dirname(WORKER))
    import _torch_dist_worker as worker
    want = {name: worker.mesh_digests(product.ProductMesh(
        n, worker.NFREQ, ["cpu"] * n)) for name, n in (("mesh", 6),
                                                       ("mesh0", 4))}
    for res in mesh_ranks:
        for name in ("mesh", "mesh0"):
            assert res[name] == want[name]
            assert res[name]["emission_equal"]


def test_a_failed_rank_ends_the_other():
    """Rank 1 raises after joining; rank 0, waiting at a barrier, exits
    non-zero within the group's timeout instead of hanging."""
    t0 = time.time()
    (rc0, _, err0), (rc1, _, err1) = two_ranks("raise",
                                               timeout=3 * GROUP_TIMEOUT)
    assert rc1 != 0 and "rank 1 fails" in err1
    assert rc0 != 0, err0[-2000:]
    assert time.time() - t0 < 3 * GROUP_TIMEOUT
