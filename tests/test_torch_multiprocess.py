"""Several processes on the CPU: two processes of four CPU shards each run
`python -m soc_tpu_torch` (cli.main, through tests/_torch_mp_worker.py)
under soc_tpu's variables SOC_TPU_COORDINATOR, SOC_TPU_NUM_PROCESSES and
SOC_TPU_PROCESS_ID, against one process of eight shards (the same ini's
`devices 8`) and against soc_tpu's one-process 8-device driver.run.

Each process runs in its own copy of the model directory, so a file that
process 1 writes shows; the files a later stage reads (the simple dust,
the .solver, a checkpoint) are put in its copy as process 0 writes them
into a shared directory.

Tolerances, each with its reason:
  * against one process: the same shards add in the same order, every
    process and the reference with one torch thread: bit for bit;
  * against soc_tpu: tests/test_torch_product_runs.py's (XLA's exp, log,
    cos and sin differ from torch's by a few ulps, so a rare packet takes
    another path): per-frequency totals 2e-3, 99% of the cells 1e-4, the
    temperatures 1e-4.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from soc_tpu_torch.example_model import write_model, write_sca_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_mp_worker.py")
TIMEOUT = 240           # seconds a process may take
GROUP_TIMEOUT = 60      # seconds a collective may wait (dist.initialize)
LANES = "4096"
OUTPUTS = ("absorbed.data", "emitted.data", "tmp.T", "map_dir_00.bin")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(specs, cwds, nproc=None, env_extra=None):
    """Start one worker a spec (in its directory), as the ranks of one
    group when nproc is given; returns the processes (collect)."""
    port = free_port()
    procs = []
    for k, (spec, cwd) in enumerate(zip(specs, cwds)):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                   SOC_TPU_DIST_TIMEOUT=str(GROUP_TIMEOUT))
        for key in ("SOC_TPU_COORDINATOR", "SOC_TPU_NUM_PROCESSES",
                    "SOC_TPU_PROCESS_ID", "SOC_TPU_DISTRIBUTED",
                    "SOC_TPU_LOCAL_DEVICE_IDS"):
            env.pop(key, None)
        if nproc is not None:
            env.update(SOC_TPU_COORDINATOR="127.0.0.1:%d" % port,
                       SOC_TPU_NUM_PROCESSES=str(nproc),
                       SOC_TPU_PROCESS_ID=str(k))
        env.update(env_extra or {})
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, json.dumps(spec)], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def collect(procs, timeout=TIMEOUT):
    """[(rc, RESULT dict or None, stderr)] of started workers; a process
    that outlives ``timeout`` (each has its own) is killed, and so is
    every other one still running when one fails."""
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


def spawn(specs, cwds, nproc=None, env_extra=None):
    return collect(start(specs, cwds, nproc, env_extra))


def ok(runs):
    for rc, res, err in runs:
        assert rc == 0 and res is not None, err[-3000:]
        assert res["foreign"] == [], res["foreign"]
        assert all(r.get("rc") == 0 for r in res["runs"]), res
    return [res for _, res, _ in runs]


def files(d):
    return {f: os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)}


def rt_model(d, extra=""):
    """8^3 cells, 4 channels: `devices 8` is dp 2 x freq 4."""
    return write_model(str(d), 8, kind="eqdust", nfreq=4, bgpac=3072,
                       cellpackets=2048, iterations=2,
                       extra="devices 8\n" + extra)


def cli(ini, verb="rt"):
    return [verb, os.path.basename(ini), "--device", "cpu", "--lanes", LANES]


@pytest.fixture(scope="module")
def rt_runs(tmp_path_factory):
    """`rt` with `devices 8`, `iterations 2` and `cellpackets`: one process
    of eight CPU shards and two processes of four, while soc_tpu's
    one-process `devices 8` run (on the tests' 8 JAX CPU devices) runs in
    this one."""
    from soc_tpu.pipeline import driver as jdriver
    base = tmp_path_factory.mktemp("mp_rt")
    dirs = {k: base / k for k in ("one", "r0", "r1", "j")}
    ini = {k: rt_model(d) for k, d in dirs.items()}
    before = files(dirs["r1"])
    procs = start([dict(runs=[cli(ini["one"])])], [dirs["one"]]) \
        + start([dict(runs=[cli(ini["r%d" % k])]) for k in (0, 1)],
                [dirs["r0"], dirs["r1"]], nproc=2)
    try:
        jdriver.run(ini["j"], lanes=int(LANES))
    finally:
        runs = ok(collect(procs))
    return dict(dirs=dirs, ref=runs[0], ranks=runs[1:], before=before)


def test_rt_over_two_processes_equals_one_process(rt_runs):
    """Every process holds the one-process run's results bit for bit, and
    process 0's files are its files byte for byte."""
    ref, ranks = rt_runs["ref"], rt_runs["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["size"] == 2 for r in ranks) and ref["size"] == 1
    for r in ranks:
        assert r["runs"][0]["digests"] == ref["runs"][0]["digests"]
    d0, d1 = rt_runs["dirs"]["one"], rt_runs["dirs"]["r0"]
    for name in OUTPUTS + ("packet.info",):
        with open(os.path.join(d0, name), "rb") as a, \
                open(os.path.join(d1, name), "rb") as b:
            assert a.read() == b.read(), name


def test_only_process_0_writes(rt_runs):
    assert files(rt_runs["dirs"]["r1"]) == rt_runs["before"]
    assert set(OUTPUTS) <= set(files(rt_runs["dirs"]["r0"]))


def test_rt_over_two_processes_holds_soc_tpu(rt_runs):
    """Process 0's files against soc_tpu's one-process `devices 8` run on
    8 CPU devices (the tests' JAX mesh)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_product_runs import close_fields
    for name in OUTPUTS:
        got, want = (np.fromfile(os.path.join(rt_runs["dirs"][k], name),
                                 np.float32) for k in ("r0", "j"))
        close_fields(got, want, name, 4 if name != "map_dir_00.bin" else 64)


def test_checkpointed_run_resumes_over_two_processes(rt_runs, tmp_path):
    """Stopped after its first unit (the background pass) and run again
    over the same two processes, the run equals one never stopped: the
    resumed processes skip the unit and read process 0's file."""
    dirs = [tmp_path / "r0", tmp_path / "r1"]
    inis = [rt_model(d, "checkpoint ck.npz 1\n") for d in dirs]
    specs = [dict(runs=[cli(i)], stop_after=1) for i in inis]
    stopped = spawn(specs, dirs, nproc=2)
    for rc, _, err in stopped:
        assert rc != 0 and "stopped after 1 units" in err, err[-2000:]
    assert os.path.exists(dirs[0] / "ck.npz")
    assert not os.path.exists(dirs[1] / "ck.npz")
    shutil.copy(dirs[0] / "ck.npz", dirs[1] / "ck.npz")   # a shared file
    runs = spawn([dict(runs=[cli(i)]) for i in inis], dirs, nproc=2)
    for r in ok(runs):
        assert r["runs"][0]["digests"] \
            == rt_runs["ref"]["runs"][0]["digests"]
    for _, _, err in runs:
        assert "skipping completed unit bg" in err, err[-2000:]


def test_checkpoint_of_one_process_is_refused_by_two(tmp_path,
                                                    monkeypatch):
    """The fingerprint takes the process count: a file written by one
    process is refused over two (they start fresh), and the other way
    round."""
    from soc_tpu_torch.config import RunConfig
    from soc_tpu_torch.parallel import dist, product
    from soc_tpu_torch.pipeline import driver
    cfg = RunConfig(rt_model(tmp_path, "checkpoint ck.npz 1\n"))
    pm = product.ProductMesh(8, 4, ["cpu"] * 8)
    monkeypatch.chdir(tmp_path)
    tabs = np.ones(4, np.float32)
    driver._checkpoint_setup(cfg, 4, pm, None).record("bg", None, tabs=tabs)
    assert driver._checkpoint_setup(cfg, 4, pm, None).done == ["bg"]
    with monkeypatch.context() as m:
        m.setattr(dist, "process_count", lambda: 2)
        m.setattr(dist, "barrier", lambda: None)
        two = driver._checkpoint_setup(cfg, 4, pm, None)
        assert two.done == []
        two.record("bg", None, tabs=tabs)         # process 0 writes
        assert driver._checkpoint_setup(cfg, 4, pm, None).done == ["bg"]
    assert driver._checkpoint_setup(cfg, 4, pm, None).done == []


def test_devices_6_over_two_processes_of_four(tmp_path):
    """`devices 6` over 2 x 4 CPU shards: process 0 holds four shards,
    process 1 two; the results equal one process's `devices 6` run. Under
    --profile each process writes a trace and spans of its own."""
    dirs = {k: tmp_path / k for k in ("one", "r0", "r1")}
    ini = {k: write_model(str(d), 8, kind="eqdust", nfreq=4, bgpac=3072,
                          extra="devices 6\n") for k, d in dirs.items()}
    ref, *ranks = ok(collect(
        start([dict(runs=[cli(ini["one"])])], [dirs["one"]])
        + start([dict(runs=[cli(ini["r%d" % k]) + ["--profile=prof"]],
                      owners=6)
                 for k in (0, 1)], [dirs["r0"], dirs["r1"]], nproc=2,
                env_extra=dict(SOC_TPU_LOCAL_DEVICE_IDS="0,1,2,3"))))
    for k, r in enumerate(ranks):
        assert r["owners"] == [0, 0, 0, 0, 1, 1]
        assert r["runs"][0]["digests"] == ref["runs"][0]["digests"]
        assert sorted(os.listdir(dirs["r%d" % k] / "prof")) \
            == ["spans_rt.rank%d.json" % k, "trace_rt.rank%d.json" % k]


def test_pipeline_over_two_processes_equals_one_process(tmp_path,
                                                        monkeypatch):
    """The `pipeline` verb with a GSET dust, `devices 8`: absorbed,
    emitted and the map bit for bit on both processes and in process 0's
    files; each process solves every cell on its own shards."""
    from soc_tpu_torch.config import RunConfig
    from soc_tpu_torch.io.dust import read_simple_dust
    from soc_tpu_torch.pipeline import full
    dirs = {k: tmp_path / k for k in ("one", "r0", "r1")}
    ini = {k: write_model(str(d), 8, kind="gset", nfreq=8, nsize=4,
                          bgpac=3072, extra="nenumber 32\ndevices 8\n")
           for k, d in dirs.items()}
    # what process 0 writes into a shared directory before the others
    # look for it, the simple dust and the solver file, in process 1's
    monkeypatch.chdir(dirs["r1"])
    cfg = RunConfig(ini["r1"])
    cfg.freq = read_simple_dust(
        full.absorption_config(cfg).file_optical[0], cfg.gl).freq
    full.prepare_solver_files(cfg)
    monkeypatch.undo()
    derived = ("TST_simple.dust", "gs_TST.solver")
    before = files(dirs["r1"])
    ref, *ranks = ok(collect(
        start([dict(runs=[cli(ini["one"], "pipeline")])], [dirs["one"]])
        + start([dict(runs=[cli(ini["r%d" % k], "pipeline")])
                 for k in (0, 1)], [dirs["r0"], dirs["r1"]], nproc=2)))
    for r in ranks:
        assert r["runs"][0]["digests"] == ref["runs"][0]["digests"]
    for name in ("absorbed.data", "emitted.data", "map_dir_00.bin") \
            + derived:
        with open(dirs["one"] / name, "rb") as a, \
                open(dirs["r0"] / name, "rb") as b:
            data = a.read()
            assert data == b.read(), name
        if name in derived:
            with open(dirs["r1"] / name, "rb") as c:
                assert data == c.read(), name
    assert files(dirs["r1"]) == before


def test_domains_and_sca_devices_are_refused(tmp_path):
    """Over two processes `domains` raises (soc_tpu's Z-slab path fails
    there on a tally it cannot fetch); `sca` with `devices` was refused
    too before it ran over processes, and now runs: both processes return
    its maps (tests/test_torch_sca_processes.py holds them to one process
    and to soc_tpu). A host verb runs on process 0, and both return its
    exit code."""
    dom = write_model(str(tmp_path / "dom"), 8, kind="eqdust", nfreq=4,
                      bgpac=3072, extra="domains 2\n")
    sca = write_sca_model(str(tmp_path / "sca"), 8, nfreq=4,
                          extra="devices 2\n")
    specs = [dict(runs=[["rt", dom, "--device", "cpu"],
                        ["sca", sca, "--device", "cpu", "--lanes", LANES],
                        ["sampleini", "sample.ini"]])] * 2
    maps = set()
    for rc, res, err in spawn(specs, [tmp_path] * 2, nproc=2):
        assert rc == 0 and res is not None, err[-2000:]
        dom_err = res["runs"][0]["error"]
        assert "domains 2" in dom_err and "2 processes" in dom_err
        assert res["runs"][1]["rc"] == 0, res["runs"][1]
        maps.add(res["runs"][1]["digests"]["maps"])
        assert res["runs"][2]["rc"] == 0
    assert len(maps) == 1
    assert os.path.exists(tmp_path / "sample.ini")
