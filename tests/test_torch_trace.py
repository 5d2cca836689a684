"""The program's tracer (soc_tpu_torch/utils/trace.py) on the CPU: spans
nest with their parents' ids, tracing off records nothing and still fills
``into``, counters sum, stop() clears, nothing of the tracer waits on the
device or reads it back, a traced tiny `rt` and `pipeline` run have
exactly their layers' spans with timings equal to the spans' seconds and
the untraced run's outputs, a run records itself under torch.profiler,
`--profile` writes the spans beside the Chrome trace, and over two gloo
processes process 0 reads the other's late arrival at a collective."""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from soc_tpu_torch import cli
from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.pipeline import driver, full
from soc_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_trace_worker.py")

RT_SPANS = {"driver.run", "driver.input", "driver.sources",
            "transport.pass", "driver.solve", "driver.iteration",
            "driver.outputs", "driver.readback", "io.write", "maps.render"}
# the pipeline's driver runs stop before phase 2's iterations
PIPELINE_SPANS = (RT_SPANS - {"driver.iteration"}) | {
    "pipeline.run", "a2e.prep", "a2e.stage", "a2e.stacks", "a2e.upload",
    "a2e.kernel", "a2e.host"}
DRIVER_KEYS = {"driver.input": "input", "driver.sources": "constant_sources",
               "driver.solve": "solve", "driver.outputs": "outputs",
               "maps.render": "maps"}


@pytest.fixture(autouse=True)
def tracer_off():
    trace.stop()
    yield
    trace.stop()


def seconds(rec):
    return (rec["end_ns"] - rec["start_ns"]) / 1e9


def test_spans_nest_with_their_parents_ids():
    trace.start()
    with trace.span("a.outer", k=1):
        with trace.span("a.inner") as sp:
            sp.set(bytes=5)
        with trace.span("a.inner"):
            pass
    with trace.span("a.next"):
        pass
    spans = trace.stop()["spans"]
    names = [r["name"] for r in spans]
    assert names == ["a.outer", "a.inner", "a.inner", "a.next"]
    outer, in1, in2, nxt = spans
    assert outer["parent"] is None and nxt["parent"] is None
    assert in1["parent"] == outer["id"] == in2["parent"]
    assert len({r["id"] for r in spans}) == 4
    assert outer["attrs"] == {"k": 1} and in1["attrs"] == {"bytes": 5}
    assert outer["start_ns"] <= in1["start_ns"] <= in1["end_ns"] \
        <= in2["start_ns"] <= in2["end_ns"] <= outer["end_ns"]


def test_each_thread_has_its_own_parents():
    trace.start()
    seen = []

    def work():
        with trace.span("t.thread") as sp:
            seen.append(sp.rec)
    with trace.span("t.main"):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    trace.stop()
    assert seen[0]["parent"] is None


def test_off_records_nothing_and_still_fills_into():
    timings = {}
    with trace.span("x.stage", into=timings, key="stage") as sp:
        sp.set(bytes=3)
        assert not sp
    with trace.span("x.other"):
        pass
    assert trace.count("x.n") is None
    assert set(timings) == {"stage"} and timings["stage"] >= 0.0
    trace.start()
    assert trace.stop() == {"spans": [], "counters": {}}


def test_on_fills_into_with_the_spans_seconds():
    timings = {}
    trace.start()
    with trace.span("x.stage", into=timings, key="stage"):
        sum(range(1000))
    rec = trace.stop()["spans"][0]
    assert timings["stage"] == seconds(rec)


def test_counters_sum_and_stop_clears():
    trace.start()
    assert trace.count("c.a") == 1
    assert trace.count("c.a", 4) == 5
    trace.count("c.b", 2)
    with trace.span("c.s"):
        pass
    first = trace.stop()
    assert first["counters"] == {"c.a": 5, "c.b": 2}
    assert [r["name"] for r in first["spans"]] == ["c.s"]
    assert not trace.enabled()
    trace.start()
    assert trace.stop() == {"spans": [], "counters": {}}


def test_the_tracer_never_waits_on_the_device(monkeypatch):
    """torch.cuda.synchronize and Tensor.item raise while spans open and
    close, on and off, in a run under torch.profiler too."""
    def refuse(*a, **k):
        raise AssertionError("the tracer touched the device")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    timings = {}
    for on in (False, True):
        if on:
            trace.start()
        with trace.span("d.a", into=timings, key="a") as sp:
            sp.set(n=1)
            with trace.span("d.b"):
                trace.count("d.c")
        trace.stop()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.run("d.run"):
            with trace.span("d.b"):
                pass
    assert [r["name"] for r in trace.profiled()["spans"]] == ["d.run",
                                                              "d.b"]


def test_graphed_block_off_a_card_captures_nothing():
    from soc_tpu_torch.utils.graphs import GraphedBlock
    block = GraphedBlock(lambda x: (x + 1,), "cpu", kind="pool")
    trace.start()
    for _ in range(3):
        out, = block(torch.zeros(2))
    assert block.kind == "pool" and block.graph is None
    assert trace.stop()["spans"] == []
    assert out.tolist() == [1.0, 1.0]


def test_arithmetic_on_records():
    def rec(name, s, e, i, parent=None):
        return dict(name=name, start_ns=s, end_ns=e, id=i, parent=parent,
                    attrs={})
    spans = [rec("w", 0, 10, 1), rec("w", 5, 20, 2), rec("w", 30, 31, 3),
             rec("stage", 100, 200, 4), rec("kernel", 120, 150, 5, 4),
             rec("kernel", 140, 170, 6, 4), rec("kernel", 300, 400, 7)]
    assert trace.union_s(spans, "w") == pytest.approx(21e-9)
    assert trace.self_s(spans, "stage", "kernel") == pytest.approx(50e-9)


def _outputs(res):
    return [res.absorbed, res.temperature, res.emitted] + [
        res.maps[k] for k in sorted(res.maps, key=str)]


def _same(a, b):
    for x, y in zip(a, b):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)


def _check_driver_timings(spans, run_id, timings):
    kids = {r["name"]: r for r in spans if r["parent"] == run_id
            and r["name"] in DRIVER_KEYS}
    for name, rec in kids.items():
        assert timings[DRIVER_KEYS[name]] == seconds(rec), name
    return kids


def test_traced_rt_has_its_spans_and_the_untraced_outputs(tmp_path):
    ini = write_model(str(tmp_path / "rt"), 8, kind="eqdust", nfreq=10)
    plain = driver.run(ini, device="cpu")
    trace.start()
    res = driver.run(ini, device="cpu")
    rec = trace.stop()
    spans = rec["spans"]
    assert {r["name"] for r in spans} == RT_SPANS
    run = spans[0]
    assert run["name"] == "driver.run" and run["parent"] is None
    kids = _check_driver_timings(spans, run["id"], res.timings)
    assert set(kids) == set(DRIVER_KEYS)
    passes = [r for r in spans if r["name"] == "transport.pass"]
    assert [(p["attrs"]["source"], p["attrs"]["packets"], seconds(p))
            for p in passes] == [(st["source"], st["packets"],
                                  st["seconds"])
                                 for st in res.source_passes]
    assert all(p["parent"] == kids["driver.sources"]["id"] for p in passes)
    outputs = kids["driver.outputs"]["id"]
    assert {r["parent"] for r in spans if r["name"] == "driver.readback"} \
        == {outputs}
    files = [r for r in spans if r["name"] == "io.write"
             and "bytes" in r["attrs"]]
    written = {"absorbed.data", "emitted.data", "map_dir_00.bin"}
    assert sum(r["attrs"]["bytes"] for r in files) >= sum(
        os.path.getsize(os.path.join(tmp_path, "rt", f)) for f in written)
    _same(_outputs(plain), _outputs(res))


def test_traced_pipeline_has_its_spans_and_the_untraced_outputs(tmp_path):
    ini = os.path.abspath(write_model(str(tmp_path / "pl"), 8, kind="gset",
                                      nfreq=10, nsize=4))
    plain = full.run_pipeline(ini, device="cpu")
    trace.start()
    res = full.run_pipeline(ini, device="cpu")
    spans = trace.stop()["spans"]
    assert {r["name"] for r in spans} == PIPELINE_SPANS
    top = spans[0]
    assert top["name"] == "pipeline.run" and top["parent"] is None
    runs = [r for r in spans if r["name"] == "driver.run"]
    assert [r["parent"] for r in runs] == [top["id"]] * 2
    _check_driver_timings(spans, runs[0]["id"], res[0].timings)
    _check_driver_timings(spans, runs[1]["id"], res[2].timings)
    by = {r["name"]: r for r in spans if r["parent"] == top["id"]}
    assert res[2].timings["a2e_prep"] == seconds(by["a2e.prep"])
    assert res[2].timings["a2e"] == seconds(by["a2e.stage"])
    stage = by["a2e.stage"]["id"]
    kernel = [r for r in spans if r["name"] == "a2e.kernel"]
    assert len(kernel) == 1 and kernel[0]["parent"] == stage
    assert kernel[0]["attrs"] == {"shards": 1}
    # the solver is read anew each run, so its stacks are built each run
    assert any(r["name"] == "a2e.stacks" for r in spans)
    _same([res[0].absorbed, res[1]] + _outputs(res[2])[3:],
          [plain[0].absorbed, plain[1]] + _outputs(plain[2])[3:])


def test_a_run_records_itself_under_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    ini = write_model(str(tmp_path / "rt"), 8, kind="eqdust", nfreq=10,
                      bgpac=6000)
    before = trace.profiled()
    driver.run(ini, device="cpu")
    assert trace.profiled() is before          # no profiler: nothing
    with profile(activities=[ProfilerActivity.CPU]):
        res = driver.run(ini, device="cpu")
    assert not trace.enabled()
    rec = trace.profiled()
    assert rec["ranks"] == {}
    assert {r["name"] for r in rec["spans"]} == RT_SPANS
    _check_driver_timings(rec["spans"], rec["spans"][0]["id"], res.timings)
    # a tracer started by hand is left to its owner
    trace.start()
    with profile(activities=[ProfilerActivity.CPU]):
        driver.run(ini, device="cpu")
    assert trace.enabled() and trace.profiled() is rec
    assert [r["name"] for r in trace.stop()["spans"]][0] == "driver.run"


def test_profile_writes_the_spans(tmp_path, monkeypatch):
    ini = write_model(str(tmp_path), 8, kind="eqdust", nfreq=10,
                      bgpac=6000)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["rt", os.path.basename(ini), "--device", "cpu",
                     "--profile=prof"]) == 0
    assert (tmp_path / "prof" / "trace_rt.json").exists()
    with open(tmp_path / "prof" / "spans_rt.json") as fp:
        rec = json.load(fp)
    assert {r["name"] for r in rec["spans"]} == RT_SPANS
    # one count a refill body, every block eager on the CPU
    assert set(rec["counters"]) == {"transport.blocks_eager"}
    assert rec["counters"]["transport.blocks_eager"] > 0
    assert not trace.enabled()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_zero_reads_a_late_rank():
    """Two gloo ranks, rank 1 0.2 s late at a gather: rank 0's wait by
    trace.collective_waits (the dist.wait_s arithmetic) is at least
    0.2 s, by hand and in a run under torch.profiler, whose other rank's
    spans come through the group's store; bytes are the arrays'."""
    coord = "127.0.0.1:%d" % free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               SOC_TPU_DIST_TIMEOUT="60")
    procs = [subprocess.Popen([sys.executable, WORKER, coord, "2", str(k)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for k in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:] \
        + outs[1][1][-3000:]
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT ")]
    res = json.loads(line[0][7:])
    for way in ("by_hand", "followed"):
        got = res[way]
        assert got["ranks"] == [0, 1]
        assert got["names"] == ["dist.gather_objects"]
        assert got["seq"] == [1]
        assert got["bytes"] == [res["nbytes"]]
        assert 0.2 <= got["wait"] < 5.0, got
    assert res["enabled_after"] is False
