"""The readers of the metrics that the program's tracer feeds
(benchmark/metrics/_program.py and its users): on synthetic views, and
end to end through the harness's traced run on the CPU, its device trace
stood in for by one interval over the window."""

import pytest

from benchmark import harness
from benchmark.tests import tiny

MS = 1_000_000


def rec(name, s, e, i, parent=None, **attrs):
    return dict(name=name, start_ns=s * MS, end_ns=e * MS, id=i,
                parent=parent, attrs=attrs)


def view(spans, ranks=None, processes=1, busy=1):
    program = dict(spans=spans, counters={}, ranks=ranks or {})
    return dict(profile=dict(busy_ns=busy, window_ns=10 ** 9,
                             program=program),
                traffic=dict(processes=processes))


def read(metric, v):
    return harness.bench_module("metrics", metric).read(v)


SPANS = [rec("pipeline.run", 0, 1000, 1),
         rec("driver.run", 0, 600, 2, 1),
         rec("driver.outputs", 500, 590, 3, 2),
         rec("driver.readback", 500, 520, 4, 3),
         rec("driver.readback", 530, 540, 5, 3),
         rec("io.write", 545, 585, 6, 3, bytes=10),
         rec("transport.capture", 100, 103, 7, 2, kind="pool"),
         rec("transport.capture", 102, 106, 8, 2, kind="pool"),
         rec("a2e.stage", 600, 900, 9, 1),
         rec("a2e.stacks", 600, 700, 10, 9),
         rec("a2e.kernel", 710, 800, 11, 9, shards=1),
         rec("io.write", 910, 920, 12, 1, bytes=20),
         rec("io.write", 912, 918, 13, 12, bytes=20)]


@pytest.mark.parametrize("metric,value", [
    ("a2e.host_s", 0.21),
    ("driver.readback_s.pipeline", 0.03),
    ("driver.readback_s.rt", 0.03),
    ("driver.write_s.pipeline", 0.05),
    ("driver.write_s.rt", 0.05),
    ("transport.capture_s.pipeline", 0.006),
    ("transport.capture_s.rt", 0.006)])
def test_span_readers(metric, value):
    assert read(metric, view(SPANS)) == pytest.approx(value)


@pytest.mark.parametrize("metric", [
    "a2e.host_s", "driver.readback_s.rt", "driver.write_s.pipeline",
    "transport.capture_s.rt", "dist.wait_s", "dist.mb"])
def test_readers_find_nothing(metric):
    # no span of theirs; no device trace (the CPU); no profile
    assert read(metric, view([rec("driver.run", 0, 1, 1)])) is None
    assert read(metric, view(SPANS, busy=0)) is None
    assert read(metric, dict(profile=None, traffic={})) is None


def collective(op, s, e, i, seq, nbytes=0):
    return rec("dist." + op, s, e, i, seq=seq, bytes=nbytes)


RANK0 = [collective("gather_objects", 0, 50, 1, 1, 2_000_000),
         collective("barrier", 100, 101, 2, 2),
         collective("move", 200, 210, 3, 3, 500_000)]
RANKS = {0: RANK0,
         1: [collective("gather_objects", 30, 50, 1, 1),
             collective("barrier", 90, 101, 2, 2),
             collective("move", 200, 200, 3, 3)],
         2: [collective("gather_objects", 45, 50, 1, 1),
             collective("barrier", 99, 101, 2, 2),
             collective("move", 400, 400, 3, 3)]}


def test_dist_wait_s():
    # 45 ms at the gather; rank 0 last at the barrier; the move's late
    # bystander is clipped to rank 0's 10 ms
    v = view(RANK0, RANKS, processes=3)
    assert read("dist.wait_s", v) == pytest.approx(0.055)
    # a process's spans missing: nothing to read
    part = {k: RANKS[k] for k in (0, 1)}
    assert read("dist.wait_s", view(RANK0, part, processes=3)) is None


def test_dist_mb():
    assert read("dist.mb", view(RANK0, RANKS, processes=3)) == \
        pytest.approx(2.5)


@pytest.fixture
def device_trace(monkeypatch):
    """One device interval over every profiled window."""
    monkeypatch.setattr(harness, "device_intervals",
                        lambda prof: [("kernel", 0, 1 << 62)])


@pytest.mark.parametrize("cell,metrics", [
    ("soc_example.pipeline", {"a2e.host_s", "driver.readback_s.pipeline",
                              "driver.write_s.pipeline"}),
    ("soc_example.rt", {"driver.readback_s.rt", "driver.write_s.rt"})])
def test_traced_cell_reads_the_program(cell, metrics, device_trace):
    """The unchanged harness's traced run: the run records itself under
    its torch.profiler, and the readers find the records (no CUDA graph
    is captured on the CPU, so transport.capture_s stays out)."""
    out = tiny.run(cell, trace=1)
    assert out["correct"]
    got = set(out["metrics"])
    assert metrics <= got
    assert not {m for m in got if m.startswith("transport.capture_s")}
    for m in metrics:
        assert out["metrics"][m]["value"] > 0, m
