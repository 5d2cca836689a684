"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert {"run_s", "packets_per_s", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    pairs = set()
    fours = 0
    for cell in SPEC["workloads"]:
        assert cell["config"] in configs and cell["chips"] in (1, 4)
        assert len(cell["why"]) <= 200
        pairs.add((cell["config"], cell["traffic"]))
        fours += cell["chips"] == 4
        harness.cell_spec(cell["name"])          # every file found by name
    assert len(pairs) == len(SPEC["workloads"])
    assert fours <= max(1, len(SPEC["workloads"]) // 4)
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == set(configs)
    for c in configs.values():
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert c["file"].startswith("benchmark/")


def test_per_layer_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {c["name"] for c in SPEC["workloads"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert callable(harness.bench_module("metrics", m["name"]).read)
        layers.setdefault(m["layer"], 0)
    for cell in cells:
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_limits_cover_the_checks(cell):
    _, _, traffic, cfile, _ = harness.cell_spec(cell)
    harness.bench_module("verbs", traffic["verb"])
    need = set().union(*(harness.bench_module("checks", c).NUMBERS
                         for c in traffic["checks"]))
    assert set(cfile["limits"]) == need
    assert all(v > 0 for v in cfile["limits"].values())
