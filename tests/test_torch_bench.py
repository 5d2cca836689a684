"""soc_tpu_torch/bench.py, the `bench` verb's counterpart of soc_tpu's
bench.py, on the CPU at toy size.

  * bound_run, the stepping floor of bench_sol_stepping, against
    scripts/ablate_step.ablate_run(variant="bound") on an 8^3 uniform grid
    with 44 channels, 256 lanes and 20 bodies: the same packets on the
    same streams, the deposits added in lane order in both; XLA's exp and
    log differ from torch's by an ulp, so the tallies are held within
    1e-5 of their peak (they read 3e-7) and the packets started equal;
  * bench_large and bench_xl with soc_tpu's knobs (SOC_BENCH_LARGE_N=16,
    SOC_BENCH_LARGE_ROWS, SOC_BENCH_XL_N=32, SOC_BENCH_XL_PKTS) return the
    fields and cell counts that tests/test_bench_harness.py asserts of
    soc_tpu's, every rate finite and positive, `sane` true;
  * bench_scaling over two processes of one CPU shard each (soc_tpu's
    variables, through tests/_torch_mp_worker.py): both processes run it
    (the mesh's collectives need every rank), each in rank<k> under
    SOC_BENCH_DIR, over the two shards, every rate positive;
  * main()'s JSON line carries every key of bench.py's result dict and of
    its detail dict (read from bench.py with ast, neither imported nor
    run), plus `device` and `sol_form`, with `sane` true.

Toy size on the CPU: the knobs cut what soc_tpu's cut; the loops the
sections run at fixed sizes (bench_sol_stepping's iters, the 512x512
renders, the soc_example model's packets) are cut further by wrapping
the functions (the test's `cut` fixture), since eager torch on the CPU
steps a lane pool some hundred times slower than XLA compiles it.
"""

import ast
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from soc_tpu_torch import bench
from soc_tpu_torch.render import mapping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def test_bound_run_matches_ablate_step():
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import ablate_step as ab
    from soc_tpu.grid import uniform_grid as j_uniform_grid
    from soc_tpu.io.dust import hg_scattering_function
    from soc_tpu_torch.grid import uniform_grid
    rng = np.random.default_rng(3)
    nf = bench.BOUND_NFREQ
    kabs = np.geomspace(0.02, 0.6, nf).astype(np.float32)
    ksca = (kabs * rng.uniform(0.3, 1.5, nf)).astype(np.float32)
    tw = rng.uniform(0.5, 2.0, nf).astype(np.float32)
    _, csc = hg_scattering_function(np.linspace(0.0, 0.7, nf), 256)
    jphys = dict(kabs=jnp.asarray(kabs), ksca=jnp.asarray(ksca),
                 tw=jnp.asarray(tw), csc=jnp.asarray(csc))
    tphys = {k: torch.as_tensor(np.array(v)) for k, v in jphys.items()}
    jt, jn = ab.ablate_run(j_uniform_grid(8, 8, 8, density=1.0), jphys,
                           jnp.float32(1.0), 7, variant="bound", nlanes=256,
                           iters=20)
    tt, tn = bench.bound_run(uniform_grid(8, 8, 8, CPU, density=1.0), tphys,
                             1.0, 7, 256, 20)
    jt = np.asarray(jt)
    assert int(tn) == int(jn) > 256
    assert jt.max() > 0
    np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=1e-5 * jt.max())


@pytest.fixture()
def cut(monkeypatch):
    """soc_tpu's knobs for the CPU (tests/test_bench_harness.py's) and the
    fixed loop sizes cut: bench_sol_stepping at 4 bodies, the renders at
    an eighth of the pixels a side."""
    monkeypatch.setenv("SOC_BENCH_LARGE_N", "16")
    monkeypatch.setenv("SOC_BENCH_LARGE_ROWS", str(1 << 10))
    monkeypatch.setenv("SOC_BENCH_XL_N", "32")
    monkeypatch.setenv("SOC_BENCH_XL_PKTS", str(1 << 13))
    real = bench.bench_sol_stepping

    def stepping(lanes, iters=100, grid=None, medium=None, device=None):
        return real(lanes, 4, grid, medium, device)
    monkeypatch.setattr(bench, "bench_sol_stepping", stepping)
    render = mapping.render_ortho

    def small(*args, **kw):
        npix = args[8]
        return render(*args[:8], (npix[0] // 8, npix[1] // 8), *args[9:],
                      **kw)
    monkeypatch.setattr(mapping, "render_ortho", small)
    torch.set_num_threads(2)
    return bench


def test_bench_xl_section(cut, tmp_path):
    workdir = str(tmp_path / "bw")
    cut.prepare_workdir(workdir)
    out = cut.bench_xl(workdir, 1 << 10, device=CPU)
    assert out["cells"] == 32 ** 3
    for k in ("gather_melem_per_s", "bg_transport_pps",
              "map_render_s_256x256x1"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert out["sane"] is True
    json.dumps(out)


def test_bench_large_section(cut, tmp_path):
    workdir = str(tmp_path / "bw")
    cut.prepare_workdir(workdir)
    out = cut.bench_large(workdir, 1 << 12, repeats=1, device=CPU)
    assert out["cells"] == 16 ** 3 + 8 * 4096 + 8 * 512
    assert out["levels"] == 3
    for k in ("gather_melem_per_s", "scatter_melem_per_s",
              "bg_transport_pps", "a2e_stream_cells_per_sec",
              "map_render_s_512x512x44", "stepping_rate_msteps_per_s",
              "stepping_inloop_bound_msteps_per_s",
              "sol_stepping_fraction_vs_random_floor", "driver_e2e_s"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert out["a2e_stream_rows"] == 1 << 10
    assert out["a2e_link"]["serial_ceiling_cells_per_sec"] > 0
    assert (out["a2e_link"]["duplex_ceiling_cells_per_sec"]
            >= out["a2e_link"]["serial_ceiling_cells_per_sec"])
    assert 0 <= out["a2e_link_efficiency"]
    assert out["sane"] is True
    json.dumps(out)


def _result_keys():
    """The keys of bench.py's `result` dict and of its "detail" dict,
    read from its source."""
    with open(os.path.join(REPO, "bench.py")) as fp:
        tree = ast.parse(fp.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "result"
                for t in node.targets):
            top = {k.value: v for k, v in zip(node.value.keys,
                                              node.value.values)}
            return set(top), {k.value for k in top["detail"].keys}
    raise AssertionError("bench.py has no result dict")


def test_main_line_has_every_key(cut, tmp_path, monkeypatch, capsys):
    """main() on a 4^3 soc_example-shaped model (prepare_workdir's files,
    the cloud and `bgpackets` cut), every section cut: one JSON line with
    every key of bench.py's result and detail, `sane` true; no card here,
    so no scaling and no device-resident A2E rate."""
    monkeypatch.setenv("SOC_BENCH_DIR", str(tmp_path / "bw"))
    monkeypatch.setenv("SOC_BENCH_LANES", "4096")
    monkeypatch.setenv("SOC_BENCH_LARGE", "0")
    monkeypatch.setenv("SOC_BENCH_XL", "0")
    from soc_tpu_torch.io.cloud import write_hierarchy
    real = bench.prepare_workdir

    def prepare(workdir):
        ini = real(workdir)
        write_hierarchy(os.path.join(workdir, "tmp.cloud"), 4, 4, 4, [64],
                        [np.ones(64, np.float32)])
        with open(ini) as fp:
            text = fp.read().replace("999999", "768")
        with open(ini, "w") as fp:
            fp.write(text)
        return ini
    monkeypatch.setattr(bench, "prepare_workdir", prepare)
    for name, kw in (("bench_speed_of_light", dict(nrays=4096)),
                     ("bench_octree", dict(total_packets=1 << 12,
                                           repeats=1)),
                     ("bench_sca", dict(total_packets=1 << 11, repeats=1)),
                     ("bench_a2e", dict(cells=1024))):
        monkeypatch.setattr(bench, name,
                            functools.partial(getattr(bench, name), **kw))
    result = bench.main(device=CPU)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(result))
    top, detail = _result_keys()
    assert top | {"device", "sol_form"} == set(result)
    assert detail == set(result["detail"])
    assert result["device"] == "cpu"
    assert "blocks of 32" in result["sol_form"]
    assert result["detail"]["sane"] is True
    assert result["detail"]["total_packets"] == 768 * 44
    for k in ("speed_of_light_pps", "stepping_rate_msteps_per_s",
              "stepping_bound_msteps_per_s", "octree3_transport_pps",
              "octree6_transport_pps", "sca_peeloff_pps", "sca_march_pps",
              "a2e_cells_per_sec", "map_render_s_512x512x44",
              "pipeline_e2e_s"):
        v = result["detail"][k]
        assert np.isfinite(v) and v > 0, k
    assert result["value"] > 0 and result["detail"]["scaling"] is None


def test_bench_scaling_over_two_processes(tmp_path):
    from test_torch_multiprocess import ok, spawn
    runs = ok(spawn([dict(runs=[], bench_scaling=dict(lanes=1024,
                                                     total=16))] * 2,
                    [tmp_path] * 2, nproc=2,
                    env_extra=dict(SOC_BENCH_DIR=str(tmp_path / "bw"))))
    for k, res in enumerate(runs):
        sc = res["bench_scaling"]
        assert res["rank"] == k and sc["devices"] == 2
        assert sc["pps_1"] > 0 and sc["pps_n"] > 0 and sc["efficiency"] > 0
        assert res["bench_dir"] == str(tmp_path / "bw" / ("rank%d" % k))
