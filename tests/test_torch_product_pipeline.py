"""The `pipeline` verb with `devices 4` (dp 2 x freq 2 over CPU shards)
against soc_tpu's pipeline with `devices 4` on the same synthetic GSET
model: absorption run over the mesh -> A2E split over its devices -> map
rows and channels split over it. Tolerances as in
tests/test_torch_product_runs.py (packets that XLA's own transcendental
functions send elsewhere): per-frequency totals at 2e-3, 99% of the
per-cell entries at 1e-4."""

import sys

import numpy as np
import torch

from soc_tpu.pipeline import full as jfull

from soc_tpu_torch import cli
from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.parallel import mesh as tmesh
from soc_tpu_torch.solve import a2e_kernel

sys.path.insert(0, "tests")
from test_torch_product_runs import close_fields, read_fields  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_pipeline_devices_4_matches_soc_tpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    names = ("absorbed.data", "emitted.data", "map_dir_00.bin")
    kw = dict(kind="gset", nfreq=10, nsize=4, extra="nenumber 32\ndevices 4\n")
    ini_t = write_model(str(tmp_path / "t"), 6, **kw)
    ini_j = write_model(str(tmp_path / "j"), 6, **kw)
    a2e_shards, maps = [], []
    real_a2e = a2e_kernel.solve_all_sizes_sharded
    real_map = tmesh.sharded_render_ortho
    monkeypatch.setattr(a2e_kernel, "solve_all_sizes_sharded",
                        lambda *a: a2e_shards.append(a[3]) or real_a2e(*a))
    monkeypatch.setattr(tmesh, "sharded_render_ortho",
                        lambda *a: maps.append(a[-1]) or real_map(*a))
    results = {}
    assert cli.main(["pipeline", ini_t, "--device", "cpu", "--lanes",
                     "4096"], results) == 0
    assert results["absorption"].devices == [CPU] * 4
    assert a2e_shards == [[CPU] * 4]
    assert [(m.n_dp, m.n_freq) for m in maps] == [(2, 2)]
    jfull.run_pipeline(ini_j, lanes=4096)
    ft, fj = read_fields(tmp_path / "t", names), \
        read_fields(tmp_path / "j", names)
    for n in names:
        close_fields(ft[n], fj[n], n, 10 if n != "map_dir_00.bin" else 36)
    res = results["absorption"]
    np.testing.assert_allclose(res.absorbed_photons + res.escaped,
                               res.injected, rtol=1e-4)
