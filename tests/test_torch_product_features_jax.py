"""`devices 4` (dp 2 x freq 2) with the keywords soc_tpu's product path
runs, by groups, the port against soc_tpu's `devices 4` run of the same
ini (6^3 cells, 10 channels): here the cell emission with ALI and
WITH_REFERENCE; EMWEI with SUBITERATIONS in
tests/test_torch_product_jax_emweight.py; the constant sources with
per-cell abundances (MSF), the ROI save, mirrors, the weighting, `simum`
and `mmapabs` in tests/test_torch_product_jax_sources*.py. One soc_tpu
run a group: each compiles its sharded programs for 20-40 s on the CPU,
so the groups are spread over files that the test workers take in
parallel.

Tolerances as tests/test_torch_product_runs.py (XLA's exp/log/cos/sin
differ from torch's by a few ulps, so a rare packet takes another path):
per-frequency totals at 2e-3, 99% of the per-cell entries at 1e-4,
temperatures at 1e-4; escaped per channel at 2e-3.
"""

import os

import numpy as np
import torch

from soc_tpu.pipeline import driver as jdriver

from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.pipeline import driver as tdriver

from test_torch_product_runs import close_fields, read_fields

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12
N, NFREQ = 6, 10
NAMES = ("absorbed.data", "emitted.data", "tmp.T", "map_dir_00.bin")
SOURCES = [(3.1, 2.9, 3.2, 0.3), (-2.0, 3.0, 3.0, 1.0)]
GROUPS = {
    "cell ali reference": dict(cellpackets=2 * N ** 3, iterations=3,
                               extra="ali 1\nreference 1\n"),
    "emweight subiterations": dict(cellpackets=2 * N ** 3, iterations=4,
                                   extra="emweight 1 0 100\n"
                                         "SUBITERATIONS\n"),
    "point sources abundance": dict(
        point_sources=SOURCES, ps_method=4, pspackets=1000, abundance=True,
        simum=(0.3, 300.0), extra="stepweight 2 1.3 0.4\n"),
    "sky roi mirror mmapabs": dict(
        hpbg=2, hpbg_weighted=True,
        extra="roi 1 4 1 4 1 4\nroisave roi.bin 1\nmirror xyz\n"
              "direweight 1 0.5\nmmapabs\n"),
}


def check_group(tmp_path, group):
    """The group's ini under `devices 4` through both packages."""
    kw = dict(GROUPS[group])
    extra = kw.pop("extra", "") + "devices 4\n"
    it = write_model(str(tmp_path / "t"), N, kind="eqdust", nfreq=NFREQ,
                     extra=extra, **kw)
    ij = write_model(str(tmp_path / "j"), N, kind="eqdust", nfreq=NFREQ,
                     extra=extra, **kw)
    rt = tdriver.run(it, device=CPU, lanes=LANES)
    assert rt.devices == [CPU] * 4
    rj = jdriver.run(ij, lanes=LANES)
    ft, fj = read_fields(tmp_path / "t", NAMES), \
        read_fields(tmp_path / "j", NAMES)
    for name in NAMES:
        close_fields(ft[name], fj[name], name,
                     NFREQ if name != "map_dir_00.bin" else N * N)
    np.testing.assert_allclose(rt.escaped, rj.escaped, rtol=2e-3,
                               atol=1e-9 * np.abs(rj.escaped).max())
    if "roisave" in extra:
        roi_t = np.fromfile(os.path.join(tmp_path, "t", "roi.bin"),
                            np.float32)
        roi_j = np.fromfile(os.path.join(tmp_path, "j", "roi.bin"),
                            np.float32)
        np.testing.assert_allclose(roi_t.sum(), roi_j.sum(), rtol=2e-3)
    return rt, rj


def test_devices_4_cell_emission_matches_soc_tpu(tmp_path):
    rt, _ = check_group(tmp_path, "cell ali reference")
    assert [p["route"] for p in rt.cell_passes] == ["ali", "ali"]
