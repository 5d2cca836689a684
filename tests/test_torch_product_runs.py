"""`devices N` end to end on the CPU: the port's rt run over N CPU shards
against its own one-device run and against soc_tpu's driver.run with
`devices N` on the same synthetic model (6^3 cells, 10 channels: N = 3
gives dp 3 x freq 1; N = 4, dp 2 x freq 2, and N = 6, dp 3 x freq 2, run
in tests/test_torch_product_rt.py, the pipeline in
tests/test_torch_product_pipeline.py: each soc_tpu run compiles its
sharded programs for about 20-30 s on the CPU, so the runs are spread over
three files that the test workers take in parallel).

Tolerances, each with its reason:
  * against the port's one-device (mixed-pool) run: the same packets on the
    same streams, only the order of the float32 additions differs: 1e-5
    relative, 1e-6 of the maximum absolute; escaped (float64 sums) 1e-6;
  * against soc_tpu: XLA's exp/log/cos/sin differ from torch's by a few
    ulps, so a rare packet takes another path (tests/test_torch_slice.py):
    per-frequency totals at 2e-3, 99% of the per-cell entries at 1e-4,
    temperatures at 1e-4.
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu.pipeline import driver as jdriver

from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.parallel import mesh as tmesh
from soc_tpu_torch.pipeline import driver as tdriver

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12
NFREQ = 10
LAYOUTS = {3: (3, 1), 4: (2, 2), 6: (3, 2)}


def read_fields(d, names):
    return {n: np.fromfile(os.path.join(d, n), np.float32) for n in names}


def close_fields(t, j, name, ncol):
    """The port's file against soc_tpu's (see the module docstring)."""
    if name == "tmp.T":
        np.testing.assert_allclose(t, j, rtol=1e-4)
        return
    np.testing.assert_array_equal(t[:2], j[:2])      # int32 headers
    a, b = t[2:].reshape(-1, ncol), j[2:].reshape(-1, ncol)
    # atol: XLA rewrites a / b / c as a / (b * c), which underflows the
    # coldest channels' emission to 0 where torch keeps ~1e-18 of the peak
    np.testing.assert_allclose(a.sum(0), b.sum(0), rtol=2e-3,
                               atol=1e-12 * np.abs(b.sum(0)).max())
    close = np.isclose(a, b, rtol=1e-4, atol=1e-7 * np.abs(b).max())
    assert close.mean() > 0.99, (name, close.mean())


def check_devices_rt(tmp_path, monkeypatch, n):
    """The port's `devices n` rt run against its one-device run and
    against soc_tpu's `devices n` run."""
    names = ("absorbed.data", "emitted.data", "tmp.T", "map_dir_00.bin")
    kw = dict(kind="eqdust", nfreq=NFREQ)
    extra = "devices %d\n" % n
    ini_d = write_model(str(tmp_path / "d"), 6, extra=extra, **kw)
    ini_1 = write_model(str(tmp_path / "one"), 6, **kw)
    ini_j = write_model(str(tmp_path / "j"), 6, extra=extra, **kw)
    sharded = []
    real = tmesh.sharded_render_ortho
    monkeypatch.setattr(tmesh, "sharded_render_ortho",
                        lambda *a: sharded.append(a[-1]) or real(*a))
    rd = tdriver.run(ini_d, device=CPU, lanes=LANES)
    assert rd.devices == [CPU] * n and len(sharded) == 1
    assert (sharded[0].n_dp, sharded[0].n_freq) == LAYOUTS[n]
    r1 = tdriver.run(ini_1, device=CPU, lanes=LANES)
    assert r1.devices is None
    # the port against itself: only the order of the additions differs
    for a, b in ((rd.absorbed, r1.absorbed), (rd.ctabs, r1.ctabs),
                 (rd.emitted, r1.emitted), (rd.maps[0], r1.maps[0])):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(rd.temperature, r1.temperature, rtol=1e-5)
    np.testing.assert_allclose(rd.escaped, r1.escaped, rtol=1e-6)
    np.testing.assert_array_equal(rd.injected, r1.injected)
    np.testing.assert_allclose(rd.absorbed_photons + rd.escaped,
                               rd.injected, rtol=1e-4)
    # the port against soc_tpu
    rj = jdriver.run(ini_j, lanes=LANES)
    fd, fj = read_fields(tmp_path / "d", names), \
        read_fields(tmp_path / "j", names)
    for name in names:
        close_fields(fd[name], fj[name], name,
                     NFREQ if name != "map_dir_00.bin" else 36)
    np.testing.assert_allclose(rd.escaped, rj.escaped, rtol=2e-3)
    np.testing.assert_array_equal(rd.injected, rj.injected)


@pytest.mark.parametrize("n", [3])
def test_devices_rt_matches(tmp_path, monkeypatch, n):
    check_devices_rt(tmp_path, monkeypatch, n)


def test_devices_and_domains_exclude_each_other(tmp_path):
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=6,
                      extra="devices 2\ndomains 2\n")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tdriver.run(ini, device=CPU, lanes=1024)


def test_devices_list_overrides_the_ini(tmp_path):
    """run(devices=[...]) takes the place of the ini's `devices N`."""
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=6,
                      extra="devices 3\n")
    res = tdriver.run(ini, device=CPU, lanes=1024, devices=[CPU] * 2)
    assert res.devices == [CPU] * 2
