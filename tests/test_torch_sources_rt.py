"""`rt` with point sources (PS_METHOD 0-5) and the Healpix sky (`hpbg`,
`hpbgw`), the port against soc_tpu on the same model: a 6^3 cloud, 6
channels, the background, an internal and an external point source (each
PS_METHOD's tables for the external one), or a Healpix sky at nside 4.

soc_tpu runs these sources one channel a pool; the port runs each source
in one mixed pool whose packets keep soc_tpu's identities, so both trace
the same packets. Tolerances as tests/test_torch_phase2.py: XLA's
exp/log/cos/sin differ from torch's by a few ulps, so a rare packet takes
another path: per-frequency totals at 2e-3, 99% of the per-cell entries
at 1e-4, temperatures at 1e-4; the injected totals are the same NumPy
arithmetic (1e-12).
"""

import os

import numpy as np
import pytest
import torch

from soc_tpu.pipeline import driver as jdriver

from soc_tpu_torch import cli
from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.pipeline import driver as tdriver

from test_torch_phase2 import NAMES, close_arrays, close_fields

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12
NFREQ = 6
N = 6
SOURCES = [(3.1, 2.9, 3.2, 0.3), (2.8, 3.3, 14.0, 1.0)]


def _files(d, names):
    return {n: np.fromfile(os.path.join(d, n), np.float32) for n in names}


def compare_runs(tmp_path, names=NAMES, ncols=None, heads=None, **kw):
    """The same model through both packages: the output files ``names``
    (each a [-1, ncols[name]] field after its int32 header of heads[name]
    words, 2 by default; NFREQ columns by default, the map's N * N), the
    injected and escaped totals; returns (port result, soc_tpu
    result)."""
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    it = write_model(dt, N, kind="eqdust", nfreq=NFREQ, **kw)
    ij = write_model(dj, N, kind="eqdust", nfreq=NFREQ, **kw)
    rt = tdriver.run(it, device=CPU, lanes=LANES)
    rj = jdriver.run(ij, lanes=LANES)
    ft, fj = _files(dt, names), _files(dj, names)
    cols = dict({"map_dir_00.bin": N * N}, **(ncols or {}))
    for n in names:
        h = (heads or {}).get(n, 2)
        if h == 2:
            close_fields(ft[n], fj[n], n, cols.get(n, NFREQ))
        else:
            np.testing.assert_array_equal(ft[n][:h], fj[n][:h])
            close_arrays(ft[n][h:], fj[n][h:], n, cols.get(n, NFREQ))
    np.testing.assert_allclose(rt.injected, rj.injected, rtol=1e-12)
    np.testing.assert_allclose(rt.escaped, rj.escaped, rtol=2e-3,
                               atol=1e-9 * np.abs(rj.escaped).max())
    # the port's own accounting: every launched weight is absorbed,
    # escapes, or was born outside the grid
    on = rt.launched > 0
    bal = (rt.absorbed_photons + rt.escaped + rt.missed)[on] \
        / rt.launched[on] - 1
    assert np.abs(bal).max() < 1e-5
    return rt, rj


@pytest.mark.parametrize("method", [0, 1, 2, 3, 4, 5])
def test_rt_point_sources_match_soc_tpu(tmp_path, method):
    rt, _ = compare_runs(tmp_path, point_sources=SOURCES, ps_method=method,
                         pspackets=3000)
    ps = [st for st in rt.source_passes if st["source"] == "ps"][0]
    assert ps["pools"] == 1 and ps["packets"] == 3000 * 2 * NFREQ
    # only the face method aims every packet of the external source at
    # the cloud; the others send some past it, born outside
    assert (ps["missed"].sum() == 0) == (method == 2)


@pytest.mark.parametrize("weighted", [False, True])
def test_rt_healpix_sky_matches_soc_tpu(tmp_path, weighted):
    rt, _ = compare_runs(tmp_path, hpbg=4, hpbg_weighted=weighted)
    sky = [st for st in rt.source_passes if st["source"] == "hpbg"][0]
    assert sky["pools"] == 1 and sky["packets"] == NFREQ * 8 * 6 * N * N


def test_cli_rt_with_point_sources(tmp_path, capsys):
    """`python -m soc_tpu_torch rt` takes the new keywords."""
    ini = write_model(str(tmp_path), 4, kind="eqdust", nfreq=4,
                      point_sources=[(2.1, 1.9, 2.2, 0.5)], pspackets=500,
                      hpbg=2)
    assert cli.main(["rt", ini, "--device", "cpu", "--lanes", "1024"]) == 0
    assert (tmp_path / "tmp.T").exists()
