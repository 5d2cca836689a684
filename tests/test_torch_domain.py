"""`domains N` (parallel/domain.py): the port's Z-slab runs against its own
one-device runs of the same model, on the CPU (port only). Every source
kind over 2, 4 and 8 slabs; options, mirrors, thin slabs, the queue's
overflow and the refusals are in tests/test_torch_domain_opts.py.

Tolerance: soc_tpu's rule for domain runs (tests/test_domain.py:76-81).
The same packets on the same streams, but a packet near a slab face moves
by up to PEPS when it crosses, and may then take another path, so a field
is held by its total within 1e-3 relative and at least 98% of its cells
within 1e-3 relative or 1e-6 of its maximum. The packets launched are
equal; each channel's balance closes within 0.5%.
"""

import numpy as np
import pytest
import torch

from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.pipeline import driver as tdriver

torch.set_num_threads(2)
CPU = torch.device("cpu")
LANES = 1 << 12
N, NFREQ = 8, 6
SOURCES = [(4.1, 3.9, 4.2, 0.3), (-3.0, 4.0, 4.5, 1.0)]
KINDS = {
    "background": dict(),
    "healpix": dict(hpbg=2),
    "ps method 0": dict(bgpac=0, point_sources=SOURCES, pspackets=1500),
    "ps method 4": dict(bgpac=0, point_sources=SOURCES, ps_method=4,
                        pspackets=1500),
    # EMWEI needs `cellpackets` (soc_tpu ties it to CLPAC); iterations 0
    # runs no cell pass
    "diffuse emweight": dict(bgpac=0, diffuse=0.5, dfpackets=2 * N ** 3,
                             cellpackets=N ** 3, extra="emweight 1 0 100\n"),
    "cell": dict(cellpackets=2 * N ** 3, iterations=2),
    "cell emweight": dict(cellpackets=2 * N ** 3, iterations=2,
                          extra="emweight 1 0 100\n"),
}
_ONE = {}


def held(got, want, name):
    """soc_tpu's rule for domain runs (module docstring)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert abs(got.sum() - want.sum()) <= 1e-3 * abs(want.sum()), name
    good = np.isclose(got, want, rtol=1e-3, atol=1e-6 * np.abs(want).max())
    assert good.mean() >= 0.98, "%s: %.4f of the cells" % (name, good.mean())


def source_balance(res):
    """Per simulated channel, (absorbed + escaped + born outside) /
    launched - 1 of a run of phase 1 alone."""
    on = res.launched > 0
    return np.abs((res.absorbed_photons + res.escaped + res.missed)[on]
                  / res.launched[on] - 1.0)


def run_pair(tmp_path, kind, slabs, extra=""):
    """The kind's model on one device (once a kind and extra) and over
    ``slabs`` CPU slabs; returns (one-device result, domain result)."""
    kw = dict(KINDS[kind])
    kw["extra"] = kw.get("extra", "") + extra
    kw.setdefault("iterations", 0)
    key = (kind, extra)
    if key not in _ONE:
        ini = write_model(str(tmp_path / "one"), N, kind="eqdust",
                          nfreq=NFREQ, **kw)
        _ONE[key] = tdriver.run(ini, device=CPU, lanes=LANES)
    kw["extra"] += "domains %d\n" % slabs
    ini = write_model(str(tmp_path / "dom"), N, kind="eqdust", nfreq=NFREQ,
                      **kw)
    dom = tdriver.run(ini, device=CPU, lanes=LANES)
    assert dom.domains == [CPU] * slabs and dom.devices is None
    return _ONE[key], dom


def check_pair(one, dom, slabs):
    """The domain run held to the one-device run: every pass's own TABS
    and channel sums, the run's fields, the balance."""
    assert len(dom.source_passes) == len(one.source_passes)
    for so, sd in zip(one.source_passes, dom.source_passes):
        assert sd["route"] == "domains" and sd["slabs"] == slabs
        assert sd["domain"]["supersteps"] > 0
        np.testing.assert_array_equal(sd["launched"], so["launched"])
        np.testing.assert_allclose(sd["missed"], so["missed"], rtol=1e-12)
        held(sd["tabs"], so["tabs"], so["source"] + " tabs")
        np.testing.assert_allclose(sd["escaped"], so["escaped"], rtol=1e-3,
                                   atol=1e-9 * so["escaped"].max())
    assert len(dom.cell_passes) == len(one.cell_passes)
    for co, cd in zip(one.cell_passes, dom.cell_passes):
        assert cd["slabs"] == slabs and cd["route"] == co["route"]
        assert cd["packets"] == co["packets"]
        assert np.abs(tdriver.pass_balance(cd)).max() < 5e-3
    for name in ("ctabs", "absorbed", "temperature", "emitted"):
        if getattr(one, name) is not None:
            held(getattr(dom, name), getattr(one, name), name)
    np.testing.assert_allclose(dom.escaped.sum(), one.escaped.sum(),
                               rtol=1e-3)
    if not one.cell_passes:
        assert source_balance(dom).max() < 5e-3


@pytest.mark.parametrize("slabs", [2, 4, 8])
@pytest.mark.parametrize("kind", list(KINDS))
def test_every_source_matches_one_pool(tmp_path, kind, slabs):
    one, dom = run_pair(tmp_path, kind, slabs)
    if kind == "diffuse emweight":
        assert one.source_passes[0]["route"] == "emweight"
    check_pair(one, dom, slabs)
