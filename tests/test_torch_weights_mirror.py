"""`mirror`, `stepweight 1|2` and `direweight`: the port against soc_tpu on
the same packets, and the physics each keyword must keep.

soc_tpu runs these keywords one channel a pool; the port runs one mixed
pool whose packets keep soc_tpu's identities (hi = base + channel, k the
id within the channel), at the same seed and lanes, so both trace the same
packets. Tolerances, each with its reason:
  * tallies against soc_tpu: XLA's exp/log/cos/sin (and pow, in
    DIR_WEIGHT's p_HG) differ from torch's by a few ulps, so a rare packet
    takes another path (tests/test_torch_transport.py): the per-cell tally
    at 1e-4 of its maximum on 99% of the cells, per-frequency escaped and
    absorbed totals at 2e-3;
  * a fully mirrored box keeps its photons: escapes below 1e-3 of the
    injected weight, absorbed within 2e-3 of it (soc_tpu's bounds,
    tests/test_mirror.py); mirrored X faces: less escapes than without,
    and absorbed + escaped within 2e-3 of the injected weight;
  * STEP_WEIGHT 2's importance identity on 2^20 stratified uniforms:
    E[w] and E[w t] within 1e-3 of 1, E[w t^2] within 5e-3 of 2
    (tests/test_ini_wiring.py's bounds);
  * `stepweight` with `split`: no clone, and the same tallies as `split 0`
    bit for bit (soc_tpu turns splitting off).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
from soc_tpu.grid import uniform_grid as j_uniform_grid
from soc_tpu.io.dust import hg_scattering_function
from soc_tpu.pipeline import driver as jdriver
from soc_tpu.transport import propagate as jprop
from soc_tpu.transport import sources as jsrc

from soc_tpu_torch.example_model import octree_cloud
from soc_tpu_torch.grid import grid_from_arrays as t_grid_from_arrays
from soc_tpu_torch.grid import uniform_grid as t_uniform_grid
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.config import RunConfig
from soc_tpu_torch.transport import propagate as tprop

torch.set_num_threads(2)
CPU = torch.device("cpu")
NF = 4
SEED = 17
LANES = 1 << 12
KABS = np.asarray([0.05, 0.1, 0.3, 0.6], np.float32)
KSCA = np.asarray([0.1, 0.2, 0.05, 0.3], np.float32)
DSC, CSC = hg_scattering_function([0.0, 0.3, 0.6, -0.2], 64)
PS_HI = int(jsrc.stream_hi_base("ps"))


def _grids(kind):
    if kind == "uniform":
        return j_uniform_grid(6, 6, 6), t_uniform_grid(6, 6, 6, CPU)
    lcells, values = octree_cloud(8, 2, 8, 3)
    return (j_grid_from_arrays(8, 8, 8, lcells, values),
            t_grid_from_arrays(8, 8, 8, lcells, values, CPU))


def _soc_tpu(jg, n, pos, extra=None, mirror=0):
    """soc_tpu: one point-source pool a channel. Returns (tabs, escaped
    [NF], absorbed [NF])."""
    tabs = np.zeros(jg.cells)
    esc, absd = np.zeros(NF), np.zeros(NF)
    for f in range(NF):
        phys = dict(kabs=jnp.float32(KABS[f]), ksca=jnp.float32(KSCA[f]),
                    csc=jnp.asarray(CSC[f]), tw=jnp.float32(1.0))
        if extra:
            phys.update(extra(f))
        params = dict(ps_pos=jnp.asarray([pos], jnp.float32),
                      photons=jnp.ones(1, jnp.float32), ifreq=jnp.int32(f),
                      per_freq=jnp.int32(n), hi_base=jnp.uint32(PS_HI))
        out = jprop.transport_run(
            jg, phys, params, jnp.int32(n), jnp.zeros(jg.cells, jnp.float32),
            jnp.zeros((1, 1), jnp.float32), SEED, source_kind="ps",
            nlanes=LANES, mirror_mask=mirror)
        tabs += np.asarray(out[0], np.float64)
        esc[f], absd[f] = float(out[2][0]), float(out[3])
    return tabs, esc, absd


def _port(tg, n, pos, extra=None, mirror=0, split_max=0):
    """The port: one mixed point-source pool over the NF channels, with a
    per-frequency tally. Returns (tabs, escaped [NF], absorbed [NF],
    clones)."""
    phys = dict(kabs=torch.as_tensor(KABS), ksca=torch.as_tensor(KSCA),
                csc=torch.as_tensor(CSC), tw=torch.ones(NF))
    phys.update(extra or {})
    params = dict(ps_pos=torch.tensor([pos], dtype=torch.float32),
                  photons=torch.ones((1, NF)), per_freq=n, hi_base=PS_HI)
    intf = torch.zeros((tg.cells, NF))
    out = tprop.transport_run(
        tg, phys, params, n * NF, torch.zeros(tg.cells), intf, SEED,
        source_kind="ps", nlanes=LANES, per_freq_tally=True,
        mirror_mask=mirror, split_max=split_max)
    clones = int(out[4]) if split_max > 0 else 0
    return (out[0].numpy().astype(np.float64), out[2].numpy(),
            intf.sum(0, dtype=torch.float64).numpy(), clones)


def _close(t, j):
    tt, te, ta = t[:3]
    jt, je, ja = j
    close = np.isclose(tt, jt, rtol=1e-4, atol=1e-4 * jt.max())
    assert close.mean() > 0.99, close.mean()
    np.testing.assert_allclose(te, je, rtol=2e-3, atol=1e-9 * je.max())
    np.testing.assert_allclose(ta, ja, rtol=2e-3)


@pytest.mark.parametrize("grid", ["uniform", "octree"])
def test_mirror_all_faces_keeps_every_photon(grid):
    """`mirror xXyYzZ` from a point source inside: the port against
    soc_tpu, and nothing escapes (up to the packets that die at
    MAX_SCATTERINGS, which count as escaped)."""
    jg, tg = _grids(grid)
    n = 2000
    pos = (3.0, 3.1, 2.9) if grid == "uniform" else (4.1, 3.9, 4.2)
    t = _port(tg, n, pos, mirror=63)
    _close(t, _soc_tpu(jg, n, pos, mirror=63))
    esc, absd = t[1], t[2]
    assert (esc / n).max() < 1e-3, esc / n
    np.testing.assert_allclose(absd, n, rtol=2e-3)


def test_mirror_x_faces():
    """`mirror xX`: less escapes than with open faces, the balance holds,
    and the port agrees with soc_tpu."""
    jg, tg = _grids("uniform")
    n, pos = 4000, (3.0, 3.1, 2.9)
    t = _port(tg, n, pos, mirror=3)
    _close(t, _soc_tpu(jg, n, pos, mirror=3))
    _, esc_open, abs_open, _ = _port(tg, n, pos)
    assert (t[1] < esc_open).all() and (t[2] > abs_open).all()
    np.testing.assert_allclose(t[1] + t[2], n, rtol=2e-3)


WEIGHTS = {
    "stepweight1": (lambda f: dict(sw_a=jnp.float32(1.4)), dict(sw_a=1.4)),
    "stepweight2": (lambda f: dict(sw_a=jnp.float32(1.3),
                                   sw_b=jnp.float32(0.4)),
                    dict(sw_a=1.3, sw_b=0.4)),
    "direweight": (lambda f: dict(dw_a=jnp.float32(0.5),
                                  dsc=jnp.asarray(DSC[f])),
                   dict(dw_a=0.5, dsc=torch.as_tensor(DSC))),
}


@pytest.mark.parametrize("case", list(WEIGHTS))
def test_weighted_transport_matches_soc_tpu(case):
    """STEP_WEIGHT 1 and 2 (the birth and every scattering weighted) and
    DIR_WEIGHT (the deflection from HG(0.5), weighted by p_DSC / p_HG at
    each lane's channel) on the octree, equal seed and lanes."""
    jg, tg = _grids("octree")
    n, pos = 2000, (4.1, 3.9, 4.2)
    jx, tx = WEIGHTS[case]
    _close(_port(tg, n, pos, tx), _soc_tpu(jg, n, pos, jx))


def test_stepweight2_importance_identity():
    """STEP_WEIGHT 2's proposal (kernel_ASOC.c:529-541): the weighted
    moments reproduce the unit exponential's."""
    grid = t_uniform_grid(2, 2, 2, CPU)
    phys = dict(kabs=torch.ones(1), ksca=torch.ones(1),
                csc=torch.zeros((1, 8)), tw=torch.ones(1), sw_a=1.3,
                sw_b=0.4)
    kit = tprop.StepKit(grid, phys, 1, False)
    u = torch.as_tensor(((np.arange(1 << 20) + 0.5) / (1 << 20))
                        .astype(np.float32))
    fp, w = kit.draw_fp_weighted(u)
    fp, w = fp.double().numpy(), w.double().numpy()
    assert abs(w.mean() - 1.0) < 1e-3
    assert abs((w * fp).mean() - 1.0) < 1e-3
    assert abs((w * fp * fp).mean() - 2.0) < 5e-3


def test_stepweight_turns_splitting_off():
    """`stepweight` with `split 4` on the octree: no clone is served and
    the tallies are those of split 0, bit for bit."""
    _, tg = _grids("octree")
    pos = (4.1, 3.9, 4.2)
    sw = dict(sw_a=1.4)
    split = _port(tg, 1000, pos, sw, split_max=4)
    plain = _port(tg, 1000, pos, sw)
    assert split[3] == 0
    for a, b in zip(split[:3], plain[:3]):
        np.testing.assert_array_equal(a, b)
    # without the weighting the same run splits
    assert _port(tg, 1000, pos, split_max=4)[3] > 0


def test_mirror_mask_of_matches_soc_tpu(tmp_path):
    ini = tmp_path / "m.ini"
    for faces in ("", "x", "xX", "yZ", "xXyYzZ"):
        ini.write_text("mirror %s\n" % faces if faces else "seed 1\n")
        from soc_tpu.config import RunConfig as JConfig
        assert tdriver.mirror_mask_of(RunConfig(str(ini))) \
            == jdriver.mirror_mask_of(JConfig(str(ini)))
