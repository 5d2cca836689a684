"""The emission side of polarization and cosmic-ray heating, the port
against soc_tpu: `polarisation`'s pol_specs and _rpol_factor, the
multi-dust solve with the polarised sum (a stochastic dust through the
A2E align path's plain twin, an equilibrium dust through its .rpol
factor, with abundances), `CR_HEATING` modes 1-3 in the multi-dust solve,
`CR_HEATING` in `rt`'s temperature solve, and the `pipeline` verb on a
3-level octree writing <emitted>.P.

Tolerances, each with its reason:
  * pol_specs, _rpol_factor, cr_heating_channel: bit for bit (the same
    NumPy arithmetic);
  * the multi-dust solve (EMITTED and PEMITTED): rtol 2e-5 with 1e-6 of
    the maximum, tests/test_torch_a2e.py's (the same float32 math summed
    in another order);
  * temperatures from one tally: rtol 1e-5, tests/test_torch_solve_render.py's
    (XLA's log10 and pow a few ulps off torch's);
  * PEMITTED against EMITTED in the port's own run: at most EMITTED to 1e-6
    relative (the aligned share is a weight in [0, 1] on the same sum),
    equal to 1e-6 where every size is aligned, zero where none is;
  * a rerun with the same seed on the CPU: bit for bit; the `devices`
    mesh against one device: temperatures at 1e-4 relative (the tally
    summed over the shards in another order, tests/test_torch_product.py),
    as PEMITTED (and 1e-6 of its maximum); the elementwise solves and
    the A2E split bit for bit.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.config import RunConfig as JConfig
from soc_tpu.io.cloud import read_cloud as j_read_cloud
from soc_tpu.io.dust import read_simple_dust as j_read_simple_dust
from soc_tpu.pipeline import full as jfull
from soc_tpu.pipeline import mabu as jmabu
from soc_tpu.solve import equilibrium as jeq

from soc_tpu_torch.config import RunConfig as TConfig
from soc_tpu_torch.constants import PARSEC
from soc_tpu_torch.example_model import write_model
from soc_tpu_torch.io.fields import read_cell_frequency_array
from soc_tpu_torch.pipeline import driver as tdriver
from soc_tpu_torch.pipeline import full as tfull
from soc_tpu_torch.pipeline import mabu as tmabu
from soc_tpu_torch.solve import a2e_kernel
from soc_tpu_torch.solve import dust_compiler as dc
from soc_tpu_torch.solve import stochastic
from soc_tpu_torch.solve.solver_file import read_solver

sys.path.insert(0, "tests")
from test_a2e import random_solver  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
NF = 8
CELLS = 300


def _close(got, ref, name):
    np.testing.assert_allclose(got, ref, rtol=2e-5,
                               atol=1e-6 * np.abs(ref).max(), err_msg=name)


def _components(ne, seed=5):
    """(soc_tpu's, the port's) component lists over one solver: a
    stochastic dust of 3 sizes (1e-7, 1e-6, 1e-5 cm) and an equilibrium
    dust; with absorbed [CELLS, NF] and abundances."""
    solver = random_solver(ne=ne, nfreq=NF, nsize=3, seed=9)
    solver.size_a[:] = [1e-7, 1e-6, 1e-5]
    freq = np.asarray(solver.freq, np.float64)
    rng = np.random.default_rng(seed)
    kabs_eq = rng.uniform(0.5, 2.0, NF) * 1e-22
    comps = []
    for m in (jmabu, tmabu):
        comps.append([m.DustComponent("g", "gset", solver.k_abs,
                                      solver=solver),
                      m.DustComponent("e", "eqdust", kabs_eq, freq=freq)])
    absorbed = (rng.random((CELLS, NF)) * 1e-3).astype(np.float32)
    abu = rng.uniform(0.5, 1.5, (CELLS, 2)).astype(np.float32)
    return comps, absorbed, abu, solver


@pytest.fixture
def pol_dir(tmp_path, monkeypatch):
    """A directory with a DustEM-compiled dust's .rpol table (tst.rpol)
    and an aalg file over CELLS cells; returns (frequencies, sizes)."""
    monkeypatch.chdir(tmp_path)
    from soc_tpu_torch.example_model import _compiled_dust, frequencies
    dust = _compiled_dust(str(tmp_path), 12, 6)
    freq = frequencies(12)
    dc.write_polarized_dust_aux(dust, freq, prefix="tst")
    rng = np.random.default_rng(2)
    aalg = np.exp(rng.uniform(np.log(dust.size_a[0] / 3),
                              np.log(3 * dust.size_a[-1]), CELLS))
    np.concatenate([[CELLS], aalg]).astype(np.float32).tofile("a.bin")
    return freq, dust.size_a


def test_rpol_factor_and_pol_specs_match_soc_tpu(pol_dir):
    freq, _ = pol_dir
    aalg = np.fromfile("a.bin", np.float32)[1:]
    r_t = tfull._rpol_factor("tst", freq, aalg)
    r_j = jfull._rpol_factor("tst", freq, aalg)
    np.testing.assert_array_equal(r_t, r_j)
    assert (r_t == 0).any() and (r_t > 0).any() and r_t.max() <= 1.0
    text = "polarisation gs_TST.dust a.bin\npolarisation tst.dust a.bin\n"
    specs = []
    for cfg_cls, m, full in ((JConfig, jmabu, jfull),
                             (TConfig, tmabu, tfull)):
        comps = [m.DustComponent("gs_TST", "gset", np.ones(12)),
                 m.DustComponent("tst", "eqdust", np.ones(12), freq=freq),
                 m.DustComponent("other", "eqdust", np.ones(12),
                                 freq=freq)]
        specs.append(full.pol_specs(cfg_cls(text=text), comps, freq, CELLS))
    j, t = specs
    assert sorted(t) == sorted(j) == [0, 1]
    for d in t:
        assert t[d][0] == j[d][0] == ("aalg", "rfactor")[d]
        np.testing.assert_array_equal(t[d][1], j[d][1])
    assert tfull.pol_specs(TConfig(text=""), [], freq, CELLS) is None


@pytest.mark.parametrize("ne", [16, 32])
def test_polarised_multi_dust_matches_soc_tpu(monkeypatch, ne):
    """EMITTED and PEMITTED of a stochastic dust (aalg across its sizes)
    and an equilibrium dust (an .rpol factor), with abundances."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    (jc, tc), absorbed, abu, solver = _components(ne)
    rng = np.random.default_rng(7)
    aalg = np.exp(rng.uniform(np.log(3e-8), np.log(3e-5), CELLS)).astype(
        np.float32)
    rfac = rng.uniform(0.0, 1.0, (CELLS, NF)).astype(np.float32)
    pol = {0: ("aalg", aalg), 1: ("rfactor", rfac)}
    e_j, p_j = jmabu.solve_emission_multi(jc, absorbed, abu, pol=pol)
    e_t, p_t = tmabu.solve_emission_multi(tc, absorbed, CPU, abu=abu,
                                          pol=pol)
    _close(e_t, e_j, "EMITTED")
    _close(p_t, p_j, "PEMITTED")
    assert (p_t <= e_t * (1 + 1e-6)).all() and 0 < p_t.sum() < e_t.sum()


@pytest.mark.parametrize("where", ["below", "above"])
def test_aalg_outside_the_size_grid(monkeypatch, where):
    """An aalg below the smallest size aligns every size (PEMITTED equals
    EMITTED); above the largest, none (zero)."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    (_, tc), absorbed, _, solver = _components(16)
    size = 0.5 * solver.size_a.min() if where == "below" \
        else 10.0 * solver.size_a.max()
    aalg = np.full(CELLS, size, np.float32)
    e, p = tmabu.solve_emission_multi(tc[:1], absorbed, CPU,
                                      pol={0: ("aalg", aalg)})
    if where == "below":
        np.testing.assert_allclose(p, e, rtol=1e-6)
    else:
        assert (p == 0).all() and e.max() > 0


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_cr_heating_matches_soc_tpu(monkeypatch, mode):
    """`CR_HEATING` modes 1-3: the heating channel bit for bit and the
    multi-dust solve (the rate split between the dusts through the last
    channel) against soc_tpu's."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    (jc, tc), absorbed, abu, _ = _components(16)
    dens = np.logspace(2, 7, CELLS).astype(np.float32)
    np.testing.assert_array_equal(
        tmabu.cr_heating_channel(mode, dens, CELLS),
        jmabu.cr_heating_channel(mode, dens, CELLS))
    e_j = jmabu.solve_emission_multi(jc, absorbed, abu, cr_mode=mode,
                                     dens=dens)
    e_t = tmabu.solve_emission_multi(tc, absorbed, CPU, abu=abu,
                                     cr_mode=mode, dens=dens)
    _close(e_t, e_j, "EMITTED")
    plain = tmabu.solve_emission_multi(tc, absorbed, CPU, abu=abu)
    # the equilibrium dust takes the rate as heating: more emission
    assert e_t.sum() > plain.sum()


def test_cr_heating_stochastic_channel_is_clipped(monkeypatch):
    """Kept as soc_tpu does it: a stochastic dust takes the CR rate as its
    last channel's absorptions, which solve_emission clips to 0.2 times
    the channel below; the solve equals the plain solve of the clipped
    field bit for bit. On a field whose channel below absorbs less than
    five times the rate (absorptions of 1e-9 a channel here, against the
    rate's 1e-7) the clip removes most of the rate."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    (_, tc), absorbed, _, _ = _components(16)
    absorbed = absorbed * np.float32(1e-6)
    gset = tc[:1]
    e_cr = tmabu.solve_emission_multi(gset, absorbed, CPU, cr_mode=1)
    rate = tmabu.cr_heating_channel(1, None, CELLS)
    clipped = absorbed.copy()
    clipped[:, -1] = np.clip(rate, 0.0, 0.2 * absorbed[:, -2])
    np.testing.assert_array_equal(
        e_cr, tmabu.solve_emission_multi(gset, clipped, CPU))
    assert (clipped[:, -1] < 0.5 * rate).mean() > 0.5


def test_rt_cr_heating_temperatures(tmp_path):
    """`rt` with `CR_HEATING 1.0` on the 3-level octree: the temperatures
    equal soc_tpu's temperature solve of the run's own tally with the
    same rate, and at least those of the same run (the same packets)
    without it, higher in the coldest cells."""
    kw = dict(kind="eqdust", nfreq=10, octree=(2, 8, 3))
    ini = write_model(str(tmp_path / "cr"), 8, extra="CR_HEATING 1.0\n",
                      **kw)
    res = tdriver.run(ini, device=CPU, lanes=4096)
    plain = tdriver.run(write_model(str(tmp_path / "plain"), 8, **kw),
                        device=CPU, lanes=4096)
    np.testing.assert_array_equal(res.ctabs, plain.ctabs)
    d = tmp_path / "cr"
    cfg = JConfig(str(d / "run.ini"))
    jg = j_read_cloud(str(d / "tmp.cloud"), cfg.kdensity)
    opt = j_read_simple_dust(str(d / "tst.dust"), cfg.gl)
    table = jeq.build_temperature_table(opt.freq, opt.abs_gl, cfg.gl)
    jt = np.asarray(jeq.solve_temperature(jg, table,
                                          jnp.asarray(res.ctabs),
                                          cfg.gl * PARSEC, cr_heating=1.0))
    np.testing.assert_allclose(res.temperature, jt, rtol=1e-5)
    leaf = res.grid.dens.numpy() > 0
    assert (res.temperature >= plain.temperature).all()
    cold = plain.temperature[leaf] <= np.percentile(
        plain.temperature[leaf], 10)
    assert (res.temperature[leaf][cold] > plain.temperature[leaf][cold]) \
        .all()


def test_pipeline_writes_polarised_emission(tmp_path):
    """The `pipeline` verb on the 3-level octree with a GSET dust,
    `polarisation` and `polmap`: <emitted>.P equal to the returned
    PEMITTED, at most EMITTED, zero on the parents, EMITTED where aalg is
    below the smallest grain size and zero where it is above the largest;
    the A2E solve took the align path once on the CPU's plain twin (no
    kernel launch) and the polarization map rendered."""
    ini = write_model(str(tmp_path), 8, kind="gset", nfreq=10, nsize=6,
                      octree=(2, 8, 3), bfield="tangled", polarisation=True,
                      extra="nenumber 16\npolmap Bx.bin By.bin Bz.bin\n")
    n0 = a2e_kernel.launches
    res_rt, emitted, res_map = tfull.run_pipeline(ini, CPU, lanes=4096)
    assert a2e_kernel.launches == n0
    pem = read_cell_frequency_array(str(tmp_path / "emitted.data.P"))
    np.testing.assert_array_equal(pem, res_map.pemitted)
    parents = res_rt.absorbed[:, 0] < -1e19
    assert parents.sum() == 16 and (pem[parents] == 0).all()
    assert (pem <= emitted * (1 + 1e-6)).all()
    aalg = np.fromfile(str(tmp_path / "aalg.bin"), np.float32)[1:]
    sizes = read_solver(str(tmp_path / "gs_TST.solver")).size_a
    below = (aalg < sizes[0]) & ~parents
    above = (aalg > sizes[-1]) & ~parents
    assert below.sum() > 10 and above.sum() > 10
    np.testing.assert_allclose(pem[below], emitted[below], rtol=1e-6)
    assert (pem[above] == 0).all()
    assert 0 < pem.sum() < emitted.sum()
    assert ("pol", 0) in res_map.maps
    assert np.isfinite(res_map.maps[("pol", 0)][0]).all()
    assert os.path.exists(tmp_path / "polmap_dir_00.bin")


def test_devices_mesh_matches_one_device(tmp_path):
    """Under `devices 2` (two CPU shards): `rt` with `CR_HEATING` (its
    tally summed over the shards, so the temperatures within the mesh's
    1e-4 relative, tests/test_torch_product.py; the temperature solve with
    the rate split over four shards bit for bit) and the `pipeline` verb
    with `polarisation` (<emitted>.P at the mesh's bound; the A2E solve
    with the align weights split over three shards bit for bit)."""
    from soc_tpu_torch.parallel import product
    from soc_tpu_torch.solve import equilibrium as teq
    kw = dict(kind="eqdust", nfreq=8, octree=(2, 8, 3))
    one = tdriver.run(write_model(str(tmp_path / "rt1"), 8,
                                  extra="CR_HEATING 2.0\n", **kw),
                      device=CPU, lanes=4096)
    two = tdriver.run(write_model(str(tmp_path / "rt2"), 8,
                                  extra="CR_HEATING 2.0\ndevices 2\n", **kw),
                      device=CPU, lanes=4096)
    assert two.devices is not None and len(two.devices) == 2
    np.testing.assert_allclose(two.temperature, one.temperature, rtol=1e-4)
    table = teq.build_temperature_table(
        one.freq, one.medium.abs_gl.numpy(), 0.01, CPU)
    tabs = torch.as_tensor(one.ctabs)
    gl_cm = 0.01 * PARSEC
    pm = product.ProductMesh(4, 8, [CPU] * 4)
    np.testing.assert_array_equal(
        product.solve_temperature(pm, one.grid, table, tabs, gl_cm,
                                  cr_heating=2.0).numpy(),
        teq.solve_temperature(one.grid, table, tabs, gl_cm,
                              cr_heating=2.0).numpy())
    kw = dict(kind="gset", nfreq=8, nsize=4, polarisation=True)
    runs = {}
    for name, extra in (("p1", ""), ("p2", "devices 2\n")):
        ini = write_model(str(tmp_path / name), 6, extra="nenumber 16\n"
                          + extra, **kw)
        runs[name] = tfull.run_pipeline(ini, CPU, lanes=4096)
    pem = runs["p1"][2].pemitted
    np.testing.assert_allclose(runs["p2"][2].pemitted, pem, rtol=1e-4,
                               atol=1e-6 * pem.max())
    assert pem.max() > 0
    sol = read_solver(str(tmp_path / "p1" / "gs_TST.solver"))
    aalg = np.fromfile(str(tmp_path / "p1" / "aalg.bin"), np.float32)[1:]
    absorbed = runs["p1"][0].absorbed
    ref = stochastic.solve_emission(sol, absorbed, CPU, aalg=aalg)
    got = stochastic.solve_emission(sol, absorbed, CPU, aalg=aalg,
                                    devices=[CPU] * 3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
