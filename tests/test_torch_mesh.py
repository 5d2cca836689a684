"""parallel/mesh.py's library on the CPU: make_mesh and the seven sharded_*
functions against soc_tpu's on its 8 CPU devices (dp 4 x freq 2), at
tests/test_parallel.py's shapes, and against the port's one-device forms
(the same functions over a one-shard mesh).

Tolerances, each with its reason:
  * against soc_tpu: XLA's exp/log/cos/sin differ from torch's by a few
    ulps, so a rare packet takes another path (tests/test_torch_product.py):
    totals and escaped at 2e-3, 90% of the cells at 1e-4; the temperature
    (a lookup of those heatings) at 1e-4 of 90% of the cells and 2e-3 on
    every one, the map (integrated over every cell it crosses) at 2e-3;
    the solves and emission of the same heating at 1e-5 (both float32
    elementwise);
  * against the one-shard mesh: the same packets on the same paths, only
    the order of the float32 additions differs: 1e-5 relative, 1e-6 of
    the maximum absolute; the solves and the render bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_tpu.grid import uniform_grid as j_uniform_grid
from soc_tpu.io.dust import hg_scattering_function
from soc_tpu.parallel import mesh as jmesh
from soc_tpu.solve import equilibrium as jeq
from soc_tpu.transport.medium import Medium as JMedium, trapezoid_weights

from soc_tpu_torch.grid import uniform_grid
from soc_tpu_torch.parallel import mesh as tmesh
from soc_tpu_torch.solve import equilibrium as teq
from soc_tpu_torch.transport.medium import medium_from_numpy

torch.set_num_threads(2)
CPU = torch.device("cpu")
NFREQ = 4
GL_PC = 0.01
GL_CM = GL_PC * 3.0856775814913673e18


def media():
    """tests/test_parallel.py's medium, in both packages."""
    freq = np.logspace(11, 13, NFREQ)
    dsc, csc = hg_scattering_function([0.4] * NFREQ, 64)
    kabs = np.full(NFREQ, 0.15, np.float32)
    ksca = np.full(NFREQ, 0.1, np.float32)
    tw = trapezoid_weights(freq)
    jm = JMedium(abs_gl=jnp.asarray(kabs), sca_gl=jnp.asarray(ksca),
                 csc=jnp.asarray(csc), dsc=jnp.asarray(dsc),
                 tw=jnp.asarray(tw), nfreq=NFREQ, bins=64)
    return freq, jm, medium_from_numpy(kabs, ksca, csc, dsc, tw, CPU)


@pytest.fixture(scope="module")
def setup():
    freq, jm, tm = media()
    return dict(freq=freq, jm=jm, tm=tm,
                jg=j_uniform_grid(6, 6, 6, density=1.0),
                tg=uniform_grid(6, 6, 6, CPU),
                jmesh=jmesh.make_mesh(jax.devices(), freq_axis=2),
                mesh=tmesh.make_mesh([CPU] * 8, freq_axis=2),
                one=tmesh.make_mesh([CPU]))


def against_soc_tpu(got, want, share=0.9):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=2e-3)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-7 * np.abs(want).max())
    assert close.mean() >= share, close.mean()


def against_one_shard(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("freq_axis", [1, 2, 3, 4, 8])
def test_make_mesh_matches_soc_tpu(freq_axis):
    """soc_tpu's (dp, freq) for an explicit F (1 where F does not divide
    the device count), shard (dp, fq) on device dp*F + fq."""
    jm = jmesh.make_mesh(jax.devices(), freq_axis=freq_axis)
    tm = tmesh.make_mesh([CPU] * 8, freq_axis=freq_axis)
    assert (tm.n_dp, tm.n_freq) == (jm.shape["dp"], jm.shape["freq"])
    ids = [[d.id for d in row] for row in jm.devices]
    assert ids == [[dp * tm.n_freq + fq for fq in range(tm.n_freq)]
                   for dp in range(tm.n_dp)]
    assert tm.with_nfreq(8).nf_local == 8 // tm.n_freq
    with pytest.raises(AssertionError, match="NFREQ must divide"):
        tmesh.make_mesh([CPU] * 8, freq_axis=8).with_nfreq(6)


def test_per_freq_must_divide_dp(setup):
    with pytest.raises(AssertionError, match="per_freq must divide"):
        tmesh.sharded_background_run(setup["tg"], setup["tm"],
                                     np.ones(NFREQ), 6, 7, setup["mesh"])


@pytest.mark.parametrize("kind", ["bg", "ps", "hpbg", "cell"])
def test_sharded_sources_match(setup, kind):
    """Each source's (tabs, escaped) against soc_tpu's sharded run and the
    one-shard mesh."""
    s = setup
    area = int(s["tg"].area)
    rng = np.random.default_rng(3)
    if kind == "bg":
        args = (np.ones(NFREQ, np.float32), 4 * area, 7)
        fn = "sharded_background_run"
    elif kind == "ps":
        args = (np.asarray([[3.0, 3.0, 3.0]], np.float32),
                np.full((1, NFREQ), 2.0, np.float32), 4096, 13)
        fn = "sharded_point_source_run"
    elif kind == "hpbg":
        args = (rng.uniform(0.5, 1.5, (NFREQ, 48)).astype(np.float32),
                4 * area, 5)
        fn = "sharded_hpbg_run"
    else:
        args = (rng.uniform(0.5, 1.5, (s["tg"].cells, NFREQ)).astype(
            np.float32), 4, 11)
        fn = "sharded_cell_emission_run"
    lanes = 1024 if kind in ("cell", "ps") else 2048
    jt, je = getattr(jmesh, fn)(s["jg"], s["jm"], *args, s["jmesh"],
                                nlanes=lanes)
    tt, te = getattr(tmesh, fn)(s["tg"], s["tm"], *args, s["mesh"],
                                nlanes=lanes)
    ot, oe = getattr(tmesh, fn)(s["tg"], s["tm"], *args, s["one"],
                                nlanes=lanes)
    against_soc_tpu(tt.numpy(), jt)
    np.testing.assert_allclose(te, np.asarray(je), rtol=2e-3)
    against_one_shard(tt.numpy(), ot.numpy())
    np.testing.assert_allclose(te, oe, rtol=1e-6)


def test_sharded_solve_and_emission_match(setup):
    s = setup
    heat = np.random.default_rng(4).uniform(
        1e-12, 1e-9, s["tg"].cells).astype(np.float32)
    jtab = jeq.build_temperature_table(s["freq"], s["jm"].abs_gl, GL_PC)
    ttab = teq.build_temperature_table(s["freq"], s["tm"].abs_gl, GL_PC, CPU)
    jt = jmesh.sharded_solve_temperature(s["jg"], jtab, jnp.asarray(heat),
                                         GL_CM, s["jmesh"])
    tt = tmesh.sharded_solve_temperature(s["tg"], ttab, heat, GL_CM,
                                         s["mesh"])
    ot = tmesh.sharded_solve_temperature(s["tg"], ttab, heat, GL_CM,
                                         s["one"])
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    assert torch.equal(tt, ot)
    je = jmesh.sharded_emission(s["freq"], s["jm"].abs_gl, jt, GL_CM,
                                s["jmesh"])
    te = tmesh.sharded_emission(s["freq"], s["tm"].abs_gl, tt, GL_CM,
                                s["mesh"])
    oe = tmesh.sharded_emission(s["freq"], s["tm"].abs_gl, tt, GL_CM,
                                s["one"])
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6 * float(np.abs(je).max()))
    assert torch.equal(te, oe)


def test_sharded_pipeline_matches(setup):
    """tests/test_parallel.py's pipeline (iterations 2, 4 packets a cell,
    an 8x8 map) against soc_tpu's and the one-shard mesh's."""
    s = setup
    per_freq = 4 * int(s["tg"].area)
    bg = np.full(NFREQ, 1e6, np.float32)
    kw = dict(iterations=2, per_cell=4, npix=(8, 8), nlanes=1024)
    j = jmesh.sharded_pipeline(s["jg"], s["jm"], s["freq"], bg, per_freq,
                               GL_PC, s["jmesh"], **kw)
    t = tmesh.sharded_pipeline(s["tg"], s["tm"], s["freq"], bg, per_freq,
                               GL_PC, s["mesh"], **kw)
    o = tmesh.sharded_pipeline(s["tg"], s["tm"], s["freq"], bg, per_freq,
                               GL_PC, s["one"], **kw)
    against_soc_tpu(t["tabs"].numpy(), j["tabs"])
    np.testing.assert_allclose(t["escaped"], np.asarray(j["escaped"]),
                               rtol=2e-3)
    tt, jt = t["temperature"].numpy(), np.asarray(j["temperature"])
    np.testing.assert_allclose(tt, jt, rtol=2e-3)
    assert np.isclose(tt, jt, rtol=1e-4).mean() >= 0.9
    np.testing.assert_allclose(t["map"].numpy(), np.asarray(j["map"]),
                               rtol=2e-3, atol=1e-8)
    np.testing.assert_allclose(t["colden"].numpy(), np.asarray(j["colden"]),
                               rtol=1e-5)
    for k in ("tabs", "temperature", "emitted", "map", "tau"):
        against_one_shard(t[k].numpy(), o[k].numpy())
