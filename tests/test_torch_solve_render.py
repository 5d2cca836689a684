"""soc_tpu_torch against soc_tpu: equilibrium dust, multi-dust emission and
orthographic maps, on the same NumPy inputs.

Tolerances: both packages compute in float32 with the same operation
order; XLA's log10, pow, exp and expm1 differ from torch's by a few ulps,
so results agree to ~1e-6 relative and are held at 1e-5.
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu.grid import grid_from_arrays as j_grid_from_arrays
from soc_tpu.pipeline import mabu as jmabu
from soc_tpu.render import mapping as jmap
from soc_tpu.solve import equilibrium as jeq

from soc_tpu_torch import convert
from soc_tpu_torch.pipeline import mabu as tmabu
from soc_tpu_torch.render import mapping as tmap
from soc_tpu_torch.solve import equilibrium as teq

sys.path.insert(0, "tests")
from test_a2e import random_solver  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 8
NF = 10


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(21)
    dens = rng.uniform(0.2, 3.0, N ** 3).astype(np.float32)
    dens[:5] = 0.0                       # empty cells take T = 10
    jg = j_grid_from_arrays(N, N, N, [N ** 3], [dens])
    tg = convert.grid_from_numpy(jg.nx, jg.ny, jg.nz, np.asarray(jg.dens),
                                 np.asarray(jg.lcells), np.asarray(jg.off),
                                 np.asarray(jg.par), CPU)
    freq = np.geomspace(3e11, 3e15, NF)
    abs_gl = np.geomspace(1e-3, 1.0, NF).astype(np.float32)
    return dict(jg=jg, tg=tg, freq=freq, abs_gl=abs_gl, rng=rng)


def test_temperature_and_emission(model):
    jg, tg, freq, abs_gl = (model[k] for k in ("jg", "tg", "freq", "abs_gl"))
    gl_cm = 0.01 * 3.08567758e18
    jt = jeq.build_temperature_table(freq, abs_gl, 0.01)
    tt = teq.build_temperature_table(freq, abs_gl, 0.01, CPU)
    np.testing.assert_array_equal(tt.ttt.numpy(), np.asarray(jt.ttt))
    assert (tt.emin, tt.ke, tt.ne) == (jt.emin, jt.ke, jt.ne)
    rng = np.random.default_rng(3)
    # absorbed energies spanning the table (TABS = Ein * GL pc * dens /
    # (PLANCK * FACTOR))
    span = np.log10(jt.ke) * (jt.ne - 1)
    ein = jt.emin * 10.0 ** rng.uniform(-0.5, span + 0.5, N ** 3)
    tabs = (ein * gl_cm / (6.62606957e-27 * 1e20)
            * np.asarray(jg.dens)).astype(np.float32)
    jT = np.asarray(jeq.solve_temperature(jg, jt, jnp.asarray(tabs), gl_cm))
    tT = teq.solve_temperature(tg, tt, torch.as_tensor(tabs), gl_cm)
    np.testing.assert_allclose(tT.numpy(), jT, rtol=1e-5)
    assert (tT.numpy()[:5] == 10.0).all()
    assert np.ptp(jT) > 10.0                  # a real spread of T
    je = np.asarray(jeq.emission(freq, abs_gl, jnp.asarray(jT), gl_cm))
    te = teq.emission(freq, abs_gl, torch.tensor(jT), gl_cm).numpy()
    # XLA rewrites a / b / c as a / (b * c), which overflows to 0 in the
    # coldest cells' highest channels where torch keeps ~1e-20 of the peak
    np.testing.assert_allclose(te, je, rtol=1e-5,
                               atol=1e-12 * np.abs(je).max())
    # the conversion path for a table soc_tpu built
    t2 = convert.temperature_table_from_numpy(np.asarray(jt.ttt), jt.emin,
                                              jt.ke, jt.ne, CPU)
    np.testing.assert_allclose(
        teq.solve_temperature(tg, t2, torch.as_tensor(tabs), gl_cm).numpy(),
        jT, rtol=1e-5)


@pytest.mark.parametrize("theta,phi,npix,dx", [
    (0.0, 0.0, (8, 8), 1.0), (37.0, 21.0, (12, 10), 0.9),
    (90.0, 135.0, (6, 9), 1.5)])
def test_render_ortho(model, theta, phi, npix, dx):
    jg, tg = model["jg"], model["tg"]
    rng = np.random.default_rng(int(theta) + 1)
    emit = rng.random((N ** 3, NF)).astype(np.float32) * 1e3
    ext = rng.uniform(0.01, 0.8, NF).astype(np.float32)
    odir, ra, de = jmap.observer_basis(np.radians(theta), np.radians(phi))
    todir, tra, tde = tmap.observer_basis(np.radians(theta), np.radians(phi))
    np.testing.assert_array_equal(todir, odir)
    centre = (0.5 * N, 0.5 * N, 0.5 * N)
    jp, jt, jc = jmap.render_ortho(jg, jnp.asarray(emit), jnp.asarray(ext),
                                   jnp.asarray(odir), jnp.asarray(ra),
                                   jnp.asarray(de), centre, dx, npix)
    tp, tt, tc = tmap.render_ortho(tg, torch.as_tensor(emit),
                                   torch.as_tensor(ext), odir, ra, de,
                                   centre, dx, npix)
    assert tp.shape == (NF,) + tuple(npix[::-1])
    for a, b in ((tp, jp), (tt, jt), (tc, jc)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
    assert np.asarray(jc).max() > 0


def test_solve_emission_multi(monkeypatch):
    """One gset dust and one eqdust: absorptions split by cross section,
    each solved, summed."""
    monkeypatch.setenv("SOC_TPU_A2E", "xla")
    solver = random_solver(ne=16, nfreq=8, nsize=2, seed=4)
    freq = np.asarray(solver.freq, np.float64)
    rng = np.random.default_rng(5)
    kabs_eq = rng.uniform(0.5, 2.0, 8) * 1e-22
    absorbed = (rng.random((200, 8)) * 1e-3).astype(np.float32)
    jc = [jmabu.DustComponent("g", "gset", solver.k_abs, solver=solver),
          jmabu.DustComponent("e", "eqdust", kabs_eq, freq=freq)]
    tc = [tmabu.DustComponent("g", "gset", solver.k_abs, solver=solver),
          tmabu.DustComponent("e", "eqdust", kabs_eq, freq=freq)]
    ref = jmabu.solve_emission_multi(jc, absorbed)
    got = tmabu.solve_emission_multi(tc, absorbed, CPU)
    np.testing.assert_allclose(got, ref, rtol=2e-5,
                               atol=1e-6 * np.abs(ref).max())
