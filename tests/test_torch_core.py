"""soc_tpu_torch against soc_tpu: RNG, grid, cloud files and traversal.

The same NumPy inputs, made from a seed, go through the JAX function and
its port. Integer results and the RNG bits must be equal; positions must
agree to float32 rounding (both packages compute them in float32 with the
same operation order, so equality is expected and 1 ulp is allowed).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from soc_tpu import grid as jgrid
from soc_tpu import rng as jrng
from soc_tpu.grid import encode_link_np
from soc_tpu.io import cloud as jcloud
from soc_tpu.ops import traverse as jtr

from soc_tpu_torch import grid as tgrid
from soc_tpu_torch import rng as trng
from soc_tpu_torch.io import cloud as tcloud
from soc_tpu_torch.ops import traverse as ttr

torch.set_num_threads(2)
CPU = torch.device("cpu")
SEED = 2147495993
EDGE = np.asarray([0, 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64)


def _words(rng, n):
    w = rng.integers(0, 2**32, n, dtype=np.uint64)
    w[: len(EDGE)] = EDGE
    return w.astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_bit_exact(rounds):
    rng = np.random.default_rng(1)
    hi, stream, ctr = (_words(rng, 3000) for _ in range(3))
    jx0, jx1 = jrng.threefry2x32(np.uint32(SEED), jnp.asarray(hi),
                                 jnp.asarray(stream), jnp.asarray(ctr),
                                 rounds=rounds)
    tx0, tx1 = trng.threefry2x32(SEED, _t(hi), _t(stream), _t(ctr),
                                 rounds=rounds)
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0, np.int64))
    np.testing.assert_array_equal(tx1.numpy(), np.asarray(jx1, np.int64))


def test_uniform_draws_bit_exact():
    rng = np.random.default_rng(2)
    hi, stream, ctr = (_words(rng, 3000) for _ in range(3))
    jh, js, jc = jnp.asarray(hi), jnp.asarray(stream), jnp.asarray(ctr)
    th, ts, tc = _t(hi), _t(stream), _t(ctr)
    pairs = [
        (jrng.uniform1(SEED, js, jc, jh), (trng.uniform1(SEED, ts, tc, th),)),
        (jrng.uniform2(SEED, js, jc, jh), trng.uniform2(SEED, ts, tc, th)),
        (jrng.uniform4(SEED, js, jc, jh), trng.uniform4(SEED, ts, tc, th)),
        (jrng.step_uniforms(SEED, js, jc, jh),
         trng.step_uniforms(SEED, ts, tc, th)),
    ]
    for jout, tout in pairs:
        jout = jout if isinstance(jout, tuple) else (jout,)
        assert len(jout) == len(tout)
        for a, b in zip(jout, tout):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def three_level_values(n=4, seed=3):
    """Per-level values of a 3-level octree: some root cells refined, some
    of their children refined again; leaf densities from the seed."""
    rng = np.random.default_rng(seed)
    root = rng.uniform(0.5, 2.0, n ** 3).astype(np.float32)
    ref0 = np.sort(rng.choice(n ** 3, 6, replace=False))
    root[ref0] = encode_link_np(8 * np.arange(len(ref0)))
    l1 = rng.uniform(0.5, 2.0, 8 * len(ref0)).astype(np.float32)
    ref1 = np.sort(rng.choice(len(l1), 5, replace=False))
    l1[ref1] = encode_link_np(8 * np.arange(len(ref1)))
    l2 = rng.uniform(0.5, 2.0, 8 * len(ref1)).astype(np.float32)
    return n, [root, l1, l2]


@pytest.fixture
def octree_file(tmp_path):
    n, vals = three_level_values()
    path = tmp_path / "oct.cloud"
    tcloud.write_hierarchy(path, n, n, n, [len(v) for v in vals], vals)
    return path


def test_link_codecs_and_parents():
    """Link encoding (NumPy and torch) and the parent array, bit for bit."""
    n, vals = three_level_values()
    idx = np.arange(0, 2**31 - 1, 2**20, dtype=np.int64)
    enc = tgrid.encode_link_np(idx)
    np.testing.assert_array_equal(enc.view(np.int32),
                                  jgrid.encode_link_np(idx).view(np.int32))
    np.testing.assert_array_equal(tgrid.decode_link_np(enc), idx)
    np.testing.assert_array_equal(
        tgrid.decode_link(torch.as_tensor(enc)).numpy(), idx)
    lcells = np.asarray([len(v) for v in vals], np.int32)
    off = np.concatenate([[0], np.cumsum(lcells)[:-1]]).astype(np.int32)
    dens = np.concatenate(vals)
    np.testing.assert_array_equal(
        tgrid.build_parents(dens, lcells, off, n, n, n),
        jgrid.build_parents(dens, lcells, off, n, n, n))


def _grids(path, kdensity=1.0, max_levels=999):
    jg = jcloud.read_cloud(str(path), kdensity, max_levels)
    tg = tcloud.read_cloud(str(path), CPU, kdensity, max_levels)
    return jg, tg


@pytest.mark.parametrize("kdensity,max_levels", [(1.0, 999), (3.0e4, 2)])
def test_read_cloud_equal_arrays(octree_file, kdensity, max_levels):
    jg, tg = _grids(octree_file, kdensity, max_levels)
    for f in ("dens", "lcells", "off", "par"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    assert (tg.nx, tg.ny, tg.nz, tg.levels, tg.cells) == \
        (jg.nx, jg.ny, jg.nz, jg.levels, jg.cells)


def test_hierarchy_file_roundtrip(octree_file, tmp_path):
    jg, tg = _grids(octree_file)
    vals = np.random.default_rng(4).random(tg.cells).astype(np.float32)
    tcloud.write_cell_field(tmp_path / "t.T", tg, torch.as_tensor(vals))
    jcloud.write_cell_field(tmp_path / "j.T", jg, vals)
    assert (tmp_path / "t.T").read_bytes() == (tmp_path / "j.T").read_bytes()
    hdr = tcloud.read_hierarchy(tmp_path / "t.T")
    ref = jcloud.read_hierarchy(tmp_path / "j.T")
    assert hdr[:3] == ref[:3]
    for a, b in zip(hdr[4], ref[4]):
        np.testing.assert_array_equal(a, b)


def _pos_dir(n, count, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.01, n - 0.01, (count, 3)).astype(np.float32)
    d = rng.normal(size=(count, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.abs(d) < 1e-4, 1e-4, d).astype(np.float32)
    return pos, d


def _eq_pos(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1.2e-7,
                               atol=0)


def _eq_int(a, b):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("descend", [True, False])
def test_traverse_steps_match(octree_file, descend):
    """index_global_stack, then 40 boundary steps of index_update_stack /
    failed_step_nudge / descend_one, compared after every step."""
    jg, tg = _grids(octree_file)
    pos0, d = _pos_dir(jg.nx, 2000, 5)
    jp, jl, ji, ja = jtr.index_global_stack(jg, jnp.asarray(pos0))
    tp, tl, ti, ta = ttr.index_global_stack(tg, torch.as_tensor(pos0))
    _eq_pos(tp, jp)
    _eq_int(tl, jl)
    _eq_int(ti, ji)
    _eq_int(ta, ja)
    jd, td = jnp.asarray(d), torch.as_tensor(d)
    for _ in range(40):
        jact, tact = ji >= 0, ti >= 0
        jds, jnp_ = jtr.boundary_step(jp, jd)
        tds, tnp_ = ttr.boundary_step(tp, td)
        _eq_pos(tds, jds)
        jpx = jnp.where(jact[:, None], jnp_, jp)
        tpx = torch.where(tact[:, None], tnp_, tp)
        jr = jtr.index_update_stack(jg, jpx, jl, ji, ja, jact,
                                    descend=descend)
        tr = ttr.index_update_stack(tg, tpx, tl, ti, ta, tact,
                                    descend=descend)
        _eq_pos(tr[0], jr[0])
        for a, b in zip(tr[1:], jr[1:]):
            _eq_int(a, b)
        jfail = jact & (jr[1] == jl) & (jr[2] == ji)
        tfail = tact & (tr[1] == tl) & (tr[2] == ti)
        _eq_int(tfail, jfail)
        jp = jtr.failed_step_nudge(jr[0], jd, jfail)
        tp = ttr.failed_step_nudge(tr[0], td, tfail)
        _eq_pos(tp, jp)
        jl, ji, ja = jr[1], jr[2], jr[3]
        tl, ti, ta = tr[1], tr[2], tr[3]
        if not descend:
            gi = np.clip(np.asarray(jg.off)[np.clip(np.asarray(jl), 0, 2)]
                         + np.maximum(np.asarray(ji), 0), 0, jg.cells - 1)
            dv = np.asarray(jg.dens)[gi]
            link = (np.asarray(ji) >= 0) & (dv <= 0.0)
            jp, jl, ji, ja = jtr.descend_one(jg, jp, jl, ji, ja,
                                             jnp.asarray(dv),
                                             jnp.asarray(link))
            tp, tl, ti, ta = ttr.descend_one(tg, tp, tl, ti, ta,
                                             torch.as_tensor(dv),
                                             torch.as_tensor(link))
            _eq_pos(tp, jp)
            for a, b in ((tl, jl), (ti, ji), (ta, ja)):
                _eq_int(a, b)
    # the walk must have visited every level and left the grid somewhere
    assert int((ti < 0).sum()) > 0


def test_get_step_stack_and_root_pos(octree_file):
    jg, tg = _grids(octree_file)
    pos0, d = _pos_dir(jg.nx, 2000, 6)
    jst = jtr.index_global_stack(jg, jnp.asarray(pos0))
    tst = ttr.index_global_stack(tg, torch.as_tensor(pos0))
    assert set(np.unique(np.asarray(jst[1]))) == {0, 1, 2}
    np.testing.assert_allclose(
        ttr.root_pos(tg, tst[0], tst[1], tst[2]).numpy(), pos0,
        rtol=0, atol=2e-6)
    _eq_pos(ttr.root_pos(tg, tst[0], tst[1], tst[2]),
            jtr.root_pos(jg, jst[0], jst[1], jst[2]))
    jd, td = jnp.asarray(d), torch.as_tensor(d)
    jact = jst[2] >= 0
    tact = tst[2] >= 0
    jr = jtr.get_step_stack(jg, jst[0], jd, jst[1], jst[2], jst[3], jact)
    tr = ttr.get_step_stack(tg, tst[0], td, tst[1], tst[2], tst[3], tact)
    _eq_pos(tr[0], jr[0])
    _eq_pos(tr[1], jr[1])
    for a, b in zip(tr[2:], jr[2:]):
        _eq_int(a, b)


def test_failed_step_nudge_large_coordinates():
    """The ulp-scaled nudge moves positions beyond the PEPS regime exactly
    as soc_tpu does (float32 arithmetic)."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(1000.0, 5000.0, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    fail = rng.random(500) < 0.5
    j = jtr.failed_step_nudge(jnp.asarray(pos), jnp.asarray(d),
                              jnp.asarray(fail))
    t = ttr.failed_step_nudge(torch.as_tensor(pos), torch.as_tensor(d),
                              torch.as_tensor(fail))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jds, jp = jtr.boundary_step(jnp.asarray(pos), jnp.asarray(d))
    tds, tp = ttr.boundary_step(torch.as_tensor(pos), torch.as_tensor(d))
    np.testing.assert_array_equal(tds.numpy(), np.asarray(jds))
