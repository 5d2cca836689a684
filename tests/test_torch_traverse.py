"""The traversal's PAR-array form (index_global, index_update, get_step,
march_path_lengths) against soc_tpu's, on a regular grid and on the
octree of tests/test_traverse.py (a 4^3 root with one cell refined once
and one twice), with random and axis-aligned rays as that file builds
them.

Cell indices and levels must be equal. Positions and steps are held to
1.2e-7 relative, 1 float32 ulp, tests/test_torch_core.py's bound (both
packages compute them in float32 in the same order). A path length is a
float32 sum of such steps, which soc_tpu's march adds inside one XLA
loop body: it is held to 1 ulp a step it can take, 3 N 2^(levels-1) on
an N^3 root (max_steps: every cell of the finest level along all three
axes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_tpu.grid import encode_link_np, grid_from_arrays as j_from_arrays
from soc_tpu.grid import uniform_grid as j_uniform_grid
from soc_tpu.ops import traverse as jtr

from soc_tpu_torch.grid import grid_from_arrays, uniform_grid
from soc_tpu_torch.ops import traverse as ttr

CPU = torch.device("cpu")
ULP = 1.2e-7
jmarch = jax.jit(jtr.march_path_lengths, static_argnames="max_steps")


def octree_levels():
    """tests/test_traverse.py's octree: 4x4x4 root; root cell (1,1,1)
    refined one level; (2,2,2) two levels."""
    root = np.ones(64, np.float32)
    root[1 * 16 + 1 * 4 + 1] = encode_link_np([0])[0]
    root[2 * 16 + 2 * 4 + 2] = encode_link_np([8])[0]
    l1 = np.full(16, 2.0, np.float32)
    l1[11] = encode_link_np([0])[0]
    l2 = np.full(8, 4.0, np.float32)
    return [64, 16, 8], [root, l1, l2]


def grids(kind):
    if kind == "regular":
        return j_uniform_grid(8, 8, 8), uniform_grid(8, 8, 8, CPU)
    lcells, values = octree_levels()
    return (j_from_arrays(4, 4, 4, lcells, values),
            grid_from_arrays(4, 4, 4, lcells, values, CPU))


def rays(kind, n, edge):
    """Random rays (tests/test_traverse.py's octree draw: isotropic, no
    component below 1e-4) or rays along +x at 1e-4 off the axis."""
    rng = np.random.default_rng(7)
    if kind == "axis":
        d = np.tile(np.asarray([1.0, 1e-4, 1e-4]), (n, 1))
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32)
        ys = rng.uniform(0.1, edge - 0.1, (n, 2)).astype(np.float32)
        return np.concatenate([np.full((n, 1), 1e-3, np.float32), ys],
                              1), d
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.sin(theta) * np.cos(phi),
                  np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    d = np.where(np.abs(d) < 1e-4, 1e-4, d)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return rng.uniform(0.2, edge - 0.2, (n, 3)).astype(np.float32), d


def max_steps(grid):
    """The most cells a ray crosses: every cell of the finest level along
    all three axes."""
    return 3 * grid.nx * 2 ** (grid.levels - 1)


def same_cells(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=ULP, atol=0)


@pytest.mark.parametrize("grid", ["regular", "octree"])
def test_index_global_matches(grid):
    jg, tg = grids(grid)
    edge = tg.nx
    pos = np.random.default_rng(3).uniform(-0.5, edge + 0.5, (512, 3))
    pos = pos.astype(np.float32)
    jp, jl, ji = jtr.index_global(jg, jnp.asarray(pos))
    tp, tl, ti = ttr.index_global(tg, torch.as_tensor(pos))
    same_cells(tl, jl)
    same_cells(ti, ji)
    close(tp, jp)
    assert (ti < 0).any() and (ti >= 0).any()
    if grid == "octree":
        assert set(tl[ti >= 0].tolist()) == {0, 1, 2}


@pytest.mark.parametrize("grid", ["regular", "octree"])
@pytest.mark.parametrize("kind", ["random", "axis"])
def test_get_step_and_index_update_match(grid, kind):
    """get_step (boundary_step then index_update), compared after every
    step until every active lane has left; some lanes are held
    inactive."""
    jg, tg = grids(grid)
    pos, d = rays(kind, 256, tg.nx)
    jp, jl, ji = jtr.index_global(jg, jnp.asarray(pos))
    tp, tl, ti = ttr.index_global(tg, torch.as_tensor(pos))
    hold = np.arange(256) % 7 == 0
    jd, td = jnp.asarray(d), torch.as_tensor(d)
    for _ in range(max_steps(tg)):
        jact = (ji >= 0) & ~jnp.asarray(hold)
        tact = (ti >= 0) & ~torch.as_tensor(hold)
        jds, jp, jl, ji = jtr.get_step(jg, jp, jd, jl, ji, jact)
        tds, tp, tl, ti = ttr.get_step(tg, tp, td, tl, ti, tact)
        close(tds, jds)
        close(tp, jp)
        same_cells(tl, jl)
        same_cells(ti, ji)
    assert (ti[~torch.as_tensor(hold)] < 0).all()


@pytest.mark.parametrize("grid", ["regular", "octree"])
@pytest.mark.parametrize("kind", ["random", "axis"])
def test_march_path_lengths_matches(grid, kind):
    jg, tg = grids(grid)
    pos, d = rays(kind, 128, tg.nx)
    want = np.asarray(jmarch(jg, jnp.asarray(pos), jnp.asarray(d)))
    got = ttr.march_path_lengths(tg, torch.as_tensor(pos),
                                 torch.as_tensor(d))
    np.testing.assert_allclose(got.numpy(), want,
                               rtol=max_steps(tg) * ULP, atol=0)
    # the chord through the box, as tests/test_traverse.py checks it
    edge = float(tg.nx)
    t = np.where(d > 0, (edge - pos) / d, -pos / d).min(1)
    np.testing.assert_allclose(got.numpy(), t, rtol=0, atol=0.03)


@pytest.mark.parametrize("grid", ["regular", "octree"])
@pytest.mark.parametrize("kind", ["random", "axis"])
@pytest.mark.parametrize("cut", [None, 7])
def test_march_block_form_equals_step_form(grid, kind, cut):
    """march_path_lengths in blocks of 5 and of MARCH_BLOCK steps (a
    readback a block) against the step-by-step form (block=1): bit for
    bit, a ray that has left being masked in every step; with max_steps
    cut to 7 (not a multiple of either block) too. Each form holds to
    soc_tpu's march with the same max_steps at the bound above."""
    jg, tg = grids(grid)
    pos, d = rays(kind, 128, tg.nx)
    steps = max_steps(tg) if cut is None else cut
    tp, td = torch.as_tensor(pos), torch.as_tensor(d)
    step = ttr.march_path_lengths(tg, tp, td, max_steps=steps, block=1)
    want = np.asarray(jmarch(jg, jnp.asarray(pos), jnp.asarray(d),
                             max_steps=steps))
    for block in (5, ttr.MARCH_BLOCK):
        got = ttr.march_path_lengths(tg, tp, td, max_steps=steps,
                                     block=block)
        np.testing.assert_array_equal(got.numpy(), step.numpy())
    np.testing.assert_allclose(step.numpy(), want,
                               rtol=max_steps(tg) * ULP, atol=0)
    assert "blocks of 32" in ttr.march_form("cpu")
    assert "step by step" in ttr.march_form("cpu", 1)
