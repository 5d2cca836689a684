"""Faults planted under the slab cell's timed path (benchmark/tests/
faults.py's pattern): each plant(name) patches the program in this
process and returns the function that takes the patch out again. The
half of faults.py's faults that fits the slab (`half`) is planted from
there."""

import numpy as np
import torch

from benchmark.tests import faults


def _links(grid):
    """(off, level of every cell, the refined cells, the index of each one's
    first child) of the program's hierarchy."""
    dens = grid.dens.cpu()
    off = grid.off.cpu().numpy().astype(np.int64)
    lvl = np.searchsorted(off, np.arange(grid.cells), side="right") - 1
    links = np.nonzero(dens.numpy() <= 0)[0]
    first = (-dens[links]).view(torch.int32).numpy().astype(np.int64) \
        + off[lvl[links] + 1]
    return off, lvl, links, first


def _sibling_order(grid):
    """[CELLS] int64: every refined parent's children in reverse order
    (slot k takes slot 7 - k's cell), every other cell itself."""
    _, _, _, first = _links(grid)
    order = np.arange(grid.cells)
    for k in range(8):
        order[first + k] = first + 7 - k
    return order


def _shift_order(grid):
    """[CELLS] int64: every cell takes the cell of its level one root cell
    before it in x (cyclically), so that a tally indexed by it moves each
    deposit one root cell along +x, at the same level and depth."""
    off, lvl, links, first = _links(grid)
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    xyz = np.zeros((grid.cells, 3), np.int64)
    r = np.arange(off[1] if len(off) > 1 else grid.cells)
    xyz[r] = np.stack([r % nx, (r // nx) % ny, r // (nx * ny)], 1)
    sid = np.arange(8)
    bits = np.stack([sid % 2, (sid // 2) % 2, sid // 4], -1)
    for k in range(len(off) - 1):                   # parents before children
        m = lvl[links] == k
        xyz[first[m][:, None] + sid] = 2 * xyz[links[m]][:, None, :] + bits
    order = np.arange(grid.cells)
    for k in range(len(off)):
        idx = np.nonzero(lvl == k)[0]
        s = 1 << k
        have = (xyz[idx, 0] * ny * s + xyz[idx, 1]) * nz * s + xyz[idx, 2]
        want = (((xyz[idx, 0] - s) % (nx * s)) * ny * s + xyz[idx, 1]) \
            * nz * s + xyz[idx, 2]
        srt = np.argsort(have)
        pos = srt[np.searchsorted(have, want, sorter=srt)]
        assert (have[pos] == want).all()
        order[idx] = idx[pos]
    return order


def children_permuted():
    """The star's deposits permuted among the 8 children of every refined
    parent, as a descent that picks the mirrored octant would put them."""
    from soc_tpu_torch.pipeline import driver

    def make(orig):
        def f(grid, medium, kind, phase, params, counts, sel, tabs, intf,
              *a, **kw):
            t0 = tabs.clone()
            i0 = intf.clone() if torch.is_tensor(intf) else None
            tabs, intf, stats = orig(grid, medium, kind, phase, params,
                                     counts, sel, tabs, intf, *a, **kw)
            if phase != "ps":
                return tabs, intf, stats
            order = _sibling_order(grid)
            idx = torch.as_tensor(order, device=tabs.device)
            tabs = t0 + (tabs - t0)[idx]
            if i0 is not None and intf.shape[0] == grid.cells:
                intf.copy_(i0 + (intf - i0)[idx])
            stats = dict(stats, tabs=stats["tabs"][order])
            return tabs, intf, stats
        return f
    return faults._patch(driver, "_source_pass", make)


def shifted_x():
    """The deposits of the star's pass and of the cell pass moved one root
    cell along x, each at its own level and depth, as a descent with an
    off-by-one root index would put them."""
    from soc_tpu_torch.pipeline import driver

    def make_ps(orig):
        def f(grid, medium, kind, phase, params, counts, sel, tabs, intf,
              *a, **kw):
            t0 = tabs.clone()
            tabs, intf, stats = orig(grid, medium, kind, phase, params,
                                     counts, sel, tabs, intf, *a, **kw)
            if phase != "ps":
                return tabs, intf, stats
            order = _shift_order(grid)
            idx = torch.as_tensor(order, device=tabs.device)
            tabs = t0 + (tabs - t0)[idx]
            return tabs, intf, dict(stats, tabs=stats["tabs"][order])
        return f

    def make_cell(orig):
        def f(grid, medium, cfg, emitted, tabs, intf, *a, **kw):
            t0 = tabs.clone()
            tabs, intf, esc, xab, stats = orig(grid, medium, cfg, emitted,
                                               tabs, intf, *a, **kw)
            order = _shift_order(grid)
            tabs = t0 + (tabs - t0)[torch.as_tensor(order,
                                                    device=tabs.device)]
            if xab is not None:
                xab = xab[order]
            return tabs, intf, esc, xab, stats
        return f
    undo = [faults._patch(driver, "_source_pass", make_ps),
            faults._patch(driver, "simulate_cell_emission", make_cell)]
    return lambda: [u() for u in reversed(undo)]


def self_to_tabs():
    """ALI's split undone: the cell pass's deposits in the emitting cell
    itself go to the absorbed tally (TABS) with the others, and the
    self-absorbed tally (XAB) is left empty."""
    from soc_tpu_torch.pipeline import driver

    def make(orig):
        def f(grid, medium, cfg, emitted, tabs, intf, *a, **kw):
            tabs, intf, esc, xab, stats = orig(grid, medium, cfg, emitted,
                                               tabs, intf, *a, **kw)
            if xab is not None:
                tabs = tabs + torch.as_tensor(xab, device=tabs.device)
                xab = np.zeros_like(xab)
            return tabs, intf, esc, xab, stats
        return f
    return faults._patch(driver, "simulate_cell_emission", make)


def cell_unchanged():
    """A cell pass that returns the tallies as they were."""
    from soc_tpu_torch.pipeline import driver

    def make(orig):
        def f(grid, medium, cfg, emitted, tabs, intf, *a, **kw):
            keep_t = tabs.clone()
            keep_i = intf.clone() if torch.is_tensor(intf) else None
            _, intf2, esc, xab, stats = orig(grid, medium, cfg, emitted,
                                             tabs, intf, *a, **kw)
            if keep_i is not None:
                intf2.copy_(keep_i)
            return keep_t, intf2, esc, xab, stats
        return f
    return faults._patch(driver, "simulate_cell_emission", make)


def level_temperature():
    """The temperatures of one level (the third) altered by 1% where they
    are solved."""
    from soc_tpu_torch.solve import equilibrium

    def make(orig):
        def f(grid, *a, **kw):
            t = orig(grid, *a, **kw)
            off = [int(v) for v in grid.off.cpu()] + [grid.cells]
            scale = torch.ones_like(t)
            scale[off[2]:off[3]] = 1.01
            return t * scale
        return f
    return faults._patch(equilibrium, "solve_temperature", make)


def plant(name):
    if name == "none":
        return lambda: None
    if name == "half":
        return faults.half()
    return globals()[name]()
