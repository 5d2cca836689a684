"""Reference-compatible codecs for hierarchical cell files.

File format (the reference's ASOC_aux.py:716-803): int32 header
[NX, NY, NZ, LEVELS, CELLS], then per level an int32 cell count followed by
float32 values. The same container stores densities (cloud) and dust
temperatures (*.T); parent cells hold negated bit-cast child links in the
cloud file.
"""

import numpy as np
import torch

from ..grid import decode_link_np, grid_from_arrays


def read_hierarchy(path):
    """Read a hierarchical file -> (nx, ny, nz, lcells, [level values])."""
    with open(path, "rb") as fp:
        nx, ny, nz, levels, cells = np.fromfile(fp, np.int32, 5)
        lcells = np.zeros(levels, np.int32)
        values = []
        for lvl in range(levels):
            n = int(np.fromfile(fp, np.int32, 1)[0])
            lcells[lvl] = n
            values.append(np.fromfile(fp, np.float32, n))
    if int(np.sum(lcells)) != cells:
        raise ValueError("corrupt hierarchy file: %s" % path)
    return int(nx), int(ny), int(nz), lcells, values


def write_hierarchy(path, nx, ny, nz, lcells, values):
    """Write a hierarchical file from per-level float32 arrays."""
    lcells = np.asarray(lcells, np.int32)
    with open(path, "wb") as fp:
        np.asarray([nx, ny, nz, len(lcells), int(np.sum(lcells))],
                   np.int32).tofile(fp)
        for lvl, vals in enumerate(values):
            np.asarray([lcells[lvl]], np.int32).tofile(fp)
            np.asarray(vals, np.float32).tofile(fp)


def cut_levels(lcells, values, maxlevel):
    """Truncate a hierarchy at maxlevel (0-based), replacing links with the
    average of their (already averaged) children, bottom-up."""
    levels = len(lcells)
    values = [np.asarray(v, np.float32).copy() for v in values]
    for lvl in range(levels - 2, maxlevel - 1, -1):
        vals = values[lvl]
        links = np.nonzero(vals <= 0.0)[0]
        if len(links) == 0:
            continue
        child = decode_link_np(vals[links])
        below = values[lvl + 1]
        avg = below[(child[:, None] + np.arange(8)[None, :])].mean(axis=1)
        vals[links] = avg.astype(np.float32)
    return (np.asarray(lcells[: maxlevel + 1], np.int32),
            values[: maxlevel + 1])


def read_cloud(path, device, kdensity=1.0, max_levels=999):
    """Read a cloud (density) file into a Grid on ``device``.

    Densities are scaled by ``kdensity`` (ini keyword ``density``); link
    values (<= 0) are left untouched."""
    nx, ny, nz, lcells, values = read_hierarchy(path)
    if len(lcells) > max_levels:
        lcells, values = cut_levels(lcells, values, max_levels - 1)
    if kdensity != 1.0:
        scaled = []
        for vals in values:
            v = vals.copy()
            leaf = v > 0.0
            v[leaf] *= np.float32(kdensity)
            scaled.append(v)
        values = scaled
    return grid_from_arrays(nx, ny, nz, lcells, values, device)


def write_cell_field(path, grid, values):
    """Write per-cell values (e.g. temperature) in the cloud container."""
    lcells = grid.lcells.cpu().numpy()
    off = grid.off.cpu().numpy()
    if isinstance(values, torch.Tensor):
        values = values.cpu().numpy()
    values = np.asarray(values, np.float32)
    per_level = [values[off[l]: off[l] + lcells[l]] for l in range(grid.levels)]
    write_hierarchy(path, grid.nx, grid.ny, grid.nz, lcells, per_level)
