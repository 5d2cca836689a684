"""Octree grid representation, as torch tensors.

Same flat layout as soc_tpu.grid: one float32 density array ``dens[CELLS]``
concatenating all hierarchy levels; a leaf stores density > 0, a refined
cell stores the negated bit pattern of the int32 index of its first child
on the next level. ``off[level]`` is the offset of a level inside ``dens``;
``par`` maps each non-root cell to its parent's level-local index. The
shape metadata (nx, ny, nz, levels, cells) are Python ints.
"""

from dataclasses import dataclass

import numpy as np
import torch


def decode_link_np(dens_values):
    """Bit-cast negated float32 link values back to int32 child indices."""
    return (-np.asarray(dens_values, np.float32)).view(np.int32)


def encode_link_np(child_index):
    """Int32 first-child indices -> negated float32 link values."""
    return -np.asarray(child_index, np.int32).view(np.float32)


def decode_link(dens_val):
    """Torch twin of decode_link_np (float32 tensor -> int32 tensor)."""
    return (-dens_val).view(torch.int32)


@dataclass(frozen=True)
class Grid:
    """Device-resident octree grid."""

    dens: torch.Tensor     # [CELLS] float32; >0 leaf density, <=0 child link
    lcells: torch.Tensor   # [LEVELS] int32 cells per level
    off: torch.Tensor      # [LEVELS] int32 first cell of each level
    par: torch.Tensor      # [CELLS] int32 parent level-local index (-1 root)
    nx: int
    ny: int
    nz: int
    levels: int
    cells: int

    @property
    def root_cells(self):
        return self.nx * self.ny * self.nz

    @property
    def area(self):
        """Total surface area of the model volume [GL^2]."""
        return 2.0 * (self.nx * self.ny + self.nx * self.nz + self.ny * self.nz)

    @property
    def device(self):
        return self.dens.device


def build_parents(dens, lcells, off, nx, ny, nz):
    """Host-side construction of the parent-link array (NumPy)."""
    levels = len(lcells)
    cells = int(np.sum(lcells))
    par = np.full(cells, -1, np.int32)
    for level in range(levels - 1):
        lo, hi = off[level], off[level] + lcells[level]
        vals = dens[lo:hi]
        parents = np.nonzero(vals <= 0.0)[0]          # level-local parent ids
        if len(parents) == 0:
            continue
        first_child = decode_link_np(vals[parents])   # level-local on level+1
        for i in range(8):
            par[off[level + 1] + first_child + i] = parents
    return par


def grid_from_numpy(nx, ny, nz, dens, lcells, off, par, device):
    """Grid from host arrays, placed on ``device``."""
    return Grid(
        dens=torch.tensor(np.asarray(dens, np.float32), device=device),
        lcells=torch.tensor(np.asarray(lcells, np.int32), device=device),
        off=torch.tensor(np.asarray(off, np.int32), device=device),
        par=torch.tensor(np.asarray(par, np.int32), device=device),
        nx=int(nx), ny=int(ny), nz=int(nz),
        levels=int(len(lcells)), cells=int(np.sum(lcells)))


def grid_from_arrays(nx, ny, nz, lcells, level_values, device):
    """Assemble a Grid from per-level float32 value arrays."""
    lcells = np.asarray(lcells, np.int32)
    off = np.zeros(len(lcells), np.int32)
    off[1:] = np.cumsum(lcells)[:-1]
    dens = np.concatenate([np.asarray(v, np.float32) for v in level_values])
    par = build_parents(dens, lcells, off, nx, ny, nz)
    return grid_from_numpy(nx, ny, nz, dens, lcells, off, par, device)


def uniform_grid(nx, ny, nz, device, density=1.0):
    """Single-level test helper: a uniform-density regular grid."""
    vals = np.full(nx * ny * nz, density, np.float32)
    return grid_from_arrays(nx, ny, nz, [nx * ny * nz], [vals], device)
