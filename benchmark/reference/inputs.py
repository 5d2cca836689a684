"""The model as the reference reads it: the hierarchy file, the dust, the
scattering table and the background, from the files the benchmark wrote."""

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..frozen.constants import FACTOR, PARSEC, PLANCK
from ..frozen.dust_io import read_simple_dust
from ..frozen.grain_model import gset_effective_optics, read_gset_dust


def read_hierarchy(path):
    """(nx, ny, nz, [level values]) of a hierarchy file."""
    with open(path, "rb") as fp:
        nx, ny, nz, levels, cells = (int(v) for v in
                                     np.fromfile(fp, np.int32, 5))
        values = []
        for _ in range(levels):
            n = int(np.fromfile(fp, np.int32, 1)[0])
            values.append(np.fromfile(fp, np.float32, n))
    if sum(len(v) for v in values) != cells:
        raise ValueError("corrupt hierarchy file: %s" % path)
    return nx, ny, nz, values


@dataclass
class Cloud:
    """A hierarchy as flat host arrays over every cell of every level.

    dens [CELLS] float64 (0 on parent cells), child [CELLS] the global
    index of the first of a parent's 8 children (-1 on leaves), level
    [CELLS], root [CELLS] the root cell each cell lies in."""

    nx: int
    ny: int
    nz: int
    dens: np.ndarray
    child: np.ndarray
    level: np.ndarray
    root: np.ndarray

    @property
    def cells(self):
        return len(self.dens)

    @property
    def levels(self):
        return int(self.level.max()) + 1

    def depth(self):
        """[CELLS] each cell's root cell's distance to the nearest face, in
        root cells (0 on the surface)."""
        r = self.root
        ix, iy, iz = r % self.nx, (r // self.nx) % self.ny, \
            r // (self.nx * self.ny)
        return np.minimum.reduce([ix, self.nx - 1 - ix, iy,
                                  self.ny - 1 - iy, iz, self.nz - 1 - iz])


def load_cloud(path, kdensity):
    nx, ny, nz, values = read_hierarchy(path)
    off = np.cumsum([0] + [len(v) for v in values])
    cells = int(off[-1])
    dens = np.zeros(cells)
    child = np.full(cells, -1, np.int64)
    level = np.zeros(cells, np.int64)
    root = np.zeros(cells, np.int64)
    root[:off[1]] = np.arange(off[1])
    for lvl, vals in enumerate(values):
        a, b = off[lvl], off[lvl + 1]
        level[a:b] = lvl
        leaf = vals > 0
        dens[a:b] = np.where(leaf, vals.astype(np.float64) * kdensity, 0.0)
        links = np.nonzero(~leaf)[0]
        if len(links):
            # a parent holds the negated bit pattern of its first child's
            # index on the next level
            first = (-vals[links]).view(np.int32).astype(np.int64)
            child[a + links] = off[lvl + 1] + first
            for k in range(8):
                root[off[lvl + 1] + first + k] = root[a + links]
    return Cloud(nx, ny, nz, dens, child, level, root)


def file_rounded(x):
    """Values as the simple-dust text format stores them (%12.5e)."""
    return np.asarray([float("%12.5e" % v) for v in np.asarray(x)])


@dataclass
class Optics:
    freq: np.ndarray        # [NF] Hz
    abs_gl: np.ndarray      # [NF] optical depth per unit density per GL
    sca_gl: np.ndarray
    csc: np.ndarray         # [NF, BINS] inverse CDF of cos(theta)


def load_optics(workdir, ini):
    """The transport's optics: the equilibrium dust file, or for a GSET
    dust its size-summed optics on the dust's own frequency grid, as the
    simple-dust text format stores them; the scattering table."""
    path = os.path.join(workdir, ini["optical"])
    gl = float(ini["gridlength"])
    with open(path) as fp:
        kind = fp.readline().split()[0]
    if kind == "eqdust":
        opt = read_simple_dust(path, gl)
        freq, abs_gl, sca_gl = opt.freq, opt.abs_gl, opt.sca_gl
    else:
        gset = read_gset_dust(path)
        opt = gset_effective_optics(gset, gset.qfreq, gl)
        coeff = opt.grain_density * np.pi * opt.grain_size ** 2 * gl * PARSEC
        freq = file_rounded(opt.freq)
        abs_gl = file_rounded(opt.abs_gl / coeff) * coeff
        sca_gl = file_rounded(opt.sca_gl / coeff) * coeff
    dsc_name, bins = ini["dsc"]
    raw = np.fromfile(os.path.join(workdir, dsc_name), np.float32)
    nf, bins = len(freq), int(bins)
    csc = raw[nf * bins:2 * nf * bins].reshape(nf, bins)
    return Optics(np.asarray(freq, np.float64),
                  np.asarray(abs_gl, np.float64),
                  np.asarray(sca_gl, np.float64),
                  np.asarray(csc, np.float64))


def background_injected(workdir, ini, freq, area):
    """[NF] background photons entering the model a channel (FACTOR
    units, the cell face as the unit of area): pi I_nu / (h nu) times the
    surface area."""
    ibg = np.fromfile(os.path.join(workdir, ini["background"]), np.float32,
                      len(freq)).astype(np.float64)
    return area * np.pi * ibg / (PLANCK * freq)


def raw_tally(cloud, absorbed, gl_pc):
    """The absorbed.data payload [CELLS, NF] back to the photons absorbed
    in each cell: times DENS / (8^level FACTOR / (GL PARSEC)); parent
    rows 0."""
    coeff = (8.0 ** cloud.level) * (FACTOR / (gl_pc * PARSEC))
    scale = np.where(cloud.dens > 0, cloud.dens / coeff, 0.0)
    out = np.asarray(absorbed, np.float64) * scale[:, None]
    out[cloud.dens <= 0] = 0.0
    return out


def device_tree(cloud, device):
    """The hierarchy's arrays on ``device`` for the marches."""
    return dict(n=torch.tensor([cloud.nx, cloud.ny, cloud.nz],
                               dtype=torch.float64, device=device),
                dims=(cloud.nx, cloud.ny, cloud.nz),
                dens=torch.as_tensor(cloud.dens, device=device),
                child=torch.as_tensor(cloud.child, device=device),
                levels=cloud.levels)
