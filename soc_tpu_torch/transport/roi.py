"""Region-of-interest photon save/load (port of soc_tpu.transport.roi): the
reference's two-stage coupling of a large model to a refined sub-model.

A run can record every packet that enters an ROI box as a histogram over
(surface element, Healpix direction), kernel_ASOC.c WITH_ROI_SAVE
(:617-660); a second run over the sub-model re-injects them as a boundary
source (SOURCE==3, :469-505; sources.gen_roi).

File format (ASOC.py:906-946): int32 [rnx, rny, rnz, nside, nfreq] +
float32 [NFREQ, NELEM * 12 * nside^2], NELEM = rny*rnz + rnx*rnz + rnx*rny
(one entry per ROI-box surface element, X/Y/Z sides in that order).
"""

import numpy as np
import torch


def roi_nelem(rnx, rny, rnz):
    return rny * rnz + rnx * rnz + rnx * rny


def roi_cell_mask(grid, roi):
    """bool[CELLS] host array: the cell's root ancestor lies inside the ROI
    box roi = [x0, x1, y0, y1, z0, z1] (inclusive root-cell limits)."""
    x0, x1, y0, y1, z0, z1 = roi
    par = grid.par.cpu().numpy()
    off = grid.off.cpu().numpy()
    lcells = grid.lcells.cpu().numpy()
    mask = np.zeros(grid.cells, bool)
    idx = np.arange(grid.nx * grid.ny * grid.nz)
    ix = idx % grid.nx
    iy = (idx // grid.nx) % grid.ny
    iz = idx // (grid.nx * grid.ny)
    mask[: len(idx)] = ((ix >= x0) & (ix <= x1) & (iy >= y0) & (iy <= y1)
                       & (iz >= z0) & (iz <= z1))
    # deeper levels inherit from their parents
    for lvl in range(1, grid.levels):
        a = off[lvl]
        b = a + lcells[lvl]
        mask[a:b] = mask[off[lvl - 1] + par[a:b]]
    return mask


def roi_element_index(rp, roi, rnx, rny, rnz, step):
    """Surface element of packets entering the ROI at root position rp
    [N, 3] (kernel_ASOC.c:617-648 bookkeeping): the X, Y and Z borders'
    checks in the kernel's order, a later one overriding an earlier one,
    in float32 as soc_tpu computes them (the thresholds are float32 sums
    formed on the host, exact as Python floats). Returns an int64
    tensor."""
    f32 = np.float32
    x0, x1, y0, y1, z0, z1 = [f32(v) for v in roi]

    def near(c, a, b):
        return (rp[:, c] < float(a + f32(1e-3))) \
            | (rp[:, c] > float(b + f32(0.999)))

    near_x, near_y, near_z = near(0, x0, x1), near(1, y0, y1), near(2, z0, z1)

    def coord(c, a, n):
        return ((rp[:, c] - float(a)) * float(step)).to(torch.int64).clamp(
            0, n - 1)

    # X border: (y, z); Y border: (x, z); Z border: (x, y)
    ii = coord(1, y0, rny) + rny * coord(2, z0, rnz)
    ii = torch.where(near_y, rny * rnz + coord(0, x0, rnx)
                     + rnx * coord(2, z0, rnz), ii)
    ii = torch.where(near_z, rny * rnz + rnx * rnz + coord(0, x0, rnx)
                     + rnx * coord(1, y0, rny), ii)
    ii = torch.where(near_x & ~near_y & ~near_z,
                     coord(1, y0, rny) + rny * coord(2, z0, rnz), ii)
    return ii.clamp(0, roi_nelem(rnx, rny, rnz) - 1)


def write_roi_file(path, rnx, rny, rnz, nside, tallies):
    """tallies: [NFREQ, NELEM * 12 * nside^2]."""
    tallies = np.asarray(tallies, np.float32)
    with open(path, "wb") as fp:
        np.asarray([rnx, rny, rnz, nside, tallies.shape[0]],
                   np.int32).tofile(fp)
        tallies.tofile(fp)


def read_roi_file(path):
    with open(path, "rb") as fp:
        rnx, rny, rnz, nside, nfreq = np.fromfile(fp, np.int32, 5)
        npx = 12 * nside * nside
        nelem = roi_nelem(rnx, rny, rnz)
        data = np.fromfile(fp, np.float32).reshape(nfreq, nelem * npx)
    return int(rnx), int(rny), int(rnz), int(nside), data
