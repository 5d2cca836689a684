"""Orthographic maps: line-of-sight integration of dust emission (port of
the ``render_ortho`` path of soc_tpu.render.mapping).

Every ray integrates all frequencies at once, so a step is a
[PIXELS, NFREQ] update and the geometry is shared by the whole spectrum.
Along the ray, stepping away from the observer:
  I += exp(-tau) * (1 - exp(-dtau))/dtau * ds * emit * dens,  tau += dtau
with a Taylor fallback for dtau < 1e-3. The march is a host loop that
checks every CHECK_EVERY steps whether any ray is still inside; steps on
rays that have left change nothing.
"""

import numpy as np
import torch

from soc_tpu.constants import EPS, FACTOR, PARSEC, PLANCK

from ..ops import traverse

CHECK_EVERY = 8     # march steps between host checks for live rays


def observer_basis(theta, phi):
    """(theta, phi) -> (ODIR, RA, DE) orthonormal triad, float32 NumPy;
    the observer lies in direction ODIR, RA increases to the right in the
    map, DE up."""
    b = 0.5 * np.pi - theta          # latitude
    a = phi
    rot = np.asarray([
        [np.cos(a) * np.cos(b), -np.sin(a), -np.cos(a) * np.sin(b)],
        [np.sin(a) * np.cos(b), np.cos(a), -np.sin(a) * np.sin(b)],
        [np.sin(b), 0.0, np.cos(b)]])
    odir = rot @ np.asarray([1.0, 0.0, 0.0])
    ra = rot @ np.asarray([0.0, 1.0, 0.0])
    de = rot @ np.asarray([0.0, 0.0, 1.0])
    odir = np.where(np.abs(odir) < 1e-5, 1e-5, odir)
    return (odir.astype(np.float32), ra.astype(np.float32),
            de.astype(np.float32))


def map_scale_kk(gl_pc):
    """Jy/sr conversion applied to EMITTED before the LOS integration:
    KK = (1e23/FACTOR) * PLANCK/(4 pi) * GL * PARSEC."""
    return (1.0e23 / FACTOR) * PLANCK / (4.0 * np.pi) * gl_pc * PARSEC


def _front_surface(pos, odir, nx, ny, nz):
    """Move ray start positions onto the model's front surface."""
    dims = torch.tensor([nx, ny, nz], dtype=torch.float32, device=pos.device)
    bound = torch.where(odir >= 0.0, dims, torch.zeros_like(dims))
    s = (bound - pos) / (-odir) + EPS                 # [P, 3]
    trial = pos[:, None, :] - s[..., None] * odir     # [P, 3axis, 3]
    ok = ((trial[..., 0] >= 0) & (trial[..., 0] <= nx)
          & (trial[..., 1] >= 0) & (trial[..., 1] <= ny)
          & (trial[..., 2] >= 0) & (trial[..., 2] <= nz))
    s = torch.where(ok, s, 1e10)
    smin = torch.amin(s, dim=-1)
    return pos - smin[:, None] * odir


def render_ortho(grid, emit_map, ext_gl, odir, ra, de, centre, map_dx,
                 npix, max_steps=100000):
    """Orthographic multi-frequency map.

    emit_map : [CELLS, NF] emission pre-scaled by KK*freq (Jy/sr out)
    ext_gl   : [NF] extinction (abs+sca) / unit density / GL
    odir, ra, de : float32 [3] host arrays from observer_basis
    Returns (photons [NF, NY, NX], tau [NF, NY, NX], colden [NY, NX]);
    colden is in GL units.
    """
    device = emit_map.device
    nxp, nyp = npix
    nf = emit_map.shape[1]

    def t3(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    odir, ra, de, centre = t3(odir), t3(ra), t3(de), t3(centre)
    i = torch.arange(nxp, dtype=torch.float32, device=device)
    j = torch.arange(nyp, dtype=torch.float32, device=device)
    jj, ii = torch.meshgrid(j, i, indexing="ij")      # [NY, NX]
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)
    pos = (centre[None, :]
           + ((ii - 0.5 * (nxp - 1)) * map_dx)[:, None] * ra[None, :]
           + ((jj - 0.5 * (nyp - 1)) * map_dx)[:, None] * de[None, :])
    pos = pos + (grid.nx + grid.ny + grid.nz) * odir[None, :]
    pos = _front_surface(pos, odir, grid.nx, grid.ny, grid.nz)

    step_dir = -odir
    step_dir = torch.where(torch.abs(step_dir) < 1e-5, 1e-5, step_dir)
    step_dir = step_dir.expand(pos.shape)

    pos, level, ind, anc = traverse.index_global_stack(grid, pos)
    npixels = pos.shape[0]
    tau = torch.zeros((npixels, nf), dtype=torch.float32, device=device)
    phot = torch.zeros_like(tau)
    colden = torch.zeros(npixels, dtype=torch.float32, device=device)
    ext_row = ext_gl[None, :]

    for it in range(max_steps):
        if it % CHECK_EVERY == 0 and not bool((ind >= 0).any().item()):
            break
        active = ind >= 0
        gidx = traverse._gidx(grid, level, ind.clamp_min(0))
        dens = grid.dens[gidx]
        emit = emit_map[gidx, :]                       # [P, NF]
        ds, npos, nlevel, nind, nanc = traverse.get_step_stack(
            grid, pos, step_dir, level, ind, anc, active)
        failed = active & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, step_dir, failed)
        w = torch.where(active, ds, 0.0)
        wd = (w * dens)[:, None]
        dtau = wd * ext_row
        attw = torch.where(dtau < 1.0e-3, 1.0 - 0.5 * dtau,
                           (1.0 - torch.exp(-dtau))
                           / torch.clamp_min(dtau, 1e-30))
        phot = phot + torch.exp(-tau) * attw * wd * emit
        tau = tau + dtau
        colden = colden + w * dens
        pos, level, ind, anc = npos, nlevel, nind, nanc
    phot = phot.T.reshape(nf, nyp, nxp)
    tau = tau.T.reshape(nf, nyp, nxp)
    return phot, tau, colden.reshape(nyp, nxp)
