"""Maps: line-of-sight integration of dust emission (port of
soc_tpu.render.mapping): orthographic maps (with MAP_INTERPOLATION and the
shearing-box continuation), all-sky Healpix maps from an internal observer
(with the `interpolate` density smoothing), perspective panoramas, the
point sources' optical depths (PSTau) and the MAP_HIER maps split by
hierarchy level.

Every ray integrates all frequencies at once, so a step is a
[PIXELS, NFREQ] update and the geometry is shared by the whole spectrum.
Along the ray, stepping away from the observer:
  I += exp(-tau) * (1 - exp(-dtau))/dtau * ds * emit * dens,  tau += dtau
with a Taylor fallback for dtau < 1e-3. The march (``_march``, shared by
every renderer) is a host loop that checks every CHECK_EVERY steps whether
any ray is still inside; steps on rays that have left change nothing. A
renderer given a ``stats`` dict adds its rays to stats["rays"] and its
march steps to stats["steps"] there.
"""

import math

import numpy as np
import torch

from ..constants import EPS, FACTOR, PARSEC, PLANCK

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


def _t3(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _ortho_rays(grid, odir, ra, de, centre, map_dx, npix, row0, nrows,
                device):
    """Start positions (on the front surface) and step directions of an
    orthographic map's rays, rows [row0, row0 + nrows)."""
    nxp, nyp = npix
    odir, ra, de, centre = (_t3(v, device) for v in (odir, ra, de, centre))
    i = torch.arange(nxp, dtype=torch.float32, device=device)
    j = torch.arange(nrows, dtype=torch.float32, device=device) + float(row0)
    jj, ii = torch.meshgrid(j, i, indexing="ij")      # [NROWS, NX]
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)
    pos = (centre[None, :]
           + ((ii - 0.5 * (nxp - 1)) * map_dx)[:, None] * ra[None, :]
           + ((jj - 0.5 * (nyp - 1)) * map_dx)[:, None] * de[None, :])
    pos = pos + (grid.nx + grid.ny + grid.nz) * odir[None, :]
    pos = _front_surface(pos, odir, grid.nx, grid.ny, grid.nz)
    step_dir = -odir
    step_dir = torch.where(torch.abs(step_dir) < 1e-5, 1e-5, step_dir)
    return pos, step_dir.expand(pos.shape)


def _sky_dirs(theta, phi, sign):
    """Step directions (sin t cos p, sin t sin p, cos t) times (sign,
    sign, 1), with the 1e-5 floor on each component."""
    d = torch.stack([sign * torch.sin(theta) * torch.cos(phi),
                     sign * torch.sin(theta) * torch.sin(phi),
                     torch.cos(theta)], -1)
    return torch.where(torch.abs(d) < 1e-5, 1e-5, d)


def _gather_cells(grid, level, ind):
    return traverse._gidx(grid, level, ind.clamp_min(0))


def _march(grid, emit_map, ext_gl, pos, step_dir, max_steps, levels=False,
           interpolate=0, interp_axes=None, shear=None, stats=None):
    """Integrate the rays starting at global positions pos [P, 3] along
    step_dir [P, 3] until every one has left the grid.

    emit_map [CELLS, NF] (None: optical depth and column density only,
    PSTau); ext_gl [NF] or [CELLS, NF]. levels: split the emission by the
    emitting cell's hierarchy level (MAP_HIER). interpolate: the all-sky
    maps' density smoothing mode (_interp_density). interp_axes: (ra, de)
    for MAP_INTERPOLATION's cross-ray triangle weights. shear: (y_shear,
    maxlos) for the shearing-box continuation through the X faces.
    stats: a dict whose "rays" and "steps" this march adds to, or None.
    Returns (photons [P, NF] or [P, LEVELS, NF] or None, tau [P, NF],
    colden [P])."""
    device = pos.device
    nf = ext_gl.shape[-1]
    pos, level, ind, anc = traverse.index_global_stack(grid, pos)
    npixels = pos.shape[0]
    tau = torch.zeros((npixels, nf), dtype=torch.float32, device=device)
    phot = None
    if emit_map is not None:
        phot = torch.zeros((npixels, grid.levels, nf) if levels
                           else (npixels, nf), dtype=torch.float32,
                           device=device)
    colden = torch.zeros(npixels, dtype=torch.float32, device=device)
    los = torch.zeros_like(colden)
    ext_row = ext_gl[None, :] if ext_gl.ndim == 1 else None
    lev_ar = torch.arange(grid.levels, device=device)
    steps = 0
    for it in range(max_steps):
        if it % CHECK_EVERY == 0 and not bool((ind >= 0).any().item()):
            break
        steps = it + 1
        active = ind >= 0
        gidx = _gather_cells(grid, level, ind)
        dens = grid.dens[gidx]
        if interpolate:
            gpos = traverse.root_pos(grid, pos, level, ind)
        ds, npos, nlevel, nind, nanc = traverse.get_step_stack(
            grid, pos, step_dir, level, ind, anc, active)
        failed = active & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, step_dir, failed)
        emit = None if emit_map is None else emit_map[gidx, :]   # [P, NF]
        if interpolate:
            dens = _interp_density(grid, gpos + (0.5 * ds)[:, None]
                                   * step_dir, dens, level, interpolate)
        if interp_axes is not None:
            dens, emit = _cross_ray(grid, emit_map, pos, step_dir, ds, level,
                                    ind, anc, active, dens, emit,
                                    interp_axes)
        w = torch.where(active, ds, 0.0)
        wd = (w * dens)[:, None]
        dtau = wd * (ext_gl[gidx, :] if ext_row is None else ext_row)
        if emit is not None:
            attw = torch.where(dtau < 1.0e-3, 1.0 - 0.5 * dtau,
                               (1.0 - torch.exp(-dtau))
                               / torch.clamp_min(dtau, 1e-30))
            contrib = torch.exp(-tau) * attw * wd * emit
            if levels:
                onehot = (level[:, None] == lev_ar[None, :]).to(
                    torch.float32)
                phot = phot + onehot[:, :, None] * contrib[:, None, :]
            else:
                phot = phot + contrib
        tau = tau + dtau
        colden = colden + w * dens
        if shear is not None:
            los = los + w
            npos, nlevel, nind, nanc = _shear_wrap(
                grid, active, npos, nlevel, nind, nanc, los, *shear)
        pos, level, ind, anc = npos, nlevel, nind, nanc
    if stats is not None:
        stats["rays"] = stats.get("rays", 0) + npixels
        stats["steps"] = stats.get("steps", 0) + steps
    return phot, tau, colden


def _cross_ray(grid, emit_map, pos, step_dir, ds, level, ind, anc, active,
               dens, emit, axes):
    """MAP_INTERPOLATION (kernel_ASOC_map.c:656-760): the two cells beside
    the ray along the map's (ra, de) axes at the step's midpoint, blended
    with the ray's own as (0.5 - a) A + (0.5 - b) B + (a + b) C."""
    k = torch.exp2(-level.to(torch.float32))
    mid = pos + (0.5 * ds / k)[:, None] * step_dir

    def neighbour(adir):
        d = adir.expand(pos.shape)
        sa, _, sl, si, _ = traverse.get_step_stack(grid, mid, d, level, ind,
                                                   anc, active)
        sa = sa / k
        ok = (sa <= 0.52) & (si >= 0)
        # the opposite side when there is no near neighbour
        sb, _, sl2, si2, _ = traverse.get_step_stack(grid, mid, -d, level,
                                                     ind, anc, active)
        sb = sb / k
        ok2 = ~ok & (sb <= 0.52) & (si2 >= 0)
        sl = torch.where(ok, sl, sl2)
        si = torch.where(ok, si, si2)
        dist = torch.where(ok, sa, torch.where(ok2, sb, 0.5))
        any_ok = ok | ok2
        gi = _gather_cells(grid, sl, si)
        nd = torch.where(any_ok, grid.dens[gi], 0.0)
        nemit = torch.where(any_ok[:, None], emit_map[gi, :], 0.0)
        return torch.clamp(dist, 0.0, 0.51), nd, nemit

    ra, de = axes
    a, adens, aemit = neighbour(ra)
    b, bdens, bemit = neighbour(de)
    dens = (0.5 - a) * adens + (0.5 - b) * bdens + (a + b) * dens
    emit = ((0.5 - a)[:, None] * aemit + (0.5 - b)[:, None] * bemit
            + (a + b)[:, None] * emit)
    return dens, emit


def _shear_wrap(grid, active, npos, nlevel, nind, nanc, los, y_shear,
                maxlos, margin=2.0 * EPS):
    """The shearing-box continuation (kernel_ASOC_map_H.c:800-830): a ray
    leaving through an X face inside the Z range re-enters on the opposite
    side with y shifted by -/+ y_shear root cells (the Y faces wrap), until
    its path exceeds maxlos [GL]. The re-entry point keeps ``margin`` root
    cells inside the faces: soc_tpu writes 2 EPS for the maps and 1e-3 for
    the polarization maps (render/polarization.py), the same float."""
    # float32 bounds, so nx - margin rounds as soc_tpu's float32 does
    nx_, ny_, nz_ = (torch.tensor(float(v), device=npos.device)
                     for v in (grid.nx, grid.ny, grid.nz))
    exited = active & (nind < 0)
    zin = (npos[:, 2] > 0.0) & (npos[:, 2] < nz_)
    cont = exited & zin & (los < maxlos)
    xlo = npos[:, 0] <= 0.0
    xhi = npos[:, 0] >= nx_
    newx = torch.where(xlo, nx_ - margin,
                       torch.where(xhi, margin, npos[:, 0]))
    ys = float(np.float32(y_shear))
    yshift = torch.where(xlo, -ys, torch.where(xhi, ys, 0.0))
    newy = torch.remainder(npos[:, 1] + ny_ + yshift, ny_)
    newy = torch.minimum(torch.clamp_min(newy, margin), ny_ - margin)
    wpos = torch.stack([newx, newy, npos[:, 2]], 1)
    wp, wl, wi, wa = traverse.index_global_stack(grid, wpos)
    npos = torch.where(cont[:, None], wp, npos)
    nlevel = torch.where(cont, wl, nlevel)
    nind = torch.where(cont, wi, nind)
    nanc = torch.where(cont[:, None], wa, nanc)
    return npos, nlevel, nind, nanc


def render_ortho(grid, emit_map, ext_gl, odir, ra, de, centre, map_dx,
                 npix, max_steps=100000, row0=0, nrows=None,
                 use_shear=False, y_shear=0.0, maxlos=1e10, map_interp=0,
                 stats=None):
    """Orthographic multi-frequency map.

    emit_map : [CELLS, NF] emission pre-scaled by KK*freq (Jy/sr out)
    ext_gl   : [NF] extinction (abs+sca) / unit density / GL, or
               [CELLS, NF] each cell's own (WITH_ABU)
    odir, ra, de : float32 [3] host arrays from observer_basis
    row0, nrows : render only map rows [row0, row0 + nrows) (all by
        default); NY is then nrows in the outputs
    use_shear : the shearing-box continuation (`yshear`): rays leaving
        through the X faces re-enter on the opposite side with y shifted
        by -/+ y_shear root cells (the Y faces wrap) until the path
        exceeds maxlos [GL]
    map_interp > 0 : MAP_INTERPOLATION's cross-ray triangle weights
    Returns (photons [NF, NY, NX], tau [NF, NY, NX], colden [NY, NX]);
    colden is in GL units.
    """
    device = emit_map.device
    nxp, nyp = npix
    if nrows is None:
        nrows = nyp
    nf = emit_map.shape[1]
    pos, step_dir = _ortho_rays(grid, odir, ra, de, centre, map_dx, npix,
                                row0, nrows, device)
    axes = (_t3(ra, device), _t3(de, device)) if map_interp > 0 else None
    phot, tau, colden = _march(
        grid, emit_map, ext_gl, pos, step_dir, max_steps, interp_axes=axes,
        shear=(y_shear, maxlos) if use_shear else None, stats=stats)
    return (phot.T.reshape(nf, nrows, nxp), tau.T.reshape(nf, nrows, nxp),
            colden.reshape(nrows, nxp))


def _interp_density(grid, mid, dens0, olevel, mode):
    """LOS density smoothing of the all-sky maps (`interpolate`,
    kernel_ASOC_map_H.c:654-733): the density at the global step midpoint
    ``mid`` in place of the cell's value ``dens0``.

    mode 1: a 4-point linear blend with one axis neighbour a dimension
            (regular root grids, as the reference);
    mode 2: 3x3x3 inverse-distance weighting (regular root grids);
    mode 3: 3x3x3 IDW with full hierarchy lookups at +-one cell size
            (refined grids too: 27 leaf walks a step).
    """
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    if mode == 1:
        i0 = torch.floor(mid[:, 0]).to(torch.int64).clamp(0, nx - 1)
        j0 = torch.floor(mid[:, 1]).to(torch.int64).clamp(0, ny - 1)
        k0 = torch.floor(mid[:, 2]).to(torch.int64).clamp(0, nz - 1)
        m = torch.remainder(mid, 1.0) - 0.5
        s = (3.0 - torch.abs(m).sum(-1)) * dens0

        def leafd(gi):
            # a refined root cell holds a child link (<= 0): the ray's own
            # leaf density stands in for it
            v = grid.dens[gi]
            return torch.where(v > 0.0, v, dens0)

        ix = torch.where(m[:, 0] > 0, (i0 - 1).clamp_min(0),
                         (i0 + 1).clamp_max(nx - 1))
        s = s + torch.abs(m[:, 0]) * leafd(k0 * nx * ny + j0 * nx + ix)
        iy = torch.where(m[:, 1] > 0, (j0 - 1).clamp_min(0),
                         (j0 + 1).clamp_max(ny - 1))
        s = s + torch.abs(m[:, 1]) * leafd(k0 * nx * ny + iy * nx + i0)
        iz = torch.where(m[:, 2] > 0, (k0 - 1).clamp_min(0),
                         (k0 + 1).clamp_max(nz - 1))
        s = s + torch.abs(m[:, 2]) * leafd(iz * nx * ny + j0 * nx + i0)
        return s / 3.0
    tot = torch.zeros_like(dens0)
    wtot = torch.zeros_like(dens0)
    if mode == 2:
        i0 = torch.floor(mid[:, 0]).to(torch.int64)
        j0 = torch.floor(mid[:, 1]).to(torch.int64)
        k0 = torch.floor(mid[:, 2]).to(torch.int64)
        for dk in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for di in (-1, 0, 1):
                    i, j, k = i0 + di, j0 + dj, k0 + dk
                    gi = (k.clamp(0, nz - 1) * nx * ny
                          + j.clamp(0, ny - 1) * nx + i.clamp(0, nx - 1))
                    v = grid.dens[gi]
                    # out-of-bounds neighbours and refined (link) cells
                    # take no weight
                    ok = ((i >= 0) & (i < nx) & (j >= 0) & (j < ny)
                          & (k >= 0) & (k < nz) & (v > 0.0))
                    d = mid - torch.stack([i + 0.5, j + 0.5, k + 0.5],
                                          -1).to(mid.dtype)
                    w = torch.where(ok, 1.0 / (0.1 + torch.sqrt(
                        (d * d).sum(-1))), 0.0)
                    tot = tot + w * v
                    wtot = wtot + w
        return torch.where(wtot > 0.0,
                           tot / torch.clamp_min(wtot, 1e-30), dens0)
    # mode 3
    delta = torch.exp2(-olevel.to(mid.dtype))[:, None]
    for dk in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                off3 = torch.tensor([di, dj, dk], dtype=mid.dtype,
                                    device=mid.device)
                _, lvl, ind, _ = traverse.index_global_stack(
                    grid, mid + delta * off3)
                ok = ind >= 0
                gi = _gather_cells(grid, lvl, ind)
                w = torch.where(ok, 1.0 / math.sqrt(
                    0.2 + di * di + dj * dj + dk * dk), 0.0)
                tot = tot + w * grid.dens[gi]
                wtot = wtot + w
    return tot / torch.clamp_min(wtot, 1e-30)


def _healpix_rays(nside, intobs, device):
    """One ray a RING pixel from the internal observer: (pos, step_dir);
    (lon, lat) = (0, 0) looks along -X."""
    from . import healpix as hp
    theta, phi = hp.pix2ang_ring(
        nside, torch.arange(hp.npix(nside), device=device))
    step_dir = _sky_dirs(theta, phi, -1.0)
    pos = _t3(intobs, device).expand(step_dir.shape) + 2.0e-5
    return pos, step_dir


def render_healpix(grid, emit_map, ext_gl, intobs, nside, max_steps=100000,
                   interpolate=0, stats=None):
    """All-sky map around an internal observer (HealpixMapping,
    kernel_ASOC_map.c:890-965): one ray per RING pixel stepping away from
    INTOBS, (lon, lat) = (0, 0) looking along -X; ``interpolate`` the
    density smoothing mode (_interp_density).
    Returns (photons [NF, NPIX], tau [NF, NPIX], colden [NPIX])."""
    pos, step_dir = _healpix_rays(nside, intobs, emit_map.device)
    phot, tau, colden = _march(grid, emit_map, ext_gl, pos, step_dir,
                               max_steps, interpolate=int(interpolate),
                               stats=stats)
    return phot.T, tau.T, colden


def render_perspective(grid, emit_map, ext_gl, intobs, npix,
                       max_steps=100000, stats=None):
    """Panoramic (lon, lat) map from an internal observer (the INTOBS
    branch of the Mapping kernel, kernel_ASOC_map.c:538-557): longitude
    spans 2 pi over NPIX.x with lon 0 in the map centre, latitude rows of
    one pixel's angle around the equator. The map centre looks along +X,
    the reference's convention: its all-sky maps look along -X at (0, 0),
    so a panorama and an all-sky map of one model differ by 180 degrees in
    longitude, in the reference too.
    Returns (photons [NF, NY, NX], tau [NF, NY, NX], colden [NY, NX])."""
    device = emit_map.device
    nxp, nyp = npix
    nf = emit_map.shape[1]
    i = torch.arange(nxp, dtype=torch.float32, device=device)
    j = torch.arange(nyp, dtype=torch.float32, device=device)
    jj, ii = torch.meshgrid(j, i, indexing="ij")
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)
    phi = 2.0 * math.pi * ii / nxp + math.pi
    pix = 2.0 * math.pi / nxp
    lat = pix * (jj - (nyp - 1) / 2.0)
    step_dir = torch.stack([torch.cos(lat) * torch.cos(phi),
                            torch.cos(lat) * torch.sin(phi),
                            torch.sin(lat)], -1)
    step_dir = torch.where(torch.abs(step_dir) < 1e-5, 1e-5, step_dir)
    pos = _t3(intobs, device).expand(step_dir.shape) + 2.0e-5
    phot, tau, colden = _march(grid, emit_map, ext_gl, pos, step_dir,
                               max_steps, stats=stats)
    return (phot.T.reshape(nf, nyp, nxp), tau.T.reshape(nf, nyp, nxp),
            colden.reshape(nyp, nxp))


def render_pstau(grid, ext_gl, ps_pos, odir, max_steps=100000, stats=None):
    """Optical depth and column density from each point source toward the
    observer (PSTau, kernel_ASOC_map.c:1545-1583): one ray a source,
    stepping along the observer's direction until it leaves.
    ps_pos [S, 3]; ext_gl [NF] or [CELLS, NF].
    Returns (tau [S, NF], colden [S]), colden in GL units."""
    ps_pos = torch.as_tensor(ps_pos, dtype=torch.float32,
                             device=ext_gl.device)
    step_dir = _t3(odir, ext_gl.device)
    step_dir = torch.where(torch.abs(step_dir) < 1e-5, 1e-5, step_dir)
    _, tau, colden = _march(grid, None, ext_gl, ps_pos,
                            step_dir.expand(ps_pos.shape), max_steps,
                            stats=stats)
    return tau, colden


def render_ortho_hier(grid, emit_map, ext_gl, odir, ra, de, centre, map_dx,
                      npix, max_steps=100000, stats=None):
    """Orthographic maps split by hierarchy level (MAP_HIER,
    kernel_ASOC_map_H.c): each step's emission binned by the emitting
    cell's level. Returns photons [LEVELS, NF, NY, NX]."""
    nxp, nyp = npix
    nf = emit_map.shape[1]
    pos, step_dir = _ortho_rays(grid, odir, ra, de, centre, map_dx, npix,
                                0, nyp, emit_map.device)
    phot, _, _ = _march(grid, emit_map, ext_gl, pos, step_dir, max_steps,
                        levels=True, stats=stats)
    return phot.permute(1, 2, 0).reshape(grid.levels, nf, nyp, nxp)


def render_healpix_hier(grid, emit_map, ext_gl, intobs, nside,
                        max_steps=100000, stats=None):
    """All-sky maps split by hierarchy level: MAP_HIER with a Healpix map
    (`mapping NSIDE -1 dx 999`), the rays of render_healpix binned by
    level as in render_ortho_hier. The reference kernel collapses the
    levels into one plane although its file holds LEVELS planes; soc_tpu
    splits them, and so does the port: the planes sum to that one plane.
    Returns (photons [LEVELS, NF, NPIX], tau [NF, NPIX], colden [NPIX])."""
    pos, step_dir = _healpix_rays(nside, intobs, emit_map.device)
    phot, tau, colden = _march(grid, emit_map, ext_gl, pos, step_dir,
                               max_steps, levels=True, stats=stats)
    return phot.permute(1, 2, 0), tau.T, colden
