"""Polarized emission maps (port of soc_tpu.render.polarization): Stokes
I, Q, U and column density, orthographic and all-sky, and the POLSTAT
statistics maps.

Per line-of-sight step, from the cell's magnetic field B (the reference
PolMapping kernel, Planck XX formalism):

    Psi = pi/2 + atan2(B . (-RA), B . DE)      polarisation angle (IAU)
    cos^2(gamma) = 0.99999 - 0.99998 (B_hat . DIR)^2
    I += S * (1 - p (cos^2 gamma - 2/3))
    Q += p * S * cos(2 Psi) cos^2 gamma
    U += p * S * sin(2 Psi) cos^2 gamma

with S the attenuated emission of the step (render/mapping.py) and p the
polarisation reduction factor: p0, or |B| under `polred`. The POLSTAT
maps take two marches: the first gives <Psi> from the weighted Q/U sums
and the mean inclination, the second the folded (Psi - <Psi>)^2 sums.

Every march is a host loop in the style of mapping._march (a check for
live rays every CHECK_EVERY steps); a render given a ``stats`` dict adds
its rays (each march's, so a POLSTAT render counts its pixels twice) to
stats["rays"] and its march steps to stats["steps"].
"""

import math

import torch

from ..ops import traverse
from . import healpix as hp
from .mapping import (CHECK_EVERY, _gather_cells, _interp_density,
                      _ortho_rays, _shear_wrap, _sky_dirs, _t3)

SHEAR_MARGIN = 1e-3     # the polarization maps' shearing re-entry margin


def _walk(grid, pos, step_dir, max_steps, body, stats, interpolate=0):
    """March rays from global positions pos [P, 3] along step_dir [P, 3]
    until all have left (or max_steps). Each step calls
    body(active, gidx, dens, ds, npos, nlevel, nind, nanc), which returns
    the (possibly continued) (npos, nlevel, nind, nanc). ``interpolate``
    replaces dens by the `interpolate` smoothing at the step midpoint."""
    pos, level, ind, anc = traverse.index_global_stack(grid, pos)
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
        if interpolate:
            dens = _interp_density(grid, gpos + (0.5 * ds)[:, None]
                                   * step_dir, dens, level, interpolate)
        pos, level, ind, anc = body(active, gidx, dens, ds, npos, nlevel,
                                    nind, nanc)
    if stats is not None:
        stats["rays"] = stats.get("rays", 0) + pos.shape[0]
        stats["steps"] = stats.get("steps", 0) + steps


def _norm(b):
    """|B| as XLA's norm computes it: sqrt of the sum of squares."""
    return torch.sqrt((b * b).sum(-1))


def _geometry(b, ra, de, odir, offset):
    """(|B|, Psi, cos^2 gamma) of field vectors b [P, 3]; ra, de, odir
    [3] or [P, 3]; Psi = offset + atan2(B_hat . (-RA), B_hat . DE) with
    offset pi/2 (the orthographic maps) or atan2(B_hat . RA, B_hat . DE)
    with offset None (the all-sky POLSTAT maps)."""
    bnorm = _norm(b)
    bn = b / torch.clamp_min(bnorm, 1e-30)[:, None]
    if offset is None:
        psi = torch.atan2((bn * ra).sum(-1), (bn * de).sum(-1))
    else:
        psi = offset + torch.atan2((bn * (-ra)).sum(-1), (bn * de).sum(-1))
    bdotdir = (bn * odir).sum(-1)
    return bnorm, psi, 0.99999 - 0.99998 * bdotdir * bdotdir


def _ext_rows(ext_gl, gidx):
    return ext_gl[gidx, :] if ext_gl.ndim == 2 else ext_gl[None, :]


def _attenuated(emit_map, gidx, dtau, tau, wd):
    """The step's attenuated emission exp(-tau) (1 - e^-dtau)/dtau wd emit
    [P, NF], with the Taylor form below dtau 1e-3."""
    attw = torch.where(dtau < 1.0e-3, 1.0 - 0.5 * dtau,
                       (1.0 - torch.exp(-dtau))
                       / torch.clamp_min(dtau, 1e-30))
    return torch.exp(-tau) * attw * wd[:, None] * emit_map[gidx, :]


def _stokes_march(grid, emit_map, ext_gl, bfield, p0, pos, step_dir, ra, de,
                  odir, max_steps, polred, rho_weight, maxlos, minlos,
                  shear, interpolate, stats):
    """The Stokes march of render_pol and render_pol_healpix: returns
    (I, Q, U [P, NF], colden [P]). shear: y_shear for the continuation
    (the rays wrap until their path passes maxlos) or None."""
    device = pos.device
    npixels, nf = pos.shape[0], emit_map.shape[1]
    acc = dict(tau=torch.zeros((npixels, nf), device=device),
               i=torch.zeros((npixels, nf), device=device),
               q=torch.zeros((npixels, nf), device=device),
               u=torch.zeros((npixels, nf), device=device),
               colden=torch.zeros(npixels, device=device),
               los=torch.zeros(npixels, device=device))

    def body(active, gidx, dens, ds, npos, nlevel, nind, nanc):
        bnorm, psi, cc = _geometry(bfield[gidx], ra, de, odir, 0.5 * math.pi)
        p = bnorm if polred else torch.full_like(bnorm, float(p0))
        w = torch.where(active, ds, 0.0)
        wd = w * dens
        dtau = wd[:, None] * _ext_rows(ext_gl, gidx)
        if rho_weight:
            sz = wd[:, None].expand(dtau.shape)
        else:
            sz = _attenuated(emit_map, gidx, dtau, acc["tau"], wd)
        # `polmap .. minlos maxlos`: nothing registers before the path
        # reaches minlos or after it passes maxlos, optical depth included
        # (it counts from minlos); column density from minlos on
        los = acc["los"]
        reg = ((los >= minlos) & (los < maxlos))[:, None]
        acc["i"] = acc["i"] + torch.where(
            reg, sz * (1.0 - p[:, None] * (cc - 2.0 / 3.0)[:, None]), 0.0)
        acc["q"] = acc["q"] + torch.where(
            reg, (p * torch.cos(2.0 * psi) * cc)[:, None] * sz, 0.0)
        acc["u"] = acc["u"] + torch.where(
            reg, (p * torch.sin(2.0 * psi) * cc)[:, None] * sz, 0.0)
        acc["tau"] = acc["tau"] + torch.where(reg, dtau, 0.0)
        acc["colden"] = acc["colden"] + torch.where(los >= minlos, wd, 0.0)
        los = acc["los"] = los + w
        if shear is not None:
            npos, nlevel, nind, nanc = _shear_wrap(
                grid, active, npos, nlevel, nind, nanc, los, shear, maxlos,
                margin=SHEAR_MARGIN)
        nind = torch.where(los >= maxlos, -1, nind)
        return npos, nlevel, nind, nanc

    _walk(grid, pos, step_dir, max_steps, body, stats, interpolate)
    return acc["i"], acc["q"], acc["u"], acc["colden"]


def render_pol(grid, emit_map, ext_gl, bfield, p0, odir, ra, de, centre,
               map_dx, npix, polred=False, rho_weight=False,
               max_steps=100000, use_shear=False, y_shear=0.0, maxlos=1e10,
               minlos=-1.0, stats=None):
    """Stokes maps for one observer direction.

    emit_map : [CELLS, NF] emission pre-scaled by KK*freq
    ext_gl   : [NF] extinction / unit density / GL, or [CELLS, NF]
    bfield   : [CELLS, 3] magnetic field vectors
    odir, ra, de : float32 [3] host arrays from mapping.observer_basis
    polred   : p = |B| in place of p0; rho_weight (`polrhoweight`): the
               density w * dens in place of the attenuated emission
    use_shear: POLSTAT 2's shearing-box replication (`yshear`) until the
               path passes maxlos; minlos / maxlos the `polmap` window
    Returns (I, Q, U) each [NF, NY, NX] and colden [NY, NX] (GL units).
    """
    device = emit_map.device
    nxp, nyp = npix
    nf = emit_map.shape[1]
    pos, step_dir = _ortho_rays(grid, odir, ra, de, centre, map_dx, npix, 0,
                                nyp, device)
    s_i, s_q, s_u, colden = _stokes_march(
        grid, emit_map, ext_gl, bfield, p0, pos, step_dir, _t3(ra, device),
        _t3(de, device), _t3(odir, device), max_steps, polred, rho_weight,
        maxlos, minlos, y_shear if use_shear else None, 0, stats)
    shape = (nf, nyp, nxp)
    return (s_i.T.reshape(shape), s_q.T.reshape(shape), s_u.T.reshape(shape),
            colden.reshape(nyp, nxp))


def _sky_basis(nside, intobs, device):
    """The all-sky rays from the internal observer: (pos, step_dir, ra,
    de, odir), each [NPIX, 3]. RA and DE are each pixel's orthonormal
    tangent basis (DE north, RA east of the line of sight), soc_tpu's
    deliberate deviation from kernel_ASOC_map_H.c:53-59, which takes them
    from the un-negated direction while marching along a z-negated one
    (its mid-latitude Psi mixes in the line-of-sight component of B)."""
    theta, phi = hp.pix2ang_ring(
        nside, torch.arange(hp.npix(nside), device=device))
    step_dir = _sky_dirs(theta, phi, -1.0)
    ra = torch.stack([torch.sin(phi), -torch.cos(phi),
                      torch.zeros_like(phi)], -1)
    de = torch.stack([torch.cos(theta) * torch.cos(phi),
                      torch.cos(theta) * torch.sin(phi),
                      torch.sin(theta)], -1)
    pos = _t3(intobs, device).expand(step_dir.shape) + 2.0e-5
    return pos, step_dir, ra, de, -step_dir


def render_pol_healpix(grid, emit_map, ext_gl, bfield, p0, intobs, nside,
                       polred=False, max_steps=100000, maxlos=1e10,
                       minlos=-1.0, interpolate=0, stats=None):
    """All-sky Stokes I/Q/U maps around an internal observer
    (PolHealpixMapping): one ray per RING pixel stepping away from INTOBS,
    the per-step geometry of render_pol in each pixel's tangent basis;
    ``interpolate`` the density smoothing mode (mapping._interp_density).
    Returns (I, Q, U) each [NF, NPIX] and colden [NPIX] (GL units)."""
    pos, step_dir, ra, de, odir = _sky_basis(nside, intobs, emit_map.device)
    s_i, s_q, s_u, colden = _stokes_march(
        grid, emit_map, ext_gl, bfield, p0, pos, step_dir, ra, de, odir,
        max_steps, polred, False, maxlos, minlos, None, int(interpolate),
        stats)
    return s_i.T, s_q.T, s_u.T, colden


def _polstat_acc1(acc, pr, psi, cc, wrho, sz):
    """Pass-1 POLSTAT sums shared by the orthographic and all-sky maps:
    density- (sR*) and emission-weighted (sJ*) sums of cos^2 gamma and the
    Q/U components that define <Psi>. Returns a new dict."""
    wr = wrho * pr
    wj = sz * pr[:, None]
    # each product in soc_tpu's order: (wr cos 2Psi) cc, wj (cos 2Psi cc)
    c2 = torch.cos(2.0 * psi) * cc
    s2 = torch.sin(2.0 * psi) * cc
    acc = dict(acc)
    acc["sR"] = acc["sR"] + wr
    acc["sRG"] = acc["sRG"] + wr * cc
    acc["RQ"] = acc["RQ"] + wr * torch.cos(2.0 * psi) * cc
    acc["RU"] = acc["RU"] + wr * torch.sin(2.0 * psi) * cc
    acc["sJ"] = acc["sJ"] + wj
    acc["sJG"] = acc["sJG"] + wj * cc[:, None]
    acc["JQ"] = acc["JQ"] + wj * c2[:, None]
    acc["JU"] = acc["JU"] + wj * s2[:, None]
    return acc


def _polstat_acc2(acc, pr, psi, rpsi, jpsi, wrho, sz):
    """Pass-2 POLSTAT sums (shared): the folded (Psi - <Psi>)^2 sums of
    the rT / jT dispersion planes. Returns a new dict."""
    d = _wrap_psi_dev(rpsi, psi)
    dj = _wrap_psi_dev(jpsi, psi[:, None])
    acc = dict(acc)
    acc["sRP"] = acc["sRP"] + wrho * pr * d * d
    acc["sJP"] = acc["sJP"] + sz * pr[:, None] * dj * dj
    return acc


def _wrap_psi_dev(mean_psi, psi):
    """Angle difference folded to [0, pi/2] as the reference does
    (kernel_ASOC_map.c:1330-1340): d = |2 pi + <Psi> - Psi| mod pi (a
    floored mod), then pi - d where d > pi/2 (the polarisation
    pseudo-vector has period pi)."""
    d = torch.remainder(torch.abs(2.0 * math.pi + mean_psi - psi), math.pi)
    return torch.where(d > 0.5 * math.pi, math.pi - d, d)


def _polstat_marches(grid, emit_map, ext_gl, pos, step_dir, max_steps,
                     geom, extra1, acc1, stats, maxlos=None, shear=None):
    """The two POLSTAT marches over the same rays. geom(gidx) -> (pr, psi,
    cc); extra1(acc, gidx, raw_wrho) adds pass 1's own sums and returns
    the density weight the statistics take (or None: the raw one). With
    maxlos (the all-sky maps) the last step is cut at maxlos and the rays
    stop there; shear: y_shear of the continuation. Returns (pass-1 sums,
    pass-2 sums, <Psi> by density, by emission)."""
    device = pos.device
    npixels, nf = pos.shape[0], emit_map.shape[1]

    def march(update, acc):
        acc = dict(acc, tau=torch.zeros((npixels, nf), device=device))
        los = [torch.zeros(npixels, device=device)]

        def body(active, gidx, dens, ds, npos, nlevel, nind, nanc):
            sx = torch.where(active, ds, 0.0)
            if maxlos is not None:
                sx = torch.minimum(sx, torch.clamp_min(maxlos - los[0], 0.0))
            dtau = (sx * dens)[:, None] * _ext_rows(ext_gl, gidx)
            sz = _attenuated(emit_map, gidx, dtau, acc["tau"], sx * dens)
            acc.update(update(acc, gidx, sx * dens, sz))
            acc["tau"] = acc["tau"] + dtau
            if maxlos is not None:
                los[0] = los[0] + torch.where(active, ds, 0.0)
                if shear is not None:
                    npos, nlevel, nind, nanc = _shear_wrap(
                        grid, active, npos, nlevel, nind, nanc, los[0],
                        shear, maxlos, margin=SHEAR_MARGIN)
                nind = torch.where(los[0] >= maxlos, -1, nind)
            return npos, nlevel, nind, nanc

        _walk(grid, pos, step_dir, max_steps, body, stats)
        return acc

    def pass1(acc, gidx, wrho, sz):
        pr, psi, cc = geom(gidx)
        w = extra1(acc, gidx, wrho)
        return _polstat_acc1(acc, pr, psi, cc, wrho if w is None else w, sz)

    zp = torch.zeros(npixels, device=device)
    zf = torch.zeros((npixels, nf), device=device)
    a1 = march(pass1, dict(acc1, sR=zp, sRG=zp, RQ=zp, RU=zp, sJ=zf, sJG=zf,
                           JQ=zf, JU=zf))
    rpsi = 0.5 * torch.atan2(a1["RU"], a1["RQ"])
    jpsi = 0.5 * torch.atan2(a1["JU"], a1["JQ"])

    def pass2(acc, gidx, wrho, sz):
        pr, psi, _ = geom(gidx)
        w = extra1(None, gidx, wrho)
        return _polstat_acc2(acc, pr, psi, rpsi, jpsi,
                             wrho if w is None else w, sz)

    a2 = march(pass2, dict(sRP=zp, sJP=zf))
    return a1, a2


def _dispersion(a1, a2):
    """rT, rI [P] and jT, jI [P, NF] from the two passes' sums."""
    s_r = torch.clamp_min(a1["sR"], 1e-30)
    s_j = torch.clamp_min(a1["sJ"], 1e-30)
    return dict(
        rT=torch.sqrt(a2["sRP"] / s_r),
        rI=torch.arccos(torch.sqrt(torch.clamp(a1["sRG"] / s_r, 0.0, 1.0))),
        jT=torch.sqrt(a2["sJP"] / s_j),
        jI=torch.arccos(torch.sqrt(torch.clamp(a1["sJG"] / s_j, 0.0,
                                               1.0))))


def render_polstat(grid, emit_map, ext_gl, bfield, odir, ra, de, centre,
                   map_dx, npix, polred=False, max_steps=100000, cell_w=None,
                   stats=None):
    """Polarization-statistics maps (POLSTAT 1 and 3) of one direction,
    both weighting families of the reference's two-pass PolMapping:

      rT = sqrt(sum(w (Psi - <Psi>)^2) / sum(w))     angle dispersion
      rI = arccos(sqrt(sum(w cos^2 gamma) / sum(w)))  mean inclination

    with w = pr rho ds (density weighting), and jT / jI the same with
    w = pr times the attenuated emission (per frequency); pr is 1, or |B|
    under `polred`. <Psi> = 0.5 atan2(sum w sin 2Psi cc, sum w cos 2Psi
    cc) from the first march. cell_w, the `threshold` mask [CELLS] 0/1,
    zeroes the density weight (not the column density). Also the
    density-weighted <|B|>, <|B_LOS|>, <|B_POS|> (POLSTAT 3), the first
    channel's optical depth and the column density of the same march.

    Returns dict: rT, rI, B, B_LOS, B_POS, tau, colden [NY, NX]; jT, jI
    [NF, NY, NX].
    """
    device = emit_map.device
    nxp, nyp = npix
    nf = emit_map.shape[1]
    pos, step_dir = _ortho_rays(grid, odir, ra, de, centre, map_dx, npix, 0,
                                nyp, device)
    ra, de, odir = (_t3(v, device) for v in (ra, de, odir))

    def geom(gidx):
        bnorm, psi, cc = _geometry(bfield[gidx], ra, de, odir,
                                   0.5 * math.pi)
        return (bnorm if polred else torch.ones_like(bnorm)), psi, cc

    def extra1(acc, gidx, raw_w):
        # LEVEL_THRESHOLD zeroes the density weight too, not only the
        # emission (kernel_ASOC_map.c:1262-1266)
        wrho = raw_w if cell_w is None else raw_w * cell_w[gidx]
        if acc is None:
            return wrho
        b = bfield[gidx]
        bnorm = _norm(b)
        blos = torch.abs((b * odir).sum(-1))
        acc["b"] = acc["b"] + wrho * bnorm
        acc["blos"] = acc["blos"] + wrho * blos
        acc["bpos"] = acc["bpos"] + wrho * torch.sqrt(
            torch.clamp_min(bnorm ** 2 - blos ** 2, 0.0))
        acc["wB"] = acc["wB"] + wrho
        acc["colden"] = acc["colden"] + raw_w
        return wrho

    zp = torch.zeros(pos.shape[0], device=device)
    a1, a2 = _polstat_marches(
        grid, emit_map, ext_gl, pos, step_dir, max_steps, geom, extra1,
        dict(b=zp, blos=zp, bpos=zp, wB=zp, colden=zp), stats)
    out = _dispersion(a1, a2)
    wb = torch.clamp_min(a1["wB"], 1e-30)
    out.update(B=a1["b"] / wb, B_LOS=a1["blos"] / wb, B_POS=a1["bpos"] / wb,
               tau=a1["tau"][:, 0], colden=a1["colden"])
    return {k: (v.T.reshape(nf, nyp, nxp) if v.ndim == 2
                else v.reshape(nyp, nxp)) for k, v in out.items()}


def render_polstat_healpix(grid, emit_map, ext_gl, bfield, intobs, nside,
                           polred=False, max_steps=100000, maxlos=1e10,
                           use_shear=False, y_shear=0.0, stats=None):
    """All-sky polarization-statistics maps around an internal observer
    (the healpix POLSTAT PolHealpixMapping, reached by polmap + polstat >
    0 + NPIX.y < 0): render_polstat's two passes along one ray per RING
    pixel from INTOBS, in each pixel's tangent basis, with Psi =
    atan2(B . RA, B . DE) (the healpix kernel's convention; the constant
    offset against the orthographic maps cancels in the dispersion). The
    last step is cut at maxlos, where the rays stop; use_shear wraps the
    X-face exits with the shearing-box shift.
    Returns dict: rT, rI [NPIX]; jT, jI [NF, NPIX] (the reference's plane
    order rhoTheta, rhoGamma, jTheta, jGamma)."""
    pos, step_dir, ra, de, odir = _sky_basis(nside, intobs, emit_map.device)

    def geom(gidx):
        bnorm, psi, cc = _geometry(bfield[gidx], ra, de, odir, None)
        return (bnorm if polred else torch.ones_like(bnorm)), psi, cc

    a1, a2 = _polstat_marches(
        grid, emit_map, ext_gl, pos, step_dir, max_steps, geom,
        lambda acc, gidx, w: None, {}, stats, maxlos=maxlos,
        shear=y_shear if use_shear else None)
    out = _dispersion(a1, a2)
    out["jT"] = out["jT"].T
    out["jI"] = out["jI"].T
    return out
