"""Orthographic maps, the reference's: rays through the hierarchy from the
observer's side, I_nu += exp(-tau) (1 - exp(-dtau)) / dtau * ds * n *
EMIT_nu * KK nu, tau += dtau = ds * n * (k_abs + k_sca), per channel, with
KK = 1e23 / FACTOR * h / (4 pi) * GL PARSEC (Jy/sr), in float64. The
observer's axes for (theta, phi) follow SOC's convention: the observer in
direction ODIR, RA to the right, DE up; a map pixel (i, j) starts at the
map centre + (i - (NX-1)/2) dx RA + (j - (NY-1)/2) dx DE."""

import math

import numpy as np
import torch

from ..frozen.constants import FACTOR, PARSEC, PLANCK
from .transport import NUDGE, exit_distance, locate


def observer_axes(theta, phi):
    b = 0.5 * math.pi - theta
    a = phi
    odir = np.asarray([math.cos(a) * math.cos(b), math.sin(a) * math.cos(b),
                       math.sin(b)])
    ra = np.asarray([-math.sin(a), math.cos(a), 0.0])
    de = np.asarray([-math.cos(a) * math.sin(b), -math.sin(a) * math.sin(b),
                     math.cos(b)])
    odir = np.where(np.abs(odir) < 1e-5, 1e-5, odir)
    return odir, ra, de


def pixel_spectra(tree, emit, ext_gl, freq, gl_pc, theta, phi, npix, dx,
                  pixels, device, dtype=torch.float64):
    """[P, NF] surface brightness of the pixels [P, 2] (column i, row j)
    of the orthographic map; emit [CELLS, NF] photons/Hz/H, ext_gl [NF];
    ``dtype`` the precision of the integral (the control's lower one)."""
    dev = torch.device(device)
    odir, ra, de = observer_axes(theta, phi)
    nx, ny = npix
    dims = np.asarray(tree["dims"], np.float64)
    centre = 0.5 * dims
    i = pixels[:, 0].astype(np.float64)
    j = pixels[:, 1].astype(np.float64)
    start = (centre[None, :] + ((i - 0.5 * (nx - 1)) * dx)[:, None] * ra
             + ((j - 0.5 * (ny - 1)) * dx)[:, None] * de)
    step = -odir
    step = np.where(np.abs(step) < 1e-5, 1e-5, step)
    step = step / np.linalg.norm(step)
    # enter the box: the slab method from far outside
    far = start + 4.0 * dims.sum() * odir[None, :]
    t0 = np.max(np.minimum((0.0 - far) / step, (dims - far) / step), 1)
    pos = torch.as_tensor(far + (t0 + NUDGE)[:, None] * step, device=dev)
    dirs = torch.as_tensor(np.broadcast_to(step, pos.shape).copy(),
                           device=dev)
    kk = 1.0e23 / FACTOR * PLANCK / (4.0 * math.pi) * gl_pc * PARSEC
    emap = torch.as_tensor(np.asarray(emit, np.float64)
                           * (kk * np.asarray(freq))[None, :],
                           device=dev).to(dtype)
    ext = torch.as_tensor(np.asarray(ext_gl, np.float64), device=dev).to(
        dtype)
    nf = len(freq)
    out = torch.zeros((len(pos), nf), dtype=dtype, device=dev)
    tau = torch.zeros_like(out)
    idx = torch.arange(len(pos), device=dev)
    while len(idx):
        g, lo, h = locate(tree, pos)
        ds = exit_distance(pos, dirs, lo, h)
        col = (ds * tree["dens"][g]).to(dtype)[:, None]
        dtau = col * ext[None, :]
        att = torch.where(dtau > 1e-12, -torch.expm1(-dtau)
                          / torch.clamp_min(dtau, 1e-30), 1.0 - 0.5 * dtau)
        out[idx] += torch.exp(-tau[idx]) * att * col * emap[g]
        tau[idx] += dtau
        pos = pos + (ds + NUDGE)[:, None] * dirs
        keep = ((pos >= 0.0) & (pos < tree["n"])).all(1)
        pos, dirs, idx = pos[keep], dirs[keep], idx[keep]
    return out.to(torch.float64).cpu().numpy()
