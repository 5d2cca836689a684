"""HEALPix RING-scheme pixelization (port of soc_tpu.render.healpix):
the directions of the Healpix-sky background, of PS_METHOD 3's
pixel-weighted point sources, of ROI packets and of all-sky maps, and the
pixel of a direction for the ROI crossing tally.

``pix2ang_ring`` and ``ang2pix_ring`` run in torch on the packets' device;
``pix2ang_ring_np`` and ``ang2pix_ring_np`` are their NumPy twins for host
tables. All compute in float32 step for step as soc_tpu does (integer
pixel arithmetic, float32 square roots and floors), so phi matches
soc_tpu's bit for bit and theta to an ulp of arccos; a direction within an
ulp of a pixel edge may land in the neighbouring pixel where XLA's cos
differs from torch's by an ulp. Angles: theta the colatitude in [0, pi],
phi the longitude.
"""

import math

import numpy as np
import torch


def npix(nside):
    return 12 * nside * nside


def pix2ang_ring(nside, ipix):
    """RING pixel index (int64 tensor) -> (theta, phi) float32 tensors."""
    total = npix(nside)
    nl2 = 2 * nside
    nl4 = 4 * nside
    ncap = nl2 * (nside - 1)
    ip1 = ipix.to(torch.int64) + 1
    fact1 = 1.5 * nside
    fact2 = 3.0 * nside * nside

    # north polar cap
    hip = ip1 / 2.0
    fihip = torch.floor(hip)
    iring_n = torch.floor(torch.sqrt(hip - torch.sqrt(fihip))).to(
        torch.int64) + 1
    iphi_n = ip1 - 2 * iring_n * (iring_n - 1)
    z_n = 1.0 - (iring_n * iring_n) / fact2
    phi_n = (iphi_n - 0.5) * math.pi / (2.0 * iring_n)

    # equatorial belt (floored // and % as jnp's)
    ipe = ip1 - ncap - 1
    iring_e = ipe // nl4 + nside
    iphi_e = torch.remainder(ipe, nl4) + 1
    fodd = 0.5 * (1 + torch.remainder(iring_e + nside, 2))
    z_e = (nl2 - iring_e) / fact1
    phi_e = (iphi_e - fodd) * math.pi / nl2

    # south polar cap
    ip_s = total - ip1 + 1
    hip_s = ip_s / 2.0
    fihip_s = torch.floor(hip_s)
    iring_s = torch.floor(torch.sqrt(hip_s - torch.sqrt(fihip_s))).to(
        torch.int64) + 1
    iphi_s = 4 * iring_s + 1 - (ip_s - 2 * iring_s * (iring_s - 1))
    z_s = -1.0 + (iring_s * iring_s) / fact2
    phi_s = (iphi_s - 0.5) * math.pi / (2.0 * iring_s)

    north = ip1 <= ncap
    south = ip1 > (total - ncap)
    z = torch.where(north, z_n, torch.where(south, z_s, z_e))
    phi = torch.where(north, phi_n, torch.where(south, phi_s, phi_e))
    theta = torch.acos(torch.clamp(z, -1.0, 1.0))
    return theta, phi


def pix2ang_ring_np(nside, ipix):
    """pix2ang_ring in NumPy float32, for host tables."""
    f32 = np.float32
    total = npix(nside)
    nl2 = 2 * nside
    nl4 = 4 * nside
    ncap = nl2 * (nside - 1)
    ip1 = np.asarray(ipix, np.int32) + np.int32(1)
    fact1 = f32(1.5 * nside)
    fact2 = f32(3.0 * nside * nside)
    pi = f32(np.pi)

    hip = ip1.astype(f32) / f32(2.0)
    fihip = np.floor(hip)
    iring_n = np.floor(np.sqrt(hip - np.sqrt(fihip))).astype(np.int32) + 1
    iphi_n = ip1 - 2 * iring_n * (iring_n - 1)
    z_n = f32(1.0) - (iring_n * iring_n).astype(f32) / fact2
    phi_n = (iphi_n.astype(f32) - f32(0.5)) * pi \
        / (f32(2.0) * iring_n.astype(f32))

    ipe = ip1 - ncap - 1
    iring_e = ipe // nl4 + nside
    iphi_e = ipe % nl4 + 1
    fodd = f32(0.5) * (1 + ((iring_e + nside) % 2)).astype(f32)
    z_e = (nl2 - iring_e).astype(f32) / fact1
    phi_e = (iphi_e.astype(f32) - fodd) * pi / f32(nl2)

    ip_s = total - ip1 + 1
    hip_s = ip_s.astype(f32) / f32(2.0)
    fihip_s = np.floor(hip_s)
    iring_s = np.floor(np.sqrt(hip_s - np.sqrt(fihip_s))).astype(
        np.int32) + 1
    iphi_s = 4 * iring_s + 1 - (ip_s - 2 * iring_s * (iring_s - 1))
    z_s = f32(-1.0) + (iring_s * iring_s).astype(f32) / fact2
    phi_s = (iphi_s.astype(f32) - f32(0.5)) * pi \
        / (f32(2.0) * iring_s.astype(f32))

    north = ip1 <= ncap
    south = ip1 > (total - ncap)
    z = np.where(north, z_n, np.where(south, z_s, z_e)).astype(f32)
    phi = np.where(north, phi_n, np.where(south, phi_s, phi_e)).astype(f32)
    # arccos correctly rounded to float32 (XLA's own differs from it by
    # an ulp on some pixels, as torch's does)
    theta = np.arccos(np.clip(z, f32(-1.0), f32(1.0)).astype(np.float64))
    return theta.astype(f32), phi


def ang2pix_ring(nside, theta, phi):
    """(theta, phi) float32 tensors -> RING pixel index (int64 tensor)."""
    z = torch.cos(theta)
    za = torch.abs(z)
    phi = torch.remainder(phi, 2.0 * math.pi)
    tt = phi / (0.5 * math.pi)                  # in [0, 4)
    nl2 = 2 * nside
    nl4 = 4 * nside
    ncap = nl2 * (nside - 1)
    total = npix(nside)

    # equatorial region
    jp_e = torch.floor(nside * (0.5 + tt - z * 0.75)).to(torch.int64)
    jm_e = torch.floor(nside * (0.5 + tt + z * 0.75)).to(torch.int64)
    ir_e = nside + 1 + jp_e - jm_e              # in {1, 2n+1}
    kshift = torch.where(torch.remainder(ir_e, 2) == 0, 1, 0)
    ip_e = (jp_e + jm_e - nside + kshift + 1) // 2 + 1
    ip_e = torch.where(ip_e > nl4, ip_e - nl4, ip_e)
    pix_e = ncap + nl4 * (ir_e - 1) + ip_e

    # polar caps
    tp = tt - torch.floor(tt)
    tmp = torch.sqrt(3.0 * (1.0 - za))
    jp_p = torch.floor(nside * tp * tmp).to(torch.int64)
    jm_p = torch.floor(nside * (1.0 - tp) * tmp).to(torch.int64)
    ir_p = jp_p + jm_p + 1
    ip_p = torch.floor(tt * ir_p).to(torch.int64) + 1
    ip_p = torch.where(ip_p > 4 * ir_p, ip_p - 4 * ir_p, ip_p)
    pix_n = 2 * ir_p * (ir_p - 1) + ip_p
    pix_s = total - 2 * ir_p * (ir_p + 1) + ip_p
    pix_p = torch.where(z > 0, pix_n, pix_s)

    pix = torch.where(za <= 2.0 / 3.0, pix_e, pix_p)
    return pix - 1


def ang2pix_ring_np(nside, theta, phi):
    """ang2pix_ring in NumPy float32, for host tables."""
    f32 = np.float32
    theta = np.asarray(theta, f32)
    z = np.cos(theta)
    za = np.abs(z)
    phi = np.mod(np.asarray(phi, f32), f32(2.0 * np.pi))
    tt = phi / f32(0.5 * np.pi)
    nl2 = 2 * nside
    nl4 = 4 * nside
    ncap = nl2 * (nside - 1)
    total = npix(nside)
    n = f32(nside)

    jp_e = np.floor(n * (f32(0.5) + tt - z * f32(0.75))).astype(np.int64)
    jm_e = np.floor(n * (f32(0.5) + tt + z * f32(0.75))).astype(np.int64)
    ir_e = nside + 1 + jp_e - jm_e
    kshift = np.where(ir_e % 2 == 0, 1, 0)
    ip_e = (jp_e + jm_e - nside + kshift + 1) // 2 + 1
    ip_e = np.where(ip_e > nl4, ip_e - nl4, ip_e)
    pix_e = ncap + nl4 * (ir_e - 1) + ip_e

    tp = tt - np.floor(tt)
    tmp = np.sqrt(f32(3.0) * (f32(1.0) - za))
    jp_p = np.floor(n * tp * tmp).astype(np.int64)
    jm_p = np.floor(n * (f32(1.0) - tp) * tmp).astype(np.int64)
    ir_p = jp_p + jm_p + 1
    ip_p = np.floor(tt * ir_p.astype(f32)).astype(np.int64) + 1
    ip_p = np.where(ip_p > 4 * ir_p, ip_p - 4 * ir_p, ip_p)
    pix_n = 2 * ir_p * (ir_p - 1) + ip_p
    pix_s = total - 2 * ir_p * (ir_p + 1) + ip_p
    pix_p = np.where(z > 0, pix_n, pix_s)
    pix = np.where(za <= f32(2.0 / 3.0), pix_e, pix_p)
    return pix - 1
