"""HEALPix RING-scheme pixel centres (port of pix2ang_ring of
soc_tpu.render.healpix): the directions of the Healpix-sky background and
of PS_METHOD 3's pixel-weighted point sources.

``pix2ang_ring`` runs in torch on the packets' device; ``pix2ang_ring_np``
is its NumPy twin for host tables (healpix_visibility). Both compute in
float32 step for step as soc_tpu does (integer pixel arithmetic, float32
square roots), so phi matches soc_tpu's bit for bit and theta to an ulp
of arccos. Angles: theta the colatitude in [0, pi], phi the
longitude.
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
