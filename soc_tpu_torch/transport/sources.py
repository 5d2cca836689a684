"""Packet source generation: the isotropic background (port of the
background part of soc_tpu.transport.sources).

A generator maps local packet ids (0..total-1 within one transport run) to
initial packet states. Every packet owns the RNG stream ``(hi, k)``: ``k``
is its index within its frequency channel and ``hi = hi_base + ifreq``
encodes (phase, iteration, frequency), so streams are unique across phases
and frequencies and independent of lane chunking.

Background weights follow the reference (SimRAM_PB SOURCE==1): packets are
stratified over the 2(NX NY + NX NZ + NY NZ) boundary elements (element =
k % AREA), enter with cosine-law directions, and carry
photons = I_bg(f) * pi / (PLANCK * f * packets_per_element).

RNG counter layout per packet: counters 0 and 1 are burned by the source,
counter 2 word 0 is the birth free path, propagation consumes 3, 4, ...
"""

import math

import numpy as np
import torch

from soc_tpu.constants import PEPS

from ..ops import traverse
from .. import rng as socrng
from .propagate import PacketBatch

BIRTH_COUNTER = 3   # first counter slot used by the propagation loop

# stream-id high-word phase tags: hi = (phase << 24) | (iteration << 16)
# + ifreq (the same table as soc_tpu, so streams coincide)
PHASES = {"bg": 1, "hpbg": 2, "ps": 3, "cell": 4, "roi": 5, "diffuse": 6,
          "split": 7, "sca_bg": 9, "sca_ps": 10, "sca_cell": 11,
          "sca_hpbg": 12}


def stream_hi_base(phase, iteration=0):
    """Host-side hi_base for a simulation phase."""
    return int(np.uint32((PHASES[phase] << 24) | ((iteration & 0xFF) << 16)))


def packet_identity(ids_local, params):
    """Map local packet ids (int64 tensor) to (k, ifreq, hi) for a
    mixed-frequency run: ids count through the frequencies in turn.

    params: 'per_freq' packets per frequency and 'hi_base' the
    phase/iteration tag; hi = hi_base + ifreq. k and hi are 32-bit words
    held in int64, as in soc_tpu_torch.rng; ids are int64, so a run of
    any size needs no chunking to keep them in 32 bits.
    """
    pf = int(params["per_freq"])
    ifreq = ids_local // pf
    k = ids_local - ifreq * pf
    hi = (ifreq + int(params["hi_base"])) & socrng.MASK32
    return k, ifreq, hi


def _unit(d):
    return d / torch.sqrt(d[:, 0:1] * d[:, 0:1] + d[:, 1:2] * d[:, 1:2]
                          + d[:, 2:3] * d[:, 2:3])


def _finish(grid, pos_global, dir, photons, ifreq, stream, hi):
    # the leaf walk records the ancestor stack as it descends, so the
    # refill step needs no PAR gathers
    pos, level, ind, anc = traverse.index_global_stack(grid, pos_global)
    return PacketBatch(
        pos=pos, dir=dir, level=level, ind=ind,
        photons=photons.to(torch.float32), ifreq=ifreq, stream=stream,
        hi=hi, counter=torch.full_like(stream, BIRTH_COUNTER),
        scatterings=torch.zeros_like(ind), anc=anc)


def gen_background(grid, ids_local, seed, params):
    """Isotropic-background packets; params: photons [NFREQ] tensor plus
    the packet_identity keys."""
    stream, ifreq, hi = packet_identity(ids_local, params)
    pos, dir = background_entry(grid.nx, grid.ny, grid.nz, stream, hi, seed)
    return _finish(grid, pos, dir, params["photons"][ifreq], ifreq,
                   stream, hi)


def background_entry(nx, ny, nz, stream, hi, seed):
    """Entry (position, direction) of isotropic-background packet
    (stream, hi) on the nx*ny*nz surface."""
    area = 2 * (ny * nz + nx * nz + nx * ny)
    return background_entry_at(nx, ny, nz, torch.remainder(stream, area),
                               stream, hi, seed)


def background_entry_at(nx, ny, nz, elem, stream, hi, seed):
    """Entry (position, direction) on a given surface element."""
    a_yz, a_xz, a_xy = ny * nz, nx * nz, nx * ny
    u1, u2, u3, u4 = socrng.uniform4(seed, stream, torch.zeros_like(stream),
                                     hi)

    # element id -> (axis, upper, tangential coords), kernel enumeration
    # order: [-X, +X, -Y, +Y, -Z, +Z] with YZ / XZ / XY tangential planes
    in_x = elem < 2 * a_yz
    in_y = ~in_x & (elem < 2 * (a_yz + a_xz))
    base = torch.where(in_x, 0, torch.where(in_y, 2 * a_yz,
                                            2 * (a_yz + a_xz)))
    block = torch.where(in_x, a_yz, torch.where(in_y, a_xz, a_xy))
    rel = elem - base
    upper = rel >= block
    r = rel - torch.where(upper, block, 0)
    nmod = torch.where(in_x, ny, nx)
    tang1 = torch.remainder(r, nmod).to(torch.float32) + u1
    tang2 = (r // nmod).to(torch.float32) + u2

    ax0 = in_x
    ax1 = in_y
    ax2 = ~in_x & ~in_y
    size_n = torch.where(ax0, nx, torch.where(ax1, ny, nz)).to(torch.float32)
    nrm = torch.where(upper, size_n - PEPS, torch.full_like(size_n, PEPS))
    px = torch.where(ax0, nrm, tang1)
    py = torch.where(ax1, nrm, torch.where(ax0, tang1, tang2))
    pz = torch.where(ax2, nrm, tang2)
    pos = torch.stack([torch.clamp(px, PEPS, nx - PEPS),
                       torch.clamp(py, PEPS, ny - PEPS),
                       torch.clamp(pz, PEPS, nz - PEPS)], -1)

    # cosine-law direction about the inward normal
    cos_theta = torch.sqrt(u3)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - u3, 0.0))
    phi = 2.0 * math.pi * u4
    v1 = sin_theta * torch.cos(phi)
    v2 = sin_theta * torch.sin(phi)
    s = torch.where(upper, -cos_theta, cos_theta)
    dx = torch.where(ax0, s, v1)
    dy = torch.where(ax1, s, torch.where(ax0, v1, v2))
    dz = torch.where(ax2, s, v2)
    dir = torch.stack([dx, dy, dz], -1)
    dir = torch.where(torch.abs(dir) < 1e-5, 1e-5, dir)
    return pos, _unit(dir)


GENERATORS = {"bg": gen_background}
