"""Scattered-light imaging with peel-off (port of soc_tpu.render.scattered,
the ASOCS workload).

Packets propagate without absorption tallies (absorption attenuates the
packet at each scattering as exp(-free_path k_abs / k_sca),
kernel_ASOC_sca.c:290-300); at every scattering a deterministic ray is
peeled off toward each observer:

    OUT[ifreq, idir, pix] += PHOTONS * exp(-tau_LOS) * DSC(cos theta)

with forced first scattering (FFS) at packet birth: the entry chord's
scattering depth tau gives the weight W = 1 - exp(-tau) and the forced
scattering point, sampled in the same pass (the single-pass reservoir,
_reservoir_update).

Two engines, as in soc_tpu:
  * the phase engine (spawn, propagate_events, peel_off,
    peel_off_healpix): soc_tpu's library API and the cross-check of the
    unified engine;
  * the unified engine (sca_run, peel_off_run, driven by
    simulate_scattering): lane-refill loops on the host, in the style of
    transport.propagate.transport_run: a body is a refill and SCA_PERIOD
    march steps, a service step before every SERVICE_PERIOD of them (soc_
    tpu's service_period), queued on the device; the host checks for live
    lanes and the event count every few bodies. A lane frozen at a
    scattering waits for the next service, so the service cadence sets a
    pool's drain tail (a packet scatters up to MAX_SCATTERINGS times); a
    packet's path does not depend on it (one draw a scattering at its
    counter).

The port runs one mixed-frequency pool a source: lanes carry their channel
(``ifreq``), and the cross sections and phase functions are tables gathered
per lane: physics 'kabs', 'ksca' [NFREQ], 'csc', 'dsc' [NFREQ, BINS]; under
WITH_MSF 'msf_csc' [NDUST, NFREQ, BINS], 'msf_dsc' [NFREQ, NDUST, BINS],
'msf_sca' [NFREQ, NDUST] and 'msf_abu' [CELLS, NDUST]. A run of one channel
(``ifreq`` in the source parameters) is the same pool with every lane on
that channel. Packet identities (sources.packet_identity) give each packet
soc_tpu's stream, so it takes the path it takes in soc_tpu's per-channel
run; the maps are [NFREQ, NDIR, NY, NX] (or [NFREQ, NPIX]) and differ from
the sum of per-channel runs only in the order of the atomic adds.

The event buffer is [capacity + lanes, 10] float32 rows: pos3 | dir3 |
photons | level | ind | ifreq, the three ints bit-cast (Tensor.view). A
lane that appends no event writes a spare row past ``capacity``; the host
ends a transport round before the buffer could overflow, and an append
beyond ``capacity`` is counted and raises, so no event is dropped.
Deposits are index_add_ into a flat map with one spare slot a lane past
its end for lanes that add nothing (a dead lane, an off-map pixel: soc_tpu
drops those out of bounds).
"""

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import MAX_SCATTERINGS, PEPS
from ..ops import traverse
from ..transport.propagate import PacketBatch, _csc_lookup, _deflect, drain
from .. import rng as socrng

# Peel-off rays and FFS chords stop once the accumulated optical depth
# exceeds this: exp(-30) ~ 9e-14, below the float32 resolution of any map
# pixel. The reference marches to the surface unconditionally
# (kernel_ASOC_sca.c:310-412); the truncation changes results by a bounded
# < 1e-13 relative amount while skipping the optically dead tail of every
# sightline in thick models.
TAU_PEEL_CUT = 30.0
SCA_PERIOD = 32     # march steps a body (one refill each)
SERVICE_PERIOD = 8  # march steps between the transport's services
CHECK_EVERY = 4     # bodies between host checks (at most)
FP_FAR = 1.0e30     # a stage-0 (FFS) lane's free path: it never scatters
EVENT_COLS = 10


@dataclass
class ScatterEvents:
    """Event buffer rows [E] (E = capacity)."""

    pos: torch.Tensor        # [E, 3] level-local position of the scattering
    level: torch.Tensor      # [E] int64
    ind: torch.Tensor        # [E] int64
    dir: torch.Tensor        # [E, 3] packet direction at the scattering
    photons: torch.Tensor    # [E]
    ifreq: torch.Tensor      # [E] int64 channel
    valid: torch.Tensor      # [E] bool


def _max_steps(grid):
    """A bound no straight ray can exceed: a diagonal crossing at the
    deepest refinement plus slack (soc_tpu's default)."""
    return 8 * (grid.nx + grid.ny + grid.nz) * (1 << (grid.levels - 1)) \
        + 1024


def _dens(grid, level, ind):
    return grid.dens[traverse._gidx(grid, level, ind.clamp_min(0))]


def _march_tau(grid, pos, level, ind, dir, ext, active, max_steps=None,
               max_dist=None, tau_cut=None):
    """Vectorised LOS march to the surface accumulating ext optical depth
    (ext per ray, or a scalar). max_dist (per ray, GL units) stops the
    march at the observer; tau_cut ends rays whose attenuation is already
    numerically zero. Returns (tau, exit_pos). The host checks for live
    rays every CHECK_EVERY steps: steps on dead rays change nothing."""
    if max_steps is None:
        max_steps = _max_steps(grid)
    n = pos.shape[0]
    device = pos.device
    left = torch.full((n,), math.inf, dtype=torch.float32, device=device) \
        if max_dist is None else torch.as_tensor(max_dist,
                                                 dtype=torch.float32,
                                                 device=device)
    ind = torch.where(active, ind, -1)
    tau = torch.zeros(n, dtype=torch.float32, device=device)
    anc = traverse.stack_from_par(grid, level, ind)
    it = 0
    while it < max_steps:
        if it % CHECK_EVERY == 0 and not bool((ind >= 0).any()):
            break
        live = ind >= 0
        dens = _dens(grid, level, ind)
        ds, npos, nlevel, nind, anc = traverse.get_step_stack(
            grid, pos, dir, level, ind, anc, live)
        failed = live & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, dir, failed)
        w = torch.minimum(ds, left)
        tau = tau + torch.where(live, w * dens * ext, 0.0)
        left = torch.where(live, left - w, left)
        nind = torch.where(left <= 0.0, -1, nind)
        if tau_cut is not None:
            nind = torch.where(tau > tau_cut, -1, nind)
        pos, level, ind = npos, nlevel, nind
        it += 1
    return tau, pos


def _mul32(a, c):
    """(a * c) mod 2^32 for 32-bit words held in int64: the product is
    formed in 16-bit halves so that no partial product reaches 2^63."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & socrng.MASK32


def _ffs_hash2(seed, stream, hi, k):
    """Two deterministic uniforms in [0, 1) for the reservoir FFS: a
    murmur3-style integer finaliser of (seed, stream id, segment index),
    bit for bit soc_tpu's uint32 arithmetic on int64-held words.
    Selection-only randomness: the FFS weight and the segment
    probabilities stay exact, the hash only picks which segment wins."""
    m = socrng.MASK32
    x = (socrng.u32(stream, stream) ^ _mul32(socrng.u32(hi, stream),
                                             0x9E3779B9)
         ^ _mul32(socrng.u32(k, stream), 0x85EBCA6B)
         ^ (int(seed) & m))
    a = x ^ (x >> 16)
    a = _mul32(a, 0x7FEB352D)
    a = a ^ (a >> 15)
    a = _mul32(a, 0x846CA68B)
    a = a ^ (a >> 16)
    c = _mul32(a, 0x9E3779B9)
    c = c ^ (c >> 16)
    scale = 1.0 / (1 << 24)
    return ((a >> 8).to(torch.float32) * scale,
            (c >> 8).to(torch.float32) * scale)


def _reservoir_update(ksca, seed, stream, hi, rk, pos, dir, level, ind,
                      dens, tau, dtau, update, res):
    """One segment of the single-pass FFS reservoir: with A_k = 1 -
    exp(-tau_k) the running unnormalised CDF, segment k replaces the
    candidate with probability (A_k - A_{k-1}) / A_k (division-free: u1
    a_new < a_new - A), and the offset within the segment is the truncated
    exponential -log1p(-v (1 - exp(-dtau))). res: dict(pos, level, ind,
    tau, A), the candidate and the running CDF."""
    a_new = -torch.expm1(-(tau + dtau))
    u1, u2 = _ffs_hash2(seed, stream, hi, rk)
    rep = update & (u1 * a_new < a_new - res["A"])
    t_in = -torch.log1p(-u2 * (-torch.expm1(-dtau)))
    dxl = torch.clamp_min(
        t_in / torch.clamp_min(ksca * dens, 1e-30)
        * torch.exp2(level.to(torch.float32)) - 2.0 * PEPS, 0.0)
    return {
        "pos": torch.where(rep[:, None], pos + dxl[:, None] * dir,
                           res["pos"]),
        "level": torch.where(rep, level, res["level"]),
        "ind": torch.where(rep, ind, res["ind"]),
        "tau": torch.where(rep, tau + t_in, res["tau"]),
        "A": torch.where(update, a_new, res["A"]),
    }


def _march_ffs(grid, ksca, seed, pos, level, ind, dir, stream, hi,
               max_steps=None):
    """Single-pass forced-first-scattering chord march: the total
    scattering depth and the reservoir-sampled scattering point in one
    sweep (ksca per ray or a scalar). Returns (w, cand_pos, cand_level,
    cand_ind, cand_tau)."""
    if max_steps is None:
        max_steps = _max_steps(grid)
    n = pos.shape[0]
    device = pos.device
    zf = torch.zeros(n, dtype=torch.float32, device=device)
    res = dict(pos=pos, level=level, ind=ind, tau=zf, A=zf)
    ind0 = ind
    tau = zf
    rk = torch.zeros(n, dtype=torch.int64, device=device)
    anc = traverse.stack_from_par(grid, level, ind)
    it = 0
    while it < max_steps:
        if it % CHECK_EVERY == 0 and not bool((ind >= 0).any()):
            break
        live = ind >= 0
        dens = _dens(grid, level, ind)
        ds, npos, nlevel, nind, anc = traverse.get_step_stack(
            grid, pos, dir, level, ind, anc, live)
        failed = live & (nlevel == level) & (nind == ind)
        npos = traverse.failed_step_nudge(npos, dir, failed)
        dtau = torch.where(live, ds * dens * ksca, 0.0)
        res = _reservoir_update(ksca, seed, stream, hi, rk, pos, dir, level,
                                ind, dens, tau, dtau, live, res)
        tau = tau + dtau
        rk = rk + live.to(torch.int64)
        nind = torch.where(tau > TAU_PEEL_CUT, -1, nind)
        pos, level, ind = npos, nlevel, nind
        it += 1
    # dead-at-birth lanes never updated: keep their ind at -1
    cind = torch.where(ind0 >= 0, res["ind"], -1)
    return res["A"], res["pos"], res["level"], cind, res["tau"]


def _lane_k(physics, ifreq):
    """(kabs, ksca) of each lane's channel."""
    return physics["kabs"][ifreq], physics["ksca"][ifreq]


def _generator(kind):
    from ..transport.sources import GENERATORS
    return GENERATORS[kind]


def spawn(grid, physics, source_params, total_packets, next_id, seed,
          source_kind="bg", nlanes=1 << 14, ffs=True):
    """Phase A: a full pool of fresh packets; with ffs each is frozen at
    its forced scattering point (pending) with its weight times w and the
    absorption attenuation to the scattering depth. Returns (b, free_path,
    pending, next_id)."""
    device = grid.device
    ids = next_id + torch.arange(nlanes, device=device)
    can = ids < total_packets
    b = _generator(source_kind)(grid, torch.where(can, ids, 0), int(seed),
                                source_params)
    ind = torch.where(can, b.ind, -1)
    photons = b.photons
    kabs, ksca = _lane_k(physics, b.ifreq)
    if ffs:
        w, cpos, clevel, cind, ctau = _march_ffs(
            grid, ksca, seed, b.pos, b.level, ind, b.dir, b.stream, b.hi)
        photons = photons * w * torch.exp(-ctau * kabs
                                          / torch.clamp_min(ksca, 1e-30))
        ind = torch.where(w < 1.0e-22, -1, cind)
        pos, level = cpos, clevel
        pending = ind >= 0
        scat = pending.to(torch.int64)
        free_path = torch.zeros(nlanes, dtype=torch.float32, device=device)
    else:
        u = socrng.uniform1(int(seed), b.stream,
                            torch.full_like(b.stream, 2), b.hi)
        free_path = -torch.log(u)
        pos, level = b.pos, b.level
        pending = torch.zeros(nlanes, dtype=torch.bool, device=device)
        scat = b.scatterings
    b = PacketBatch(pos=pos, dir=b.dir, level=level, ind=ind,
                    photons=photons, ifreq=b.ifreq, stream=b.stream,
                    hi=b.hi, counter=b.counter + 1, scatterings=scat,
                    e_cell=b.e_cell, anc=traverse.stack_from_par(
                        grid, level, ind))
    return b, free_path, pending, next_id + nlanes


def _as_f(x):
    return x.to(torch.int32).view(torch.float32)


def _as_i(x):
    return x.contiguous().view(torch.int32).to(torch.int64)


def _pack_event_rows(pos, dir, photons, level, ind, ifreq):
    """One packed event row per lane: pos3 | dir3 | photons | level | ind |
    ifreq, the ints bit-cast to float32 (the event buffer's wire
    format)."""
    return torch.cat([pos, dir, photons[:, None], _as_f(level)[:, None],
                      _as_f(ind)[:, None], _as_f(ifreq)[:, None]], 1)


def _unpack_events(evbuf, ecount, capacity):
    """Inverse of _pack_event_rows over the buffer's first ``capacity``
    rows; rows at or past ecount are not valid."""
    ev = evbuf[:capacity]
    return ScatterEvents(
        pos=ev[:, 0:3], dir=ev[:, 3:6], photons=ev[:, 6],
        level=_as_i(ev[:, 7]), ind=_as_i(ev[:, 8]), ifreq=_as_i(ev[:, 9]),
        valid=torch.arange(capacity, device=ev.device) < ecount)


def empty_events(capacity, device, nlanes=0):
    """A zeroed event buffer [capacity + nlanes, EVENT_COLS] (the spare
    rows past capacity take the appends of lanes with no event)."""
    return torch.zeros((capacity + nlanes, EVENT_COLS), dtype=torch.float32,
                       device=device)


def _service_scatter(grid, physics, seed, capacity, b, act, evbuf, ecount,
                     free_path, tau, dropped):
    """The scattering service shared by propagate_events and sca_run: for
    the act lanes (frozen at their scattering point) append the peel-off
    event, draw the new direction (under WITH_MSF the species roulette
    ~ ABU[cell] SCA_d at the lane's channel, then that species' CSC), kill
    lanes that reached the scattering cap after this final event and reset
    the free path. One uniform4 a scattering, at the packet's counter.
    evbuf [capacity + lanes, 10] is written in place; ``dropped``, a
    device count, takes appends past capacity (never, when the caller
    sizes its rounds). Returns (ecount, dir, ind, counter, free_path,
    tau)."""
    nlanes = b.lanes
    sc = act.to(torch.int64)
    rank = torch.cumsum(sc, 0) - sc
    slot = ecount + rank
    fits = act & (slot < capacity)
    dropped += (act & ~fits).sum()
    lanes = torch.arange(nlanes, device=act.device)
    rows = _pack_event_rows(b.pos, b.dir, b.photons, b.level, b.ind,
                            b.ifreq)
    evbuf.index_copy_(0, torch.where(fits, slot, capacity + lanes), rows)
    ecount = ecount + sc.sum()

    u_bin, u_phi, u_fp, u_sp = socrng.uniform4(int(seed), b.stream,
                                               b.counter, b.hi)
    if "msf_csc" in physics:
        gidx = traverse._gidx(grid, b.level, b.ind.clamp_min(0))
        msf_csc = physics["msf_csc"]               # [NDUST, NFREQ, BINS]
        bins = msf_csc.shape[-1]
        cdf = torch.cumsum(physics["msf_abu"][gidx]
                           * physics["msf_sca"][b.ifreq], 1)
        r = 0.99999 * u_sp * cdf[:, -1]
        species = (cdf < r[:, None]).sum(1).clamp(0, msf_csc.shape[0] - 1)
        bin_idx = (u_bin * bins).to(torch.int64).clamp(0, bins - 1)
        cos_theta = msf_csc[species, b.ifreq, bin_idx]
    else:
        csc = physics["csc"]
        cos_theta = _csc_lookup(csc, b.ifreq, u_bin, csc.shape[-1])
    new_dir = torch.where(act[:, None],
                          _deflect(b.dir, cos_theta, (2.0 * math.pi) * u_phi),
                          b.dir)
    over = act & (b.scatterings >= MAX_SCATTERINGS)
    ind = torch.where(over, -1, b.ind)
    counter = b.counter + act.to(torch.int64)
    free_path = torch.where(act, -torch.log(u_fp), free_path)
    tau = torch.where(act, 0.0, tau)
    return ecount, new_dir, ind, counter, free_path, tau


def propagate_events(grid, physics, b, free_path, tau, pending, evbuf,
                     ecount, seed, capacity=1 << 16, max_iters=1 << 20,
                     service_period=4):
    """Phase B: step the pool, appending scattering events into evbuf
    ([capacity + lanes, 10], from empty_events) in place, until the pool
    is dead or the buffer cannot hold another full-pool round of events.
    The march freezes lanes whose free path ends (pending); a service pass
    every service_period steps appends and redirects them. (tau, pending)
    persist across calls: flush the buffer and call again with the same
    pool. Returns (b, free_path, tau, pending, events, ecount)."""
    nlanes = b.lanes
    device = grid.device
    ecount = torch.as_tensor(ecount, dtype=torch.int64, device=device)
    dropped = torch.zeros((), dtype=torch.int64, device=device)
    kabs, ksca = _lane_k(physics, b.ifreq)
    anc = traverse.stack_from_par(grid, b.level, b.ind)
    it = 0
    while it < max_iters:
        alive, ec = (b.ind >= 0).any(), ecount
        if not bool(alive) or int(ec) + nlanes > capacity:
            break
        # service: b.dir is still the incoming direction
        act = pending & (b.ind >= 0)
        ecount, dirx, ind, counter, free_path, tau = _service_scatter(
            grid, physics, seed, capacity, b, act, evbuf, ecount,
            free_path, tau, dropped)
        b = PacketBatch(pos=b.pos, dir=dirx, level=b.level, ind=ind,
                        photons=b.photons, ifreq=b.ifreq, stream=b.stream,
                        hi=b.hi, counter=counter, scatterings=b.scatterings,
                        e_cell=b.e_cell, anc=anc)
        pending = pending & ~act
        for _ in range(service_period):
            alive = b.ind >= 0
            active = alive & ~pending
            dens = _dens(grid, b.level, b.ind)
            ds_local, pos_boundary = traverse.boundary_step(b.pos, b.dir)
            ds_gl = ds_local * torch.exp2(-b.level.to(torch.float32))
            dtau_sca = ds_gl * dens * ksca
            scatter_now = active & (free_path < tau + dtau_sca)
            dx_gl = (free_path - tau) / torch.clamp_min(ksca * dens, 1e-30)
            dx_local = torch.clamp_min(
                dx_gl * torch.exp2(b.level.to(torch.float32)) - 2.0 * PEPS,
                0.0)
            pos_scatter = b.pos + dx_local[:, None] * b.dir
            photons = torch.where(
                scatter_now,
                b.photons * torch.exp(-free_path * kabs
                                      / torch.clamp_min(ksca, 1e-30)),
                b.photons)
            posx = torch.where(active[:, None], pos_boundary, b.pos)
            cross = active & ~scatter_now
            npos, nlevel, nind, anc = traverse.index_update_stack(
                grid, posx, b.level, b.ind, anc, cross)
            failed = cross & (nlevel == b.level) & (nind == b.ind)
            npos = traverse.failed_step_nudge(npos, b.dir, failed)
            pos = torch.where(scatter_now[:, None], pos_scatter, npos)
            level = torch.where(scatter_now, b.level, nlevel)
            ind = torch.where(scatter_now, b.ind, nind)
            pending = pending | scatter_now
            tau = torch.where(scatter_now, free_path,
                              torch.where(cross, tau + dtau_sca, tau))
            b = PacketBatch(pos=pos, dir=b.dir, level=level, ind=ind,
                            photons=photons, ifreq=b.ifreq, stream=b.stream,
                            hi=b.hi, counter=b.counter,
                            scatterings=b.scatterings
                            + scatter_now.to(torch.int64),
                            e_cell=b.e_cell, anc=anc)
        it += 1
    if int(dropped):
        raise RuntimeError("propagate_events: %d events did not fit the "
                           "buffer" % int(dropped))
    ecount = int(ecount)
    return (b, free_path, tau, pending,
            _unpack_events(evbuf, ecount, capacity), ecount)


def _dsc_value(physics, gidx, ifreq, cos_theta):
    """Phase-function value for a peel-off ray at the lane's channel.
    Under WITH_MSF the abundance-weighted mean DSC of the scattering cell
    (the expectation of the reference's random species, kernel_ASOC_sca.c
    :340-348: the same mean with less variance), as soc_tpu does."""
    if "msf_dsc" in physics:
        msf_dsc = physics["msf_dsc"]             # [NFREQ, NDUST, BINS]
        nd, bins = msf_dsc.shape[1:]
        bin_idx = ((1.0 + cos_theta) * 0.5 * bins).to(torch.int64).clamp(
            0, bins - 1)
        w = physics["msf_abu"][gidx] * physics["msf_sca"][ifreq]
        vals = msf_dsc[ifreq[:, None],
                       torch.arange(nd, device=gidx.device)[None, :],
                       bin_idx[:, None]]
        return (w * vals).sum(1) / torch.clamp_min(w.sum(1), 1e-30)
    dsc = physics["dsc"]
    bins = dsc.shape[-1]
    bin_idx = ((1.0 + cos_theta) * 0.5 * bins).to(torch.int64).clamp(
        0, bins - 1)
    return dsc[ifreq, bin_idx]


def _event_dsc(grid, physics, events, cos_theta):
    gidx = traverse._gidx(grid, events.level, events.ind.clamp_min(0))
    return _dsc_value(physics, gidx, events.ifreq, cos_theta)


def _deposit(out, nmap, flat, ok, delta, spare):
    """out[flat] += delta where ok; the others add 0.0 at their spare
    slot past nmap."""
    out.index_add_(0, torch.where(ok, flat, nmap + spare),
                   torch.where(ok, delta, 0.0))


def peel_off(grid, physics, events, odirs, ra, de, centre, map_dx, npix,
             out):
    """Phase C: a deterministic ray from each event to each observer;
    out [NFREQ, NDIR, NY, NX] accumulated scattered surface brightness
    (returned, a new tensor)."""
    nxp, nyp = npix
    device = grid.device
    odirs = torch.as_tensor(np.atleast_2d(odirs), dtype=torch.float32,
                            device=device)
    ra = torch.as_tensor(np.atleast_2d(ra), dtype=torch.float32,
                         device=device)
    de = torch.as_tensor(np.atleast_2d(de), dtype=torch.float32,
                         device=device)
    centre = torch.as_tensor(np.asarray(centre, np.float32), device=device)
    ndir = odirs.shape[0]
    nmap = out.numel()
    n = events.pos.shape[0]
    flat_out = torch.cat([out.reshape(-1),
                          torch.zeros(n, dtype=torch.float32,
                                      device=device)])
    kabs, ksca = _lane_k(physics, events.ifreq)
    spare = torch.arange(n, device=device)
    for idir in range(ndir):
        odir = odirs[idir]
        tau, exit_pos = _march_tau(
            grid, events.pos, events.level, events.ind,
            odir.expand(n, 3), kabs + ksca, events.valid,
            tau_cut=TAU_PEEL_CUT)
        cos_theta = torch.clamp((events.dir * odir[None, :]).sum(-1),
                                -0.9999, 0.9999)
        delta = events.photons * torch.exp(-tau) \
            * _event_dsc(grid, physics, events, cos_theta)
        rel = exit_pos - centre[None, :]
        i = (0.5 * nxp - 0.00005) + (rel * ra[idir][None, :]).sum(-1) \
            / map_dx
        j = (0.5 * nyp - 0.00005) + (rel * de[idir][None, :]).sum(-1) \
            / map_dx
        ii = torch.floor(i).to(torch.int64)
        jj = torch.floor(j).to(torch.int64)
        ok = events.valid & (ii >= 0) & (jj >= 0) & (ii < nxp) & (jj < nyp)
        flat = ((events.ifreq * ndir + idir) * nyp + jj) * nxp + ii
        _deposit(flat_out, nmap, flat, ok, delta, spare)
    return flat_out[:nmap].reshape(out.shape)


def _ang_pix(nside, rdir):
    """The Healpix pixel the observer sees a ray along rdir arrive from
    (the arrival direction is -rdir)."""
    from .healpix import ang2pix_ring
    theta = torch.acos(torch.clamp(-rdir[:, 2], -1.0, 1.0))
    phi = torch.atan2(rdir[:, 1], rdir[:, 0])
    return ang2pix_ring(nside, theta, phi)


def _toward(grid, obs_pos, pos, level, ind):
    """(direction, distance) from each event to the observer: the unit
    vector with |components| < 1e-5 set to 1e-5, not renormalised, as
    soc_tpu does."""
    rp = traverse.root_pos(grid, pos, level, ind)
    vec = obs_pos[None, :] - rp
    dist = torch.sqrt((vec * vec).sum(-1))
    odir = vec / torch.clamp_min(dist, 1e-6)[:, None]
    return torch.where(torch.abs(odir) < 1e-5, 1e-5, odir), dist


def peel_off_healpix(grid, physics, events, obs_pos, nside, out):
    """Healpix peel-off for an internal observer (kernel_ASOC_sca.c NDIR<0
    branch): from each event one ray toward the observer, delta = PHOTONS
    exp(-tau) DSC / d^2 binned by the arrival direction's pixel.
    out [NFREQ, 12 nside^2]; returns the new sum."""
    device = grid.device
    obs_pos = torch.as_tensor(np.asarray(obs_pos, np.float32), device=device)
    odir, dist = _toward(grid, obs_pos, events.pos, events.level,
                         events.ind)
    kabs, ksca = _lane_k(physics, events.ifreq)
    tau, _ = _march_tau(grid, events.pos, events.level, events.ind, odir,
                        kabs + ksca, events.valid, max_dist=dist,
                        tau_cut=TAU_PEEL_CUT)
    cos_theta = torch.clamp((events.dir * odir).sum(-1), -0.9999, 0.9999)
    delta = (events.photons * torch.exp(-tau)
             * _event_dsc(grid, physics, events, cos_theta)
             / torch.clamp_min(dist * dist, 1e-6))
    npx = out.shape[-1]
    n = events.pos.shape[0]
    nmap = out.numel()
    flat_out = torch.cat([out.reshape(-1),
                          torch.zeros(n, dtype=torch.float32,
                                      device=device)])
    flat = events.ifreq * npx + _ang_pix(nside, odir)
    _deposit(flat_out, nmap, flat, events.valid, delta,
             torch.arange(n, device=device))
    return flat_out[:nmap].reshape(out.shape)


class ScaPool:
    """The unified transport's persistent lane pool (sca_pool_init's state)
    and its loop (sca_run): a body refills dead lanes from the budget,
    serves the frozen lanes (the FFS reset, then the scattering service)
    and marches SCA_PERIOD steps. Stage 0 (ffs): the reservoir march along
    the entry chord, frozen at the far boundary or where tau + dtau >
    TAU_PEEL_CUT; the next service jumps the lane to its candidate,
    applies w exp(-rtau kabs / max(ksca, 1e-30)) (killing the lane below
    w 1e-22) and appends the forced event in the same pass. Stage 1: the
    flight. Descent is deferred: a lane on a link cell spends a step
    descending one level."""

    def __init__(self, grid, physics, source_params, total_packets, seed,
                 source_kind="bg", nlanes=1 << 14, ffs=True,
                 capacity=1 << 20):
        # a lane appends at most one event a service
        self.spb = SCA_PERIOD // SERVICE_PERIOD
        if nlanes * self.spb > capacity:
            raise ValueError("event capacity %d cannot hold one body of "
                             "events (%d lanes x %d services)"
                             % (capacity, nlanes, self.spb))
        device = grid.device
        self.grid, self.physics = grid, physics
        self.params = source_params
        self.total = int(total_packets)
        self.seed = int(seed)
        self.gen = _generator(source_kind)
        self.nlanes, self.ffs, self.capacity = nlanes, ffs, capacity
        # bodies between checks: a group of them can append at most
        # group * spb * nlanes events
        self.group = max(1, min(CHECK_EVERY, capacity // (nlanes * self.spb)))
        n = nlanes
        z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
        zi = torch.zeros(n, dtype=torch.int64, device=device)
        zf = torch.zeros(n, dtype=torch.float32, device=device)
        self.b = PacketBatch(
            pos=z3, dir=z3 + (1.0 / math.sqrt(3.0)), level=zi,
            ind=torch.full((n,), -1, dtype=torch.int64, device=device),
            photons=zf, ifreq=zi, stream=zi, hi=zi, counter=zi,
            scatterings=zi, e_cell=torch.full((n,), -1, dtype=torch.int64,
                                              device=device),
            anc=torch.zeros((n, max(grid.levels - 1, 1)),
                            dtype=torch.int64, device=device))
        self.stage = torch.ones(n, dtype=torch.int64, device=device)
        self.rpos, self.rlevel = z3, zi
        self.rind = torch.full((n,), -1, dtype=torch.int64, device=device)
        self.rtau, self.rA, self.rk = zf, zf, zi
        self.free_path, self.tau = zf, zf
        self.pend_s = torch.zeros(n, dtype=torch.bool, device=device)
        self.pend_r = self.pend_s
        self.next_id = torch.zeros((), dtype=torch.int64, device=device)
        self.evbuf = empty_events(capacity, device, n)
        self.ecount = torch.zeros((), dtype=torch.int64, device=device)
        self.dropped = torch.zeros((), dtype=torch.int64, device=device)
        self.iters = 0
        self.done = self.total == 0

    def _refill(self):
        b, grid = self.b, self.grid
        dead = b.ind < 0
        deadi = dead.to(torch.int64)
        rank = torch.cumsum(deadi, 0) - deadi
        new_id = self.next_id + rank
        can = dead & (new_id < self.total)
        nb = self.gen(grid, torch.where(can, new_id, 0), self.seed,
                      self.params)
        canl = can[:, None]
        self.b = PacketBatch(
            pos=torch.where(canl, nb.pos, b.pos),
            dir=torch.where(canl, nb.dir, b.dir),
            level=torch.where(can, nb.level, b.level),
            ind=torch.where(can, nb.ind, b.ind),
            photons=torch.where(can, nb.photons, b.photons),
            ifreq=torch.where(can, nb.ifreq, b.ifreq),
            stream=torch.where(can, nb.stream, b.stream),
            hi=torch.where(can, nb.hi, b.hi),
            counter=torch.where(can, nb.counter + 1, b.counter),
            scatterings=torch.where(can, 0, b.scatterings),
            e_cell=torch.where(can, nb.e_cell, b.e_cell),
            anc=torch.where(canl, nb.anc, b.anc) if grid.levels > 1
            else b.anc)
        if self.ffs:
            fp_new = FP_FAR
        else:
            fp_new = -torch.log(socrng.uniform1(
                self.seed, nb.stream, torch.full_like(nb.stream, 2), nb.hi))
        self.stage = torch.where(can, 0 if self.ffs else 1, self.stage)
        self.rind = torch.where(can, -1, self.rind)
        self.rtau = torch.where(can, 0.0, self.rtau)
        self.rA = torch.where(can, 0.0, self.rA)
        self.rk = torch.where(can, 0, self.rk)
        self.free_path = torch.where(can, fp_new, self.free_path)
        self.tau = torch.where(can, 0.0, self.tau)
        self.pend_s = self.pend_s & ~can
        self.pend_r = self.pend_r & ~can
        self.next_id = self.next_id + can.sum()

    def _service(self, kabs, ksca):
        b, grid = self.b, self.grid
        # ---- the FFS resets first: jump to the candidate, apply w and the
        # absorption to the scattering depth; the forced event appends in
        # the same pass
        actr = self.pend_r & (b.ind >= 0)
        w = self.rA
        die = w < 1.0e-22
        pos = torch.where(actr[:, None], self.rpos, b.pos)
        level = torch.where(actr, self.rlevel, b.level)
        ind = torch.where(actr, torch.where(die, -1, self.rind), b.ind)
        photons = torch.where(
            actr, b.photons * w * torch.exp(-self.rtau * kabs
                                            / torch.clamp_min(ksca, 1e-30)),
            b.photons)
        forced = actr & ~die
        scat = torch.where(forced, b.scatterings + 1, b.scatterings)
        self.stage = torch.where(actr, 1, self.stage)
        anc = b.anc
        if grid.levels > 1:
            anc = torch.where(actr[:, None],
                              traverse.stack_from_par(grid, level, ind), anc)
        b = PacketBatch(pos=pos, dir=b.dir, level=level, ind=ind,
                        photons=photons, ifreq=b.ifreq, stream=b.stream,
                        hi=b.hi, counter=b.counter, scatterings=scat,
                        e_cell=b.e_cell, anc=anc)
        # ---- the scattering events, the forced ones included
        act = (self.pend_s | forced) & (b.ind >= 0)
        self.ecount, dirx, ind, counter, self.free_path, self.tau = \
            _service_scatter(grid, self.physics, self.seed, self.capacity,
                             b, act, self.evbuf, self.ecount,
                             self.free_path, self.tau, self.dropped)
        self.b = PacketBatch(pos=b.pos, dir=dirx, level=b.level, ind=ind,
                             photons=b.photons, ifreq=b.ifreq,
                             stream=b.stream, hi=b.hi, counter=counter,
                             scatterings=b.scatterings, e_cell=b.e_cell,
                             anc=b.anc)
        self.pend_s = (self.pend_s | forced) & ~act
        self.pend_r = self.pend_r & ~actr

    def _march(self, kabs, ksca):
        b, grid = self.b, self.grid
        stage, free_path, tau = self.stage, self.free_path, self.tau
        alive = b.ind >= 0
        active = alive & ~self.pend_s & ~self.pend_r
        dens = _dens(grid, b.level, b.ind)
        if grid.levels > 1:
            is_link = active & (dens <= 0.0)
            active = active & ~is_link
        ds_local, pos_boundary = traverse.boundary_step(b.pos, b.dir)
        ds_gl = ds_local * torch.exp2(-b.level.to(torch.float32))
        dtau_sca = ds_gl * dens * ksca
        scatter_now = active & (stage == 1) & (free_path < tau + dtau_sca)

        # ---- stage 0: the reservoir, segment index rk as in _march_ffs
        stage0 = active & (stage == 0)
        res = _reservoir_update(
            ksca, self.seed, b.stream, b.hi, self.rk, b.pos, b.dir, b.level,
            b.ind, dens, tau, torch.where(stage0, dtau_sca, 0.0), stage0,
            dict(pos=self.rpos, level=self.rlevel, ind=self.rind,
                 tau=self.rtau, A=self.rA))
        self.rk = self.rk + stage0.to(torch.int64)

        dx_gl = (free_path - tau) / torch.clamp_min(ksca * dens, 1e-30)
        dx_local = torch.clamp_min(
            dx_gl * torch.exp2(b.level.to(torch.float32)) - 2.0 * PEPS, 0.0)
        pos_scatter = b.pos + dx_local[:, None] * b.dir
        photons = torch.where(
            scatter_now,
            b.photons * torch.exp(-free_path * kabs
                                  / torch.clamp_min(ksca, 1e-30)),
            b.photons)

        cross = active & ~scatter_now
        posx = torch.where(cross[:, None], pos_boundary, b.pos)
        npos, nlevel, nind, anc = traverse.index_update_stack(
            grid, posx, b.level, b.ind, b.anc, cross, descend=False)
        failed = cross & (nlevel == b.level) & (nind == b.ind)
        npos = traverse.failed_step_nudge(npos, b.dir, failed)

        # stage-0 lanes at the far boundary, or past TAU_PEEL_CUT, freeze
        # for the FFS reset
        exit0 = (cross & (stage == 0)
                 & ((nind < 0) | (tau + dtau_sca > TAU_PEEL_CUT)))
        apply = cross & ~exit0
        pos = torch.where(scatter_now[:, None], pos_scatter,
                          torch.where(apply[:, None], npos, b.pos))
        level = torch.where(apply, nlevel, b.level)
        ind = torch.where(apply, nind, b.ind)
        if grid.levels > 1:
            pos, level, ind, anc = traverse.descend_one(
                grid, pos, level, ind, anc, dens, is_link)
        self.tau = torch.where(scatter_now, free_path,
                               torch.where(cross, tau + dtau_sca, tau))
        self.b = PacketBatch(pos=pos, dir=b.dir, level=level, ind=ind,
                             photons=photons, ifreq=b.ifreq, stream=b.stream,
                             hi=b.hi, counter=b.counter,
                             scatterings=b.scatterings
                             + scatter_now.to(torch.int64),
                             e_cell=b.e_cell, anc=anc)
        self.rpos, self.rlevel, self.rind = res["pos"], res["level"], \
            res["ind"]
        self.rtau, self.rA = res["tau"], res["A"]
        self.pend_s = self.pend_s | scatter_now
        self.pend_r = self.pend_r | exit0

    def body(self):
        self._refill()
        kabs, ksca = _lane_k(self.physics, self.b.ifreq)
        for _ in range(self.spb):
            self._service(kabs, ksca)
            for _ in range(SERVICE_PERIOD):
                self._march(kabs, ksca)
        self.iters += 1

    def round(self):
        """sca_run as a generator: bodies until the pool is dead and the
        budget spent, or the buffer cannot take another group of bodies;
        yields after each body. Returns the round's event count (the
        buffer's rows [0, ecount)); start the next round with
        ``flush()``."""
        nb = self.nlanes * self.spb
        while not self.done:
            for _ in range(self.group):
                self.body()
                yield
            more, ec = torch.stack([
                ((self.b.ind >= 0).any() | (self.next_id < self.total))
                .to(torch.int64), self.ecount]).tolist()
            if not more:
                self.done = True
            elif ec + self.group * nb > self.capacity:
                break
        if int(self.dropped):
            raise RuntimeError("sca_run: %d scattering events did not fit "
                               "the buffer" % int(self.dropped))
        return int(self.ecount)

    def events(self, ecount):
        return _unpack_events(self.evbuf, ecount, self.capacity)

    def flush(self):
        self.ecount = torch.zeros_like(self.ecount)


def sca_pool_init(grid, physics, source_params, total_packets, seed,
                  source_kind="bg", nlanes=1 << 14, ffs=True,
                  capacity=1 << 20):
    """A fresh (all-dead) persistent pool for sca_run."""
    return ScaPool(grid, physics, source_params, total_packets, seed,
                   source_kind, nlanes, ffs, capacity)


def sca_run(pool):
    """Unified scattered-light transport: one round of the pool's lane
    refill loop (spawn, FFS and flight in one loop). Returns (events,
    ecount); flush the pool (pool.flush()) and call again until
    pool.done."""
    ecount = drain(pool.round())
    return pool.events(ecount), ecount


class PeelOff:
    """peel_off_run's ray pool: a persistent lane pool drained from the
    (event x observer) work list; exited rays deposit and are refilled at
    once. mode "ortho": work item (event, idir), a ray along odirs[idir],
    deposited at the exit position's projection into [NFREQ, NDIR, NY,
    NX]; "healpix": one ray an event toward obs_pos, stopped at the
    observer, deposited by arrival direction into [NFREQ, 12 nside^2].
    The rays' nudge after a failed step is PEPS along the ray."""

    def __init__(self, grid, physics, out_shape, odirs=None, ra=None,
                 de=None, centre=None, map_dx=1.0, obs_pos=None,
                 nlanes=1 << 14):
        device = grid.device
        self.grid, self.physics = grid, physics
        self.healpix = obs_pos is not None
        self.out_shape = tuple(out_shape)
        self.nmap = int(np.prod(out_shape))
        self.nlanes = n = nlanes
        self.out = torch.zeros(self.nmap + n, dtype=torch.float32,
                               device=device)
        self.spare = torch.arange(n, device=device)

        def t(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)
        if self.healpix:
            self.ndir = 1
            self.nside = int(round(math.sqrt(out_shape[-1] // 12)))
            self.obs_pos = t(obs_pos)
        else:
            self.odirs = t(np.atleast_2d(odirs))
            self.ra, self.de = t(np.atleast_2d(ra)), t(np.atleast_2d(de))
            self.centre, self.map_dx = t(centre), float(map_dx)
            self.ndir = self.odirs.shape[0]
        z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
        zi = torch.zeros(n, dtype=torch.int64, device=device)
        zf = torch.zeros(n, dtype=torch.float32, device=device)
        self.c = dict(pos=z3, level=zi,
                      ind=torch.full((n,), -1, dtype=torch.int64,
                                     device=device),
                      rdir=z3 + 1.0, evdir=z3, ph=zf, egidx=zi, eifreq=zi,
                      ext=zf,
                      eidx=torch.full((n,), -1, dtype=torch.int64,
                                      device=device),
                      idir=zi, tau=zf, dist=zf, left=zf)
        self.deposited = torch.zeros((), dtype=torch.int64, device=device)
        self.iters = 0

    def _deposit(self):
        c = self.c
        has = (c["ind"] < 0) & (c["eidx"] >= 0)
        cos_theta = torch.clamp((c["evdir"] * c["rdir"]).sum(-1), -0.9999,
                                0.9999)
        delta = c["ph"] * torch.exp(-c["tau"]) \
            * _dsc_value(self.physics, c["egidx"], c["eifreq"], cos_theta)
        if self.healpix:
            delta = delta / torch.clamp_min(c["dist"] * c["dist"], 1e-6)
            flat = c["eifreq"] * self.out_shape[-1] \
                + _ang_pix(self.nside, c["rdir"])
            ok = has
        else:
            nyp, nxp = self.out_shape[-2:]
            rel = c["pos"] - self.centre[None, :]
            i = (0.5 * nxp - 0.00005) \
                + (rel * self.ra[c["idir"]]).sum(-1) / self.map_dx
            j = (0.5 * nyp - 0.00005) \
                + (rel * self.de[c["idir"]]).sum(-1) / self.map_dx
            ii = torch.floor(i).to(torch.int64)
            jj = torch.floor(j).to(torch.int64)
            ok = has & (ii >= 0) & (jj >= 0) & (ii < nxp) & (jj < nyp)
            flat = ((c["eifreq"] * self.ndir + c["idir"]) * nyp + jj) * nxp \
                + ii
        _deposit(self.out, self.nmap, flat, ok, delta, self.spare)
        self.deposited += has.sum()
        c["eidx"] = torch.where(has, -1, c["eidx"])

    def _refill(self, events, total_work, nxt):
        c, grid = self.c, self.grid
        dead = c["ind"] < 0
        deadi = dead.to(torch.int64)
        rank = torch.cumsum(deadi, 0) - deadi
        wid = nxt + rank
        can = dead & (wid < total_work)
        widc = torch.where(can, wid, 0)
        ei = widc // self.ndir
        di = torch.remainder(widc, self.ndir)
        epos, elvl, eind = events.pos[ei], events.level[ei], events.ind[ei]
        eif = events.ifreq[ei]
        egidx = traverse._gidx(grid, elvl, eind.clamp_min(0))
        if self.healpix:
            rdir_new, dist = _toward(grid, self.obs_pos, epos, elvl, eind)
        else:
            rdir_new = self.odirs[di]
            dist = torch.full_like(c["tau"], math.inf)
        kabs, ksca = _lane_k(self.physics, eif)
        canl = can[:, None]
        c.update(pos=torch.where(canl, epos, c["pos"]),
                 level=torch.where(can, elvl, c["level"]),
                 ind=torch.where(can, eind, c["ind"]),
                 rdir=torch.where(canl, rdir_new, c["rdir"]),
                 evdir=torch.where(canl, events.dir[ei], c["evdir"]),
                 ph=torch.where(can, events.photons[ei], c["ph"]),
                 egidx=torch.where(can, egidx, c["egidx"]),
                 eifreq=torch.where(can, eif, c["eifreq"]),
                 ext=torch.where(can, kabs + ksca, c["ext"]),
                 eidx=torch.where(can, ei, c["eidx"]),
                 idir=torch.where(can, di, c["idir"]),
                 tau=torch.where(can, 0.0, c["tau"]),
                 dist=torch.where(can, dist, c["dist"]),
                 left=torch.where(can, dist, c["left"]))
        return nxt + can.sum()

    def _march(self, anc):
        c, grid = self.c, self.grid
        live = c["ind"] >= 0
        dens = _dens(grid, c["level"], c["ind"])
        if grid.levels > 1:
            is_link = live & (dens <= 0.0)
            step_ok = live & ~is_link
        else:
            step_ok = live
        ds_local, pos_b = traverse.boundary_step(c["pos"], c["rdir"])
        ds = ds_local * torch.exp2(-c["level"].to(torch.float32))
        posx = torch.where(step_ok[:, None], pos_b, c["pos"])
        npos, nlevel, nind, anc = traverse.index_update_stack(
            grid, posx, c["level"], c["ind"], anc, step_ok, descend=False)
        failed = step_ok & (nlevel == c["level"]) & (nind == c["ind"])
        npos = torch.where(failed[:, None], npos + PEPS * c["rdir"], npos)
        w = torch.minimum(ds, c["left"])
        tau = c["tau"] + torch.where(step_ok, w * dens * c["ext"], 0.0)
        left = torch.where(step_ok, c["left"] - w, c["left"])
        nind = torch.where(step_ok & (left <= 0.0), -1, nind)
        # optically dead rays stop early (TAU_PEEL_CUT)
        nind = torch.where(tau > TAU_PEEL_CUT, -1, nind)
        if grid.levels > 1:
            npos, nlevel, nind, anc = traverse.descend_one(
                grid, npos, nlevel, nind, anc, dens, is_link)
        c.update(pos=npos, level=nlevel, ind=nind, tau=tau, left=left)
        return anc

    def run(self, events, ecount):
        """peel_off_run as a generator over one round's events (yields
        after each body): every (event, observer) ray marched and
        deposited. Returns the bodies run."""
        total_work = int(ecount) * self.ndir
        nxt = torch.zeros((), dtype=torch.int64, device=self.out.device)
        bodies = 0
        while True:
            for _ in range(CHECK_EVERY):
                self._deposit()
                nxt = self._refill(events, total_work, nxt)
                anc = traverse.stack_from_par(self.grid, self.c["level"],
                                              self.c["ind"])
                for _ in range(SCA_PERIOD):
                    anc = self._march(anc)
                bodies += 1
                yield
            more = ((self.c["ind"] >= 0).any() | (nxt < total_work))
            if not bool(more):
                break
        self._deposit()                 # the final flush
        self.iters += bodies
        return bodies

    def result(self):
        return self.out[:self.nmap].reshape(self.out_shape)


def peel_off_run(grid, physics, events, ecount, out_shape, odirs=None,
                 ra=None, de=None, centre=None, map_dx=1.0, obs_pos=None,
                 nlanes=1 << 14):
    """Peel-off of one buffer of events as a lane-refill march (see
    PeelOff); returns (map [out_shape], bodies)."""
    peel = PeelOff(grid, physics, out_shape, odirs, ra, de, centre, map_dx,
                   obs_pos, nlanes)
    bodies = drain(peel.run(events, ecount))
    return peel.result(), bodies


def out_shape_of(nfreq, npix=None, ndir=1, healpix_nside=0):
    """The map shape of a run: [NFREQ, 12 nside^2] (Healpix) or [NFREQ,
    NDIR, NY, NX]."""
    if healpix_nside > 0:
        return (nfreq, 12 * healpix_nside * healpix_nside)
    return (nfreq, ndir, npix[1], npix[0])


def scattering_steps(grid, physics, source_params, total_packets, odirs, ra,
                     de, centre, map_dx, npix, seed, source_kind="bg",
                     nlanes=1 << 14, ffs=True, capacity=1 << 20,
                     healpix_nside=0, obs_pos=None):
    """simulate_scattering as a generator (yielding after each body of
    either loop), so one host thread can step the pools of several devices
    in turn (ProductMesh.map_steps); returns (map, stats)."""
    t0 = time.time()
    nfreq = physics["kabs"].shape[0]
    healpix = healpix_nside > 0
    ndir = 1 if healpix else np.atleast_2d(odirs).shape[0]
    shape = out_shape_of(nfreq, npix, ndir, healpix_nside)
    pool = ScaPool(grid, physics, source_params, total_packets, seed,
                   source_kind, nlanes, ffs, capacity)
    if healpix:
        peel = PeelOff(grid, physics, shape, obs_pos=obs_pos,
                       nlanes=nlanes)
    else:
        peel = PeelOff(grid, physics, shape, odirs, ra, de, centre, map_dx,
                       nlanes=nlanes)
    events = 0
    while not pool.done:
        ecount = yield from pool.round()
        events += ecount
        if ecount:
            yield from peel.run(pool.events(ecount), ecount)
        pool.flush()
    rays = int(peel.deposited)
    if rays != events * peel.ndir:
        raise RuntimeError("peel-off deposited %d rays for %d events x %d "
                           "observers" % (rays, events, peel.ndir))
    stats = dict(sca_iters=pool.iters, peel_iters=peel.iters,
                 lane_steps=pool.iters * SCA_PERIOD * nlanes,
                 peel_lane_steps=peel.iters * SCA_PERIOD * nlanes,
                 events=events, rays=rays, packets=int(total_packets),
                 seconds=time.time() - t0)
    return peel.result(), stats


def simulate_scattering(grid, physics, source_params, total_packets, odirs,
                        ra, de, centre, map_dx, npix, seed,
                        source_kind="bg", nlanes=1 << 14, ffs=True,
                        capacity=1 << 20, healpix_nside=0, obs_pos=None,
                        return_stats=False):
    """Scattered light of one source: the maps [NFREQ, NDIR, NY, NX], or
    with healpix_nside > 0 and obs_pos (the internal observer, ASOCS.py
    :43-49) [NFREQ, 12 nside^2], on the grid's device; NFREQ is the
    physics tables'. The transport (sca_run) and the peel-off
    (peel_off_run) alternate, the host flushing the event buffer between
    rounds. return_stats adds {sca_iters, peel_iters, lane_steps,
    peel_lane_steps, events, rays, packets, seconds}: the lane-march steps
    the two pools ran (bodies x SCA_PERIOD x lanes), the events buffered
    and the peel-off rays deposited (events x observers: none is
    dropped)."""
    out, stats = drain(scattering_steps(
        grid, physics, source_params, total_packets, odirs, ra, de, centre,
        map_dx, npix, seed, source_kind, nlanes, ffs, capacity,
        healpix_nside, obs_pos))
    return (out, stats) if return_stats else out


def simulate_scattering_sharded(pm, grid, physics, source_params,
                                total_packets, odirs, ra, de, centre, map_dx,
                                npix, seed, source_kind="bg", nlanes=1 << 14,
                                ffs=True, capacity=1 << 20, healpix_nside=0,
                                obs_pos=None, return_stats=False):
    """`devices N` scattered light over the ProductMesh pm's devices
    (soc_tpu's simulate_scattering_sharded): the budget splits by global id
    range, shard dp taking q + (dp < r) of it (q, r = divmod(total, N))
    from within-channel index k0 = dp q + min(dp, r) (plus any k0 in the
    parameters), so every packet keeps its stream; a mixed pool splits
    each channel's ``per_freq``. Each shard runs its own pool on its
    device (grid and physics copied there once), the shards stepped in
    turn; the maps are summed on the first device in shard order. Over
    several processes (pm spans them: parallel/dist.py) a process steps
    only its own shards, every process gathers every shard's map and
    stats (ProductMesh.gather_shards) and adds the maps in shard order on
    the grid's device, as one process adds them: every process holds the
    one-process sum, on the CPU bit for bit. Returns the map (and the
    shards' stats summed)."""
    n = len(pm.devices)
    mixed = source_params.get("ifreq") is None
    total = int(source_params["per_freq"]) if mixed else int(total_packets)
    nsel = int(total_packets) // total if mixed and total else 1
    q, r = divmod(total, n)
    k0 = int(source_params.get("k0", 0))

    def shard(i, dev):
        mine = q + int(i < r)
        params = {k: v.to(dev) if torch.is_tensor(v) else v
                  for k, v in source_params.items()}
        params["k0"] = k0 + i * q + min(i, r)
        if mixed:
            params["per_freq"] = mine
        phys = {k: v.to(dev) for k, v in physics.items()}
        return (yield from scattering_steps(
            pm.replica(grid, dev), phys, params, mine * nsel, odirs, ra, de,
            centre, map_dx, npix, seed, source_kind, nlanes, ffs, capacity,
            healpix_nside, obs_pos))

    parts = pm.map_steps(shard)
    maps = pm.gather_shards([None if p is None else p[0] for p in parts])
    first = pm.lead(grid.device)
    out = maps[0].to(first)
    for part in maps[1:]:
        out = out + part.to(first)
    if not return_stats:
        return out
    stats = pm.gather_shards([None if p is None else p[1] for p in parts])
    return out, {k: sum(s[k] for s in stats) for k in stats[0]}
