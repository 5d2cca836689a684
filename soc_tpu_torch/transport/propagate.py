"""Photon-packet propagation: the hot loop (port of
soc_tpu.transport.propagate, mixed-frequency background form).

A fixed pool of packet lanes is stepped in eager PyTorch. Each *march*
step advances every live lane by one event (a cell-boundary crossing or the
arrival at a scattering point); lanes whose free path ends freeze there
(``pending``) and a *service* step draws the new direction and free path
for all of them at once. Every REFILL_PERIOD steps, lanes that died are
refilled with fresh packets from the remaining budget through an exclusive
prefix sum over dead lanes. A packet's random numbers are keyed by
(stream, counter), so neither the service delay nor the lane count changes
any packet's path.

The loop condition of soc_tpu's ``lax.while_loop`` is a host check here,
made every CHECK_EVERY refill bodies: extra bodies on an empty pool do
nothing, and fewer checks mean fewer device-to-host synchronisations.

Tallies are ``index_add_`` scatter-adds. soc_tpu drops inactive lanes by
scattering them to an out-of-bounds index; torch raises on the CPU and
asserts on the device for that. Here an inactive lane adds 0.0 into a cell
of its own (lane % CELLS), which changes no tally and, unlike one shared
dump slot, does not make every dead lane's atomic add on the card wait on
the same address. On the card ``index_add_`` adds with atomics in an order
that changes from run to run: tallies of two runs with the same seed agree
to rounding there, and bit for bit on the CPU.

Physics per step (kernel_ASOC.c semantics):
  * step to the next cell boundary; tau_abs = ds*n*k_abs, tau_sca = ds*n*k_sca
  * if the scattering free path ends inside the step: move there, deposit
    the partial absorption and freeze for service; stop after
    MAX_SCATTERINGS
  * else deposit photons*(1-exp(-tau_abs)) (Taylor below TAULIM),
    attenuate, accumulate tau, cross into the next cell
  * failed steps are recovered by a PEPS-scaled nudge
"""

import math
from dataclasses import dataclass, replace

import torch

from soc_tpu.constants import (ADHOC, DEPS, MAX_SCATTERINGS, PEPS,
                               PHOTON_LIMIT, TAULIM)

from ..ops import traverse
from .. import rng as socrng

ESC_SPREAD = 1024   # escape-tally slots per frequency (see transport_run)
REFILL_PERIOD = 16  # march steps between refills (one service step each)
CHECK_EVERY = 4     # refill bodies between host checks for live lanes


@dataclass
class PacketBatch:
    """Structure-of-arrays packet state; all tensors share the lane axis."""

    pos: torch.Tensor          # [N, 3] float32 level-local coordinates
    dir: torch.Tensor          # [N, 3] float32 unit direction
    level: torch.Tensor        # [N] int64 hierarchy level
    ind: torch.Tensor          # [N] int64 level-local cell index, -1 dead
    photons: torch.Tensor      # [N] float32 photon weight
    ifreq: torch.Tensor        # [N] int64 frequency channel
    stream: torch.Tensor       # [N] int64-held uint32 stream id, low word
    hi: torch.Tensor           # [N] int64-held uint32 stream id, high word
    counter: torch.Tensor      # [N] int64 RNG draw counter
    scatterings: torch.Tensor  # [N] int64
    anc: torch.Tensor = None   # [N, max(levels-1, 1)] ancestor stack

    @property
    def lanes(self):
        return self.pos.shape[0]


def _cross(a, b):
    """3-vector cross product, component formulas as in jnp.cross."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _norm(v):
    return torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                      + v[..., 2:3] * v[..., 2:3])


def _deflect(dir, cos_theta, phi):
    """Rotate unit vectors by theta around a uniform azimuth."""
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    ax = torch.abs(dir[..., 0])
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dir.dtype, device=dir.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dir.dtype, device=dir.device)
    helper = torch.where((ax < 0.9)[..., None], ex, ey)
    t1 = _cross(dir, helper)
    t1 = t1 / _norm(t1)
    t2 = _cross(dir, t1)
    new = (cos_theta[..., None] * dir
           + (sin_theta * torch.cos(phi))[..., None] * t1
           + (sin_theta * torch.sin(phi))[..., None] * t2)
    new = torch.where(torch.abs(new) < DEPS, DEPS, new)
    return new / _norm(new)


def _csc_lookup(csc_table, ifreq, u_bin, bins):
    """cos(theta) from the [NFREQ, BINS] inverse-CDF table."""
    bin_idx = (u_bin * bins).to(torch.int64).clamp(0, bins - 1)
    return csc_table[ifreq, bin_idx]


def make_dead(n, levels, device):
    """A fully dead packet batch of n lanes."""
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
    zi = torch.zeros(n, dtype=torch.int64, device=device)
    return PacketBatch(
        pos=z3, dir=z3 + (1.0 / math.sqrt(3.0)), level=zi,
        ind=torch.full((n,), -1, dtype=torch.int64, device=device),
        photons=torch.zeros(n, dtype=torch.float32, device=device),
        ifreq=zi, stream=zi, hi=zi, counter=zi, scatterings=zi,
        anc=torch.zeros((n, max(levels - 1, 1)), dtype=torch.int64,
                        device=device))


@dataclass
class PoolState:
    """Per-lane loop state besides the packets, plus the tallies
    (tabs [CELLS], intf [CELLS*NFREQ] flat, updated in place)."""

    b: PacketBatch
    pending: torch.Tensor      # [N] bool: frozen at a scattering point
    free_path: torch.Tensor    # [N] float32 optical depth to next scatter
    tau: torch.Tensor          # [N] float32 scattering depth accumulated
    esc_pending: torch.Tensor  # [N] float32 escaped weight not yet flushed
    tabs: torch.Tensor
    intf: torch.Tensor
    absd: torch.Tensor         # () float32 total deposited
    spare_cell: torch.Tensor   # [N] lane % CELLS: where inactive lanes add 0


class StepKit:
    """The march/service physics of transport_run over a PoolState.

    physics: dict with 'kabs', 'ksca', 'tw' [NFREQ] and 'csc'
    [NFREQ, BINS]. Packets keep their frequency for life, so the per-lane
    cross sections are gathered once per refill (``lane_const_of``)
    rather than once per step."""

    def __init__(self, grid, physics, seed, per_freq_tally):
        csc = physics["csc"]
        if csc.ndim != 2 or physics["kabs"].ndim != 1:
            raise NotImplementedError(
                "uniform-frequency transport (scalar cross sections); the "
                "port runs the mixed-frequency pool")
        self.grid = grid
        self.physics = physics
        self.seed = int(seed)
        self.per_freq_tally = per_freq_tally
        self.bins = csc.shape[-1]
        self.nfreq = csc.shape[0]

    def lane_const_of(self, b):
        p = self.physics
        return p["kabs"][b.ifreq], p["ksca"][b.ifreq], p["tw"][b.ifreq]

    def draw_birth_fp(self, stream, hi):
        # birth free path: counter slot 2, first word
        u = socrng.uniform1(self.seed, stream, torch.full_like(stream, 2), hi)
        return -torch.log(u)

    def service(self, st):
        """Serve pending scattering events: one RNG evaluation, the
        phase-function lookup and the deflection for every frozen lane."""
        b = st.b
        act = st.pending & (b.ind >= 0)
        u_fp, u_bin, u_phi = socrng.step_uniforms(self.seed, b.stream,
                                                  b.counter, b.hi)
        cos_theta = _csc_lookup(self.physics["csc"], b.ifreq, u_bin,
                                self.bins)
        new_dir = _deflect(b.dir, cos_theta, (2.0 * math.pi) * u_phi)
        fp_next = -torch.log(u_fp)
        st.b = replace(b, dir=torch.where(act[..., None], new_dir, b.dir),
                       counter=b.counter + act.to(torch.int64))
        st.free_path = torch.where(act, fp_next, st.free_path)
        st.tau = torch.where(act, 0.0, st.tau)
        st.pending = st.pending & ~act

    def march(self, st, lane_c):
        """One event for every active lane (see the module docstring)."""
        grid = self.grid
        cells = grid.cells
        b = st.b
        alive = b.ind >= 0
        active = alive & ~st.pending           # frozen lanes await service
        gidx = traverse._gidx(grid, b.level, b.ind.clamp_min(0))
        dens = grid.dens[gidx]
        # deferred descent: a lane may sit on a refined (link) cell; the
        # density gather doubles as the link test and such a lane spends
        # this step descending one level instead of marching
        if grid.levels > 1:
            is_link = active & (dens <= 0.0)
            active = active & ~is_link
        kabs, ksca, tw = lane_c

        # ---- geometric step to next boundary
        ds_local, pos_boundary = traverse.boundary_step(b.pos, b.dir)
        ds_gl = ds_local * torch.exp2(-b.level.to(torch.float32))
        tau_abs_full = ds_gl * dens * kabs
        dtau_sca = ds_gl * dens * ksca
        scatter_now = active & (st.free_path < st.tau + dtau_sca)

        # ---- scattering point inside this cell
        dx_gl = (st.free_path - st.tau) / torch.clamp_min(ksca * dens, 1e-30)
        tau_abs_part = dx_gl * dens * kabs
        dx_local = torch.clamp_min(
            dx_gl * torch.exp2(b.level.to(torch.float32)) - 2.0 * PEPS, 0.0)
        pos_scatter = b.pos + dx_local[..., None] * b.dir

        # ---- absorption deposit (inactive lanes add 0 into a spare cell)
        tau_abs = torch.where(scatter_now, tau_abs_part, tau_abs_full)
        att = torch.exp(-tau_abs)
        delta = torch.where(tau_abs > TAULIM,
                            b.photons * (1.0 - att),
                            b.photons * tau_abs * (1.0 - 0.5 * tau_abs))
        didx = torch.where(active, gidx, st.spare_cell)
        dep = torch.where(active, delta, 0.0)
        st.tabs.index_add_(0, didx, dep * tw * ADHOC)
        if self.per_freq_tally:
            st.intf.index_add_(0, didx * self.nfreq + b.ifreq, dep)
        st.absd = st.absd + dep.sum()
        photons = torch.where(active, b.photons * att, b.photons)

        # ---- crossing branch: move into the next cell
        posx = torch.where(active[..., None], pos_boundary, b.pos)
        cross = active & ~scatter_now
        npos, nlevel, nind, anc = traverse.index_update_stack(
            grid, posx, b.level, b.ind, b.anc, cross, descend=False)
        failed = cross & (nlevel == b.level) & (nind == b.ind)
        npos = traverse.failed_step_nudge(npos, b.dir, failed)
        exited = cross & (nind < 0)

        # ---- merge: scattering lanes freeze at the scattering point
        pos = torch.where(scatter_now[..., None], pos_scatter, npos)
        level = torch.where(scatter_now, b.level, nlevel)
        ind = torch.where(scatter_now, b.ind, nind)
        if grid.levels > 1:
            pos, level, ind, anc = traverse.descend_one(
                grid, pos, level, ind, anc, dens, is_link)

        scat = b.scatterings + scatter_now.to(torch.int64)
        overscattered = scatter_now & (scat > MAX_SCATTERINGS)
        # magnitude test: negative-weight packets keep propagating
        exhausted = active & (torch.abs(photons) < PHOTON_LIMIT)
        st.esc_pending = st.esc_pending + torch.where(
            (exited | overscattered) & active, photons, 0.0)
        ind = torch.where(overscattered | exhausted, -1, ind)
        st.tau = torch.where(scatter_now, 0.0,
                             torch.where(cross, st.tau + dtau_sca, st.tau))
        st.pending = (st.pending | scatter_now) & (ind >= 0)
        st.b = replace(b, pos=pos, level=level, ind=ind, photons=photons,
                       scatterings=scat, anc=anc)


def new_pool(nlanes, grid, tabs, intf):
    """A pool of dead lanes adding into tabs [CELLS] and intf
    [CELLS, NFREQ] (in place)."""
    device = grid.device
    zf = torch.zeros(nlanes, dtype=torch.float32, device=device)
    return PoolState(
        b=make_dead(nlanes, grid.levels, device),
        pending=torch.zeros(nlanes, dtype=torch.bool, device=device),
        free_path=zf, tau=zf, esc_pending=zf, tabs=tabs, intf=intf.view(-1),
        absd=torch.zeros((), dtype=torch.float32, device=device),
        spare_cell=torch.remainder(
            torch.arange(nlanes, device=device), grid.cells))


def _refill(kit, st, gen, params, next_id, total):
    """Refill dead lanes from the remaining budget (exclusive prefix sum
    over dead lanes). Returns the count of packets started, on device."""
    grid = kit.grid
    b = st.b
    dead = b.ind < 0
    deadi = dead.to(torch.int64)
    rank = torch.cumsum(deadi, 0) - deadi
    new_id = next_id + rank
    can = dead & (new_id < total)
    ids_local = torch.where(can, new_id, 0)
    nb = gen(grid, ids_local, kit.seed, params)
    canl = can[..., None]
    st.b = PacketBatch(
        pos=torch.where(canl, nb.pos, b.pos),
        dir=torch.where(canl, nb.dir, b.dir),
        level=torch.where(can, nb.level, b.level),
        ind=torch.where(can, nb.ind, b.ind),
        photons=torch.where(can, nb.photons, b.photons),
        ifreq=torch.where(can, nb.ifreq, b.ifreq),
        stream=torch.where(can, nb.stream, b.stream),
        hi=torch.where(can, nb.hi, b.hi),
        counter=torch.where(can, nb.counter, b.counter),
        scatterings=torch.where(can, 0, b.scatterings),
        anc=torch.where(canl, nb.anc, b.anc) if grid.levels > 1 else b.anc)
    fp_new = kit.draw_birth_fp(nb.stream, nb.hi)
    st.free_path = torch.where(can, fp_new, st.free_path)
    st.pending = st.pending & ~can
    st.tau = torch.where(can, 0.0, st.tau)
    return can.sum()


def transport_run(grid, physics, source_params, total_packets, tabs, intf,
                  seed, source_kind="bg", nlanes=1 << 17,
                  per_freq_tally=False):
    """Drain ``total_packets`` packets through the grid with lane refill.

    physics : dict of device tensors 'kabs', 'ksca', 'tw' [NFREQ] and
        'csc' [NFREQ, BINS] (the mixed-frequency pool)
    source_params : generator parameters (see sources.packet_identity),
        with 'photons' a [NFREQ] tensor
    tabs : [CELLS] integrated tally; intf : [CELLS, NFREQ] per-frequency
        tally (or any placeholder when per_freq_tally is False); both are
        added to in place

    Returns (tabs, intf, escaped [NFREQ] float64, absorbed scalar) on the
    device; escaped is per frequency.
    """
    from .sources import GENERATORS
    gen = GENERATORS[source_kind]
    kit = StepKit(grid, physics, seed, per_freq_tally)
    nfreq = kit.nfreq
    device = grid.device
    st = new_pool(nlanes, grid, tabs, intf)
    # escaped weight per frequency, spread over ESC_SPREAD slots per bin
    # (slot = lane % ESC_SPREAD) so the card's atomic adds do not all wait
    # on NFREQ addresses; float64, so the order of the additions cannot
    # show in the energy balance
    esc_w = torch.zeros(nfreq * ESC_SPREAD, dtype=torch.float64,
                        device=device)
    esc_slot = torch.remainder(torch.arange(nlanes, device=device),
                               ESC_SPREAD)
    next_id = torch.zeros((), dtype=torch.int64, device=device)
    total = int(total_packets)
    body = 0
    while True:
        if body % CHECK_EVERY == 0 and body > 0:
            more = bool(((st.b.ind >= 0).any() | (next_id < total)).item())
            if not more:
                break
        body += 1
        # ---- flush the escaped weight of dead lanes per frequency
        dead = st.b.ind < 0
        esc_w.index_add_(0, st.b.ifreq * ESC_SPREAD + esc_slot,
                         torch.where(dead, st.esc_pending, 0.0).double())
        st.esc_pending = torch.where(dead, 0.0, st.esc_pending)

        next_id = next_id + _refill(kit, st, gen, source_params, next_id,
                                    total)
        lane_c = kit.lane_const_of(st.b)
        kit.service(st)
        for _ in range(REFILL_PERIOD):
            kit.march(st, lane_c)
    # final flush: lanes that died in the last block
    esc_w.index_add_(0, st.b.ifreq * ESC_SPREAD + esc_slot,
                     st.esc_pending.double())
    return tabs, intf, esc_w.view(nfreq, ESC_SPREAD).sum(1), st.absd
