"""Photon-packet propagation: the hot loop (port of
soc_tpu.transport.propagate: the mixed-frequency pool, with the ALI
self-absorption tally, in-flight packet splitting, per-cell cross sections
(WITH_ABU, MSF) and the (I, Ix, Iy, Iz) intensity tally).

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

With ALI (``with_ali``) a deposit into the cell that emitted the packet
(``e_cell``, -1 for packets from other sources) goes to the ``xab`` tally
instead of ``tabs``: soc_tpu sends it out of bounds in the one and into
range in the other; here both tallies take the add at the same index, the
one of them 0.0.

Splitting (``split_max``, refined clouds only): a packet that descends
into a finer level halves its weight and posts its state as a clone
request; at most one request per lane is in flight, and the next refill
body serves requests into dead lanes before it draws fresh packets. The
clone keeps the donor's (stream, hi), draws from the counter block
64 * path (path: the split-path bits, a 32-bit word that wraps as soc_tpu's
uint32 does) and re-samples its entry point over the crossed octet face.
Whether a packet splits depends on how many lanes are dead at each refill,
so split runs reproduce soc_tpu's only at the same lane count.

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

from ..constants import (ADHOC, DEPS, MAX_SCATTERINGS, PEPS, PHOTON_LIMIT,
                         TAULIM)

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
    e_cell: torch.Tensor       # [N] int64 emitting cell (ALI), -1 otherwise
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
        e_cell=torch.full((n,), -1, dtype=torch.int64, device=device),
        anc=torch.zeros((n, max(levels - 1, 1)), dtype=torch.int64,
                        device=device))


SPLIT_CAP = 26      # path * 64 must stay in 32 bits (soc_tpu's cap)
_SPLIT_FIELDS = ("pos", "dir", "level", "ind", "photons", "ifreq", "stream",
                 "hi", "path", "depth", "face", "anc")


def init_split_state(nlanes, levels, device):
    """Fresh per-lane split bookkeeping: each lane's clone request (the
    state it posted, its split path and depth, the crossed face), the
    lane's own depth and path, the pending flags and the clones served."""
    zi = torch.zeros(nlanes, dtype=torch.int64, device=device)
    z3 = torch.zeros((nlanes, 3), dtype=torch.float32, device=device)
    return dict(anc=torch.zeros((nlanes, max(levels - 1, 1)),
                                dtype=torch.int64, device=device),
                pos=z3, dir=z3, level=zi, ind=zi,
                photons=torch.zeros(nlanes, dtype=torch.float32,
                                    device=device),
                ifreq=zi, stream=zi, hi=zi, path=zi, depth=zi, face=zi,
                lane_depth=zi, lane_path=zi,
                pending=torch.zeros(nlanes, dtype=torch.bool, device=device),
                clones=torch.zeros((), dtype=torch.int64, device=device))


def post_clones(sp, is_link, pos, level, ind, anc, photons, b, split_max):
    """The march's split: a lane descending into a finer level (is_link)
    with no request in flight and depth left halves its weight and posts
    its new state as a clone request. Updates sp in place; returns the
    lanes' photons."""
    want = is_link & ~sp["pending"] & (sp["lane_depth"] < split_max)
    photons = torch.where(want, 0.5 * photons, photons)
    depth_new = sp["lane_depth"] + want.to(torch.int64)
    # crossing axis: the octet coordinate closest to a face
    face = torch.argmin(torch.minimum(pos, 2.0 - pos), dim=1)
    bit = torch.bitwise_left_shift(torch.ones_like(depth_new),
                                   (depth_new - 1).clamp(0, 31))
    new = dict(pos=pos, dir=b.dir, level=level, ind=ind, photons=photons,
               ifreq=b.ifreq, stream=b.stream, hi=b.hi,
               path=(sp["lane_path"] | bit) & socrng.MASK32,
               depth=depth_new, face=face, anc=anc)
    for k in _SPLIT_FIELDS:
        w = want if new[k].ndim == 1 else want[:, None]
        sp[k] = torch.where(w, new[k], sp[k])
    sp["pending"] = sp["pending"] | want
    sp["lane_depth"] = depth_new
    return photons


def serve_clones(seed, st):
    """Serve pending clone requests into dead lanes, the k-th dead lane
    (in lane order) taking the k-th request. The request-to-lane map is a
    stable partition, pending lanes first, built by one scatter with
    every index in range (soc_tpu drops the non-pending lanes out of
    bounds). Updates st and st.sp in place."""
    b, sp = st.b, st.sp
    nlanes = b.lanes
    dead = b.ind < 0
    di = dead.to(torch.int64)
    drank = torch.cumsum(di, 0) - di
    pend = sp["pending"]
    pi = pend.to(torch.int64)
    prank = torch.cumsum(pi, 0) - pi
    n_pend = pi.sum()
    n_dead = di.sum()
    lanes = torch.arange(nlanes, device=b.ind.device)
    slot = torch.where(pend, prank, n_pend + lanes - prank)
    donor_map = torch.empty_like(lanes).scatter_(0, slot, lanes)
    adopt = dead & (drank < n_pend)
    donor = donor_map[drank.clamp(0, nlanes - 1)]

    def take(k):
        return sp[k][donor]

    stream, hi, dpos, dlevel, dind = (take("stream"), take("hi"),
                                      take("pos"), take("level"),
                                      take("ind"))
    cbase = (take("path") * 64) & socrng.MASK32
    # re-sample the clone's entry point over the crossed octet face
    # (tangential coordinates uniform in [PEPS, 2 - PEPS]) from the
    # clone's own counter block
    u1, u2 = socrng.uniform2(seed, stream, cbase, hi)
    axis = take("face")
    span = 2.0 - 2.0 * PEPS
    t1 = PEPS + span * u1
    t2 = PEPS + span * u2
    jpos = torch.stack([torch.where(axis == 0, dpos[:, 0], t1),
                        torch.where(axis == 1, dpos[:, 1],
                                    torch.where(axis == 0, t1, t2)),
                        torch.where(axis == 2, dpos[:, 2], t2)], 1)
    # below the root only: at level 0 keep the exact position
    deep = dlevel > 0
    jpos = torch.where(deep[:, None], jpos, dpos)
    # the sub-cell index within the same octet
    jind = torch.where(deep, dind - traverse._suboct(dpos)
                       + traverse._suboct(jpos), dind)
    al = adopt[:, None]
    st.b = PacketBatch(
        pos=torch.where(al, jpos, b.pos),
        dir=torch.where(al, take("dir"), b.dir),
        level=torch.where(adopt, dlevel, b.level),
        ind=torch.where(adopt, jind, b.ind),
        photons=torch.where(adopt, take("photons"), b.photons),
        ifreq=torch.where(adopt, take("ifreq"), b.ifreq),
        stream=torch.where(adopt, stream, b.stream),
        hi=torch.where(adopt, hi, b.hi),
        counter=torch.where(adopt, (cbase + 3) & socrng.MASK32, b.counter),
        scatterings=torch.where(adopt, 0, b.scatterings),
        e_cell=torch.where(adopt, -1, b.e_cell),
        anc=torch.where(al, take("anc"), b.anc))
    # the clone's birth free path, from slot cbase + 2
    fp_u = socrng.uniform1(seed, stream, (cbase + 2) & socrng.MASK32, hi)
    st.free_path = torch.where(adopt, -torch.log(fp_u), st.free_path)
    st.tau = torch.where(adopt, 0.0, st.tau)
    st.pending = st.pending & ~adopt
    sp["lane_depth"] = torch.where(adopt, take("depth"), sp["lane_depth"])
    sp["lane_path"] = torch.where(adopt, take("path"), sp["lane_path"])
    sp["pending"] = pend & ~(prank < n_dead)
    sp["clones"] = sp["clones"] + adopt.sum()


@dataclass
class PoolState:
    """Per-lane loop state besides the packets, plus the tallies
    (tabs [CELLS], intf [CELLS*NFREQ] flat and, with ALI, xab [CELLS],
    updated in place)."""

    b: PacketBatch
    pending: torch.Tensor      # [N] bool: frozen at a scattering point
    free_path: torch.Tensor    # [N] float32 optical depth to next scatter
    tau: torch.Tensor          # [N] float32 scattering depth accumulated
    esc_pending: torch.Tensor  # [N] float32 escaped weight not yet flushed
    tabs: torch.Tensor
    intf: torch.Tensor
    absd: torch.Tensor         # () float32 total deposited
    spare_cell: torch.Tensor   # [N] lane % CELLS: where inactive lanes add 0
    xab: torch.Tensor = None   # [CELLS] self-absorption tally (ALI) or None
    sp: dict = None            # split state (init_split_state) or None


class StepKit:
    """The march/service physics of transport_run over a PoolState.

    physics: dict with 'kabs', 'ksca', 'tw' [NFREQ] and 'csc'
    [NFREQ, BINS]; optionally, for per-cell abundances (WITH_ABU),
    'opt_abs' and 'opt_sca' [CELLS, NFREQ] (float32 or bfloat16, widened
    for the math: optishalf) in place of kabs and ksca, and for one
    scattering function a species (MSF) 'msf_csc' [NDUST, NFREQ, BINS],
    'msf_abu' [CELLS, NDUST] and 'msf_sca' [NFREQ, NDUST]. Packets keep
    their frequency for life, so the per-lane constants are gathered once
    per refill (``lane_const_of``) rather than once per step.
    ncomp: 1 for a per-frequency tally of deposits, 4 for the (I, Ix, Iy,
    Iz) tally of saveint 2 (deposit times (1, direction))."""

    def __init__(self, grid, physics, seed, per_freq_tally, with_ali=False,
                 split_max=0, ncomp=1):
        csc = physics["csc"]
        if csc.ndim != 2 or physics["kabs"].ndim != 1:
            raise NotImplementedError(
                "uniform-frequency transport (scalar cross sections); the "
                "port runs the mixed-frequency pool")
        self.grid = grid
        self.physics = physics
        self.seed = int(seed)
        self.per_freq_tally = per_freq_tally
        self.with_ali = with_ali
        self.bins = csc.shape[-1]
        self.nfreq = csc.shape[0]
        self.ncomp = ncomp
        self.opt = physics.get("opt_abs")
        self.msf = "msf_csc" in physics
        # soc_tpu caps the depth so that path * 64 stays in 32 bits
        self.split_max = min(int(split_max), SPLIT_CAP)

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
        if self.msf:
            # WITH_MSF: the scattering species with probability
            # ABU[cell, d] * SCA_d / sum (kernel_ASOC.c:786-795), then
            # that species' phase function
            u_fp, u_bin, u_phi, u_sp = socrng.step_uniforms4(
                self.seed, b.stream, b.counter, b.hi)
            p = self.physics
            gidx = traverse._gidx(self.grid, b.level, b.ind.clamp_min(0))
            cdf = torch.cumsum(p["msf_abu"][gidx] * p["msf_sca"][b.ifreq],
                               1)
            r = 0.99999 * u_sp * cdf[:, -1]
            species = (cdf < r[:, None]).sum(1).clamp(
                0, p["msf_csc"].shape[0] - 1)
            bin_idx = (u_bin * self.bins).to(torch.int64).clamp(
                0, self.bins - 1)
            cos_theta = p["msf_csc"][species, b.ifreq, bin_idx]
        else:
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
        if self.opt is not None:
            # WITH_ABU: the cell's own cross sections at the lane's channel
            oidx = gidx * self.nfreq + b.ifreq
            kabs = self.opt.view(-1)[oidx].to(torch.float32)
            ksca = self.physics["opt_sca"].view(-1)[oidx].to(torch.float32)

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
        wdep = dep * tw * ADHOC
        if self.with_ali:
            # self-absorption: the deposit into the packet's own emitting
            # cell goes to xab; both tallies add at didx
            selfc = active & (gidx == b.e_cell)
            st.tabs.index_add_(0, didx, torch.where(selfc, 0.0, wdep))
            st.xab.index_add_(0, didx, torch.where(selfc, wdep, 0.0))
        else:
            st.tabs.index_add_(0, didx, wdep)
        if self.per_freq_tally and self.ncomp == 4:
            # saveint 2: (I, Ix, Iy, Iz), the deposit times (1, direction)
            w4 = torch.cat([torch.ones_like(dep)[:, None], b.dir], 1) \
                * dep[:, None]
            cidx = ((didx * self.nfreq + b.ifreq) * 4)[:, None] \
                + torch.arange(4, device=dep.device)
            st.intf.index_add_(0, cidx.reshape(-1), w4.reshape(-1))
        elif self.per_freq_tally:
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
            if self.split_max > 0:
                photons = post_clones(st.sp, is_link, pos, level, ind, anc,
                                      photons, b, self.split_max)

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


def new_pool(nlanes, grid, tabs, intf, xab=None, split=False):
    """A pool of dead lanes adding into tabs [CELLS], intf [CELLS, NFREQ]
    (or [CELLS, NFREQ, 4]) and xab [CELLS] (or None) in place; with
    ``split`` it carries the split state."""
    device = grid.device
    zf = torch.zeros(nlanes, dtype=torch.float32, device=device)
    return PoolState(
        b=make_dead(nlanes, grid.levels, device),
        pending=torch.zeros(nlanes, dtype=torch.bool, device=device),
        free_path=zf, tau=zf, esc_pending=zf, tabs=tabs, intf=intf.view(-1),
        absd=torch.zeros((), dtype=torch.float32, device=device),
        spare_cell=torch.remainder(
            torch.arange(nlanes, device=device), grid.cells), xab=xab,
        sp=init_split_state(nlanes, grid.levels, device) if split else None)


def _refill(kit, st, gen, params, next_id, total, births=None):
    """Refill dead lanes from the remaining budget (exclusive prefix sum
    over dead lanes). With ``births`` (launched, missed, slot) the new
    packets' weights, and those of packets born outside the grid (a point
    source's misses, which never enter), are added per frequency.
    Returns the count of packets started, on device."""
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
        e_cell=torch.where(can, nb.e_cell, b.e_cell),
        anc=torch.where(canl, nb.anc, b.anc) if grid.levels > 1 else b.anc)
    fp_new = kit.draw_birth_fp(nb.stream, nb.hi)
    st.free_path = torch.where(can, fp_new, st.free_path)
    st.pending = st.pending & ~can
    st.tau = torch.where(can, 0.0, st.tau)
    if st.sp is not None:
        st.sp["lane_depth"] = torch.where(can, 0, st.sp["lane_depth"])
        st.sp["lane_path"] = torch.where(can, 0, st.sp["lane_path"])
    if births is not None:
        launched, missed, slot = births
        at = nb.ifreq * ESC_SPREAD + slot
        w = torch.where(can, nb.photons, 0.0).double()
        launched.index_add_(0, at, w)
        missed.index_add_(0, at, torch.where(nb.ind < 0, w, 0.0))
    return can.sum()


def pool_lanes(nlanes, per_freq):
    """Lane-pool size for a run whose largest budget is ``per_freq``: the
    smaller of nlanes and that budget (at least 1024), rounded up to a
    power of two."""
    n = min(nlanes, max(1024, per_freq))
    return 1 << (n - 1).bit_length() if n & (n - 1) else n


def transport_run(grid, physics, source_params, total_packets, tabs, intf,
                  seed, source_kind="bg", nlanes=1 << 17,
                  per_freq_tally=False, with_ali=False, xab=None,
                  split_max=0, births=False):
    """Drain ``total_packets`` packets through the grid with lane refill.

    physics : dict of device tensors 'kabs', 'ksca', 'tw' [NFREQ] and
        'csc' [NFREQ, BINS] (the mixed-frequency pool), optionally the
        per-cell tables of StepKit
    source_params : generator parameters (see sources.packet_identity),
        with the source's weights a tensor over the frequencies
    tabs : [CELLS] integrated tally; intf : [CELLS, NFREQ] per-frequency
        tally, or [CELLS, NFREQ, 4] for the (I, Ix, Iy, Iz) tally (any
        placeholder when per_freq_tally is False); both are added to in
        place
    with_ali : route deposits into a packet's own emitting cell to xab
        [CELLS] (added to in place; zeros when None) instead of tabs
    split_max : in-flight splitting at refinement boundaries, at most
        split_max (capped at 26) splits a packet; 0 turns it off
    births : also count the weights launched and born outside the grid

    Returns (tabs, intf, escaped [NFREQ] float64, absorbed scalar) on the
    device, then xab when with_ali, the clones served (int64 scalar) when
    split_max > 0, and (launched, missed) [NFREQ] float64 with births;
    escaped is per frequency.
    """
    return drain(transport_steps(grid, physics, source_params,
                                 total_packets, tabs, intf, seed,
                                 source_kind, nlanes, per_freq_tally,
                                 with_ali, xab, split_max, births))


def drain(steps):
    """Run a generator to its end; returns its return value."""
    while True:
        try:
            next(steps)
        except StopIteration as stop:
            return stop.value


def transport_steps(grid, physics, source_params, total_packets, tabs, intf,
                    seed, source_kind="bg", nlanes=1 << 17,
                    per_freq_tally=False, with_ali=False, xab=None,
                    split_max=0, births=False):
    """transport_run as a generator: it yields after each refill body (the
    escape flush, the clone service, a refill, a service step and
    REFILL_PERIOD march steps queued on the device, in soc_tpu's order)
    and returns transport_run's result, so one host thread can step the
    pools of several devices in turn (ProductMesh.map_steps)."""
    from .sources import GENERATORS
    gen = GENERATORS[source_kind]
    ncomp = intf.shape[2] if per_freq_tally and intf.ndim == 3 else 1
    kit = StepKit(grid, physics, seed, per_freq_tally, with_ali, split_max,
                  ncomp)
    nfreq = kit.nfreq
    device = grid.device
    if with_ali and xab is None:
        xab = torch.zeros(grid.cells, dtype=torch.float32, device=device)
    split = split_max > 0
    st = new_pool(nlanes, grid, tabs, intf, xab if with_ali else None,
                  split)
    # escaped weight per frequency, spread over ESC_SPREAD slots per bin
    # (slot = lane % ESC_SPREAD) so the card's atomic adds do not all wait
    # on NFREQ addresses; float64, so the order of the additions cannot
    # show in the energy balance
    esc_w = torch.zeros(nfreq * ESC_SPREAD, dtype=torch.float64,
                        device=device)
    esc_slot = torch.remainder(torch.arange(nlanes, device=device),
                               ESC_SPREAD)
    birth_w = None
    if births:
        birth_w = (torch.zeros_like(esc_w), torch.zeros_like(esc_w),
                   esc_slot)
    next_id = torch.zeros((), dtype=torch.int64, device=device)
    total = int(total_packets)
    body = 0
    while True:
        if body % CHECK_EVERY == 0 and body > 0:
            more = (st.b.ind >= 0).any() | (next_id < total)
            if split:
                # a pool whose ids are all issued may still hold requests
                more = more | st.sp["pending"].any()
            if not bool(more.item()):
                break
        body += 1
        # ---- flush the escaped weight of dead lanes per frequency
        dead = st.b.ind < 0
        esc_w.index_add_(0, st.b.ifreq * ESC_SPREAD + esc_slot,
                         torch.where(dead, st.esc_pending, 0.0).double())
        st.esc_pending = torch.where(dead, 0.0, st.esc_pending)
        # ---- pending clones go into dead lanes before fresh packets
        if split:
            serve_clones(kit.seed, st)

        next_id = next_id + _refill(kit, st, gen, source_params, next_id,
                                    total, birth_w)
        lane_c = kit.lane_const_of(st.b)
        kit.service(st)
        for _ in range(REFILL_PERIOD):
            kit.march(st, lane_c)
        yield
    # final flush: lanes that died in the last block
    esc_w.index_add_(0, st.b.ifreq * ESC_SPREAD + esc_slot,
                     st.esc_pending.double())
    out = (tabs, intf, esc_w.view(nfreq, ESC_SPREAD).sum(1), st.absd)
    if with_ali:
        out = out + (xab,)
    if split:
        out = out + (st.sp["clones"],)
    if births:
        out = out + tuple(w.view(nfreq, ESC_SPREAD).sum(1)
                          for w in birth_w[:2])
    return out
