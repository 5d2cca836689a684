"""Photon-packet propagation: the hot loop (port of
soc_tpu.transport.propagate: the mixed-frequency pool, with the ALI
self-absorption tally, in-flight packet splitting, per-cell cross sections
(WITH_ABU, MSF), the (I, Ix, Iy, Iz) intensity tally, mirrored faces, the
ROI crossing tally and the step and direction weighting).

A fixed pool of packet lanes is stepped in PyTorch (on a card the march
block of a refill body replays as one CUDA graph: PoolRun; on a root grid
that block is one CUDA kernel, csrc/march.cu: StepKit.fuses_on). Each
*march* step advances every live lane by one event (a cell-boundary
crossing or the arrival at a scattering point); lanes whose free path
ends freeze there (``pending``) and a *service* step draws the new
direction and free path for all of them at once. Every REFILL_PERIOD
steps, lanes that died are refilled with fresh packets from the remaining
budget through an exclusive prefix sum over dead lanes. A packet's random
numbers are keyed by (stream, counter), so neither the service delay nor
the lane count changes any packet's path.

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

Mirrored faces (``mirror_mask``, the 6 bits of `mirror xXyYzZ`): a lane
leaving through one is reflected back inside (its direction negated, its
position mirrored PEPS inside the face) and re-indexed from the root.

Z-slab domains (``domain``, parallel/domain.py): the grid is one slab of
the root grid's Z planes. A lane that leaves through an interior slab face
is an emigrant (``PoolState.emig`` +1 up, -1 down): it is not counted as
escaped, its index is -1 like a dead lane's, so neither service nor march
touches it, and no refill takes its lane (``free_lanes``) until the
caller's exchange has handed it to the neighbouring slab. The Z faces are
mirrored only on the outer slabs; with ALI the self-absorption test maps
the slab-local deposit cell to its global id (``e_cell`` stays global).

ROI save (``roi``): every crossing into the ROI box adds the packet's
photons at (channel, surface element, Healpix pixel of its direction) of a
flat [NFREQ * NELEM * NPIX] tally; lanes that did not enter add 0.0 into
one of ``lanes`` spare slots past its end, as the absorbed tally's
inactive lanes do.

STEP_WEIGHT (physics 'sw_a', and 'sw_b' for method 2) draws free paths
from a stretched exponential (or a two-exponential mixture) and weights the
packet by the ratio of the densities, at birth and at every scattering;
splitting is then off, as in soc_tpu (a stretched free path is not
memoryless). DIR_WEIGHT (physics 'dw_a' with the [NFREQ, BINS] phase
function 'dsc') draws the deflection from HG(dw_a) and weights by
p_DSC / p_HG at the lane's channel.

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
from dataclasses import dataclass, fields, replace

import torch

from ..constants import (ADHOC, DEPS, MAX_SCATTERINGS, PEPS, PHOTON_LIMIT,
                         TAULIM)

from ..ops import traverse
from ..render.healpix import ang2pix_ring
from .. import rng as socrng
from ..utils import trace
from . import march_kernel
from .roi import roi_element_index

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
    # the helper axis: x where |dir_x| < 0.9, else y (made on the device,
    # so a CUDA graph can capture it)
    hx = (torch.abs(dir[..., 0]) < 0.9).to(dir.dtype)
    helper = torch.stack([hx, 1.0 - hx, torch.zeros_like(hx)], -1)
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
    dead = free_lanes(st)
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
    roi: torch.Tensor = None   # flat ROI tally + lanes spare slots, or None
    roi_spare: torch.Tensor = None  # [N] each lane's spare ROI slot
    emig: torch.Tensor = None  # [N] int64 emigrant direction (domains)


def free_lanes(st):
    """Lanes a refill or a clone may take: the dead ones, less the
    emigrants that await their exchange (Z-slab domains)."""
    dead = st.b.ind < 0
    return dead if st.emig is None else dead & (st.emig == 0)


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
    Iz) tally of saveint 2 (deposit times (1, direction)).
    ncol, col0: the per-frequency tally holds channels [col0, col0 + ncol)
    (a block of them under `mmapabs`; all NFREQ by default).
    mirror_mask: the mirrored faces' bits (x X y Y z Z = 1 2 4 8 16 32).
    roi: the ROI save's dict(mask [CELLS] bool, box, dim (rnx, rny, rnz,
    step), nside) or None.
    domain: None, or for one Z slab of `domains N` dict(rank, n_slabs,
    nz_local, gidx): the slab's index and count, its root Z planes (the
    grid's nz) and its [CELLS] local -> global cell map (-1 padding).
    The weighting keys of physics ('sw_a', 'sw_b', 'dw_a') are floats.

    ``fused``: whether a march block runs as the one CUDA kernel of
    march_kernel.run_block (fuses_on), decided once here."""

    def __init__(self, grid, physics, seed, per_freq_tally, with_ali=False,
                 split_max=0, ncomp=1, ncol=None, col0=0, mirror_mask=0,
                 roi=None, domain=None):
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
        self.ncol = self.nfreq if ncol is None else int(ncol)
        self.col0 = int(col0)
        self.block = self.col0 != 0 or self.ncol != self.nfreq
        device = grid.device

        def f32(key):
            v = physics.get(key)
            return None if v is None else torch.tensor(
                float(v), dtype=torch.float32, device=device)

        self.sw_a, self.sw_b, self.dw_a = f32("sw_a"), f32("sw_b"), \
            f32("dw_a")
        # soc_tpu caps the depth so that path * 64 stays in 32 bits, and
        # turns splitting off under STEP_WEIGHT
        self.split_max = 0 if self.sw_a is not None \
            else min(int(split_max), SPLIT_CAP)
        self.domain = domain
        self.mirror_mask = int(mirror_mask)
        if domain is not None:
            # interior slab faces belong to the exchange: z is mirrored on
            # the bottom slab only, Z on the top one
            rank, n = domain["rank"], domain["n_slabs"]
            self.mirror_mask &= ~((16 if rank > 0 else 0)
                                  | (32 if rank < n - 1 else 0))
        if self.mirror_mask:
            m = self.mirror_mask
            self.lo_m = torch.tensor([bool(m & 1), bool(m & 4),
                                      bool(m & 16)], device=device)
            self.hi_m = torch.tensor([bool(m & 2), bool(m & 8),
                                      bool(m & 32)], device=device)
            self.bounds = torch.tensor([grid.nx, grid.ny, grid.nz],
                                       dtype=torch.float32, device=device)
        self.roi = roi
        if roi is not None:
            rnx, rny, rnz = roi["dim"][:3]
            self.roi_npix = 12 * int(roi["nside"]) ** 2
            self.roi_size = (rnx * rny + rnx * rnz + rny * rnz) \
                * self.roi_npix * self.nfreq
        self.fused = self.fuses_on(device)

    def fuses_on(self, device):
        """Whether a march block of this configuration runs as one CUDA
        kernel (csrc/march.cu, march_kernel.run_block) on ``device``: a
        CUDA device, a root grid (no level to descend, so no split),
        neither per-cell cross sections (WITH_ABU), MSF, STEP_WEIGHT nor
        DIR_WEIGHT, no mirrored face, no ROI save, no Z slab, and a tally
        of one component (not saveint 2). ALI and the per-frequency tally,
        a block of its channels too, are in the kernel. Every other
        configuration runs the eager block."""
        return (torch.device(device).type == "cuda" and self.grid.levels == 1
                and self.ncomp == 1 and self.opt is None and not self.msf
                and self.sw_a is None and self.dw_a is None
                and self.mirror_mask == 0 and self.roi is None
                and self.domain is None)

    def lane_const_of(self, b):
        p = self.physics
        return p["kabs"][b.ifreq], p["ksca"][b.ifreq], p["tw"][b.ifreq]

    def draw_fp_weighted(self, u):
        """Free path from a uniform and its STEP_WEIGHT weight (None when
        off): method 1 p(tau) = A exp(-A tau), weight exp((A - 1) tau) / A;
        method 2 the mixture A B exp(-A tau) + 2 A (1 - B) exp(-2 A tau)
        by its closed-form inverse CDF, weight exp(-tau) / p(tau)
        (kernel_ASOC.c:516-541)."""
        a, b = self.sw_a, self.sw_b
        if a is None:
            return -torch.log(u), None
        if b is None:
            fp = -torch.log(u) / a
            return fp, torch.exp(a * fp - fp) / a
        x = ((-b + torch.sqrt(b * b + 4.0 * u * (1.0 - b)))
             / (2.0 - 2.0 * b))
        fp = -torch.log(torch.clamp_min(x, 1e-30)) / a
        w = 1.0 / (a * b * torch.exp((1.0 - a) * fp)
                   + 2.0 * a * (1.0 - b) * torch.exp((1.0 - 2.0 * a) * fp))
        return fp, w

    def draw_birth_fp(self, stream, hi):
        """The birth free path (counter slot 2, first word) and its
        weight (None without STEP_WEIGHT)."""
        u = socrng.uniform1(self.seed, stream, torch.full_like(stream, 2), hi)
        return self.draw_fp_weighted(u)

    def service(self, st):
        """Serve pending scattering events: one RNG evaluation, the
        phase-function lookup and the deflection for every frozen lane."""
        b = st.b
        act = st.pending & (b.ind >= 0)
        dw_corr = None
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
        elif self.dw_a is not None:
            # DIR_WEIGHT (WScatter, kernel_ASOC_aux.c:567): the deflection
            # from HG(dw_a), weighted by p_DSC(cos) / p_HG(cos) at the
            # lane's channel
            u_fp, u_bin, u_phi = socrng.step_uniforms(self.seed, b.stream,
                                                      b.counter, b.hi)
            a = self.dw_a
            t = (1.0 - a * a) / (1.0 - a + 2.0 * a * u_bin)
            cos_theta = torch.clamp((1.0 + a * a - t * t) / (2.0 * a + 1e-6),
                                    -1.0, 1.0)
            p_hg = torch.clamp_min(
                (1.0 / (4.0 * math.pi)) * (1.0 - a * a)
                / (1.0 + a * a - 2.0 * a * cos_theta) ** 1.5, 1e-6)
            dsc = self.physics["dsc"]
            nb = dsc.shape[-1]
            dbin = ((1.0 + cos_theta) * 0.5 * nb).to(torch.int64).clamp(
                0, nb - 1)
            dw_corr = torch.clamp_min(dsc[b.ifreq, dbin], 1e-6) / p_hg
        else:
            u_fp, u_bin, u_phi = socrng.step_uniforms(self.seed, b.stream,
                                                      b.counter, b.hi)
            cos_theta = _csc_lookup(self.physics["csc"], b.ifreq, u_bin,
                                    self.bins)
        new_dir = _deflect(b.dir, cos_theta, (2.0 * math.pi) * u_phi)
        fp_next, w_next = self.draw_fp_weighted(u_fp)
        photons = b.photons
        if w_next is not None:
            photons = torch.where(act, photons * w_next, photons)
        if dw_corr is not None:
            photons = torch.where(act, photons * dw_corr, photons)
        st.b = replace(b, dir=torch.where(act[..., None], new_dir, b.dir),
                       photons=photons,
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
            own = gidx if self.domain is None \
                else self.domain["gidx"][gidx]
            selfc = active & (own == b.e_cell)
            st.tabs.index_add_(0, didx, torch.where(selfc, 0.0, wdep))
            st.xab.index_add_(0, didx, torch.where(selfc, wdep, 0.0))
        else:
            st.tabs.index_add_(0, didx, wdep)
        if self.per_freq_tally:
            col = b.ifreq
            if self.block:
                # dead lanes keep another block's channel: clamp into range
                col = (col - self.col0).clamp(0, self.ncol - 1)
            fidx = didx * self.ncol + col
        if self.per_freq_tally and self.ncomp == 4:
            # saveint 2: (I, Ix, Iy, Iz), the deposit times (1, direction)
            w4 = torch.cat([torch.ones_like(dep)[:, None], b.dir], 1) \
                * dep[:, None]
            cidx = (fidx * 4)[:, None] + torch.arange(4, device=dep.device)
            st.intf.index_add_(0, cidx.reshape(-1), w4.reshape(-1))
        elif self.per_freq_tally:
            st.intf.index_add_(0, fidx, dep)
        st.absd = st.absd + dep.sum()
        photons = torch.where(active, b.photons * att, b.photons)

        # ---- crossing branch: move into the next cell
        posx = torch.where(active[..., None], pos_boundary, b.pos)
        cross = active & ~scatter_now
        npos, nlevel, nind, anc = traverse.index_update_stack(
            grid, posx, b.level, b.ind, b.anc, cross, descend=False)
        failed = cross & (nlevel == b.level) & (nind == b.ind)
        npos = traverse.failed_step_nudge(npos, b.dir, failed)
        dirx = b.dir
        if self.mirror_mask:
            npos, nlevel, nind, anc, dirx = self._mirror(
                cross, npos, nlevel, nind, anc, b.dir)
        if self.roi is not None:
            self._roi_tally(st, cross, gidx, npos, nlevel, nind, b,
                            photons)
        exited = cross & (nind < 0)
        if self.domain is not None:
            exited = self._emigrate(st, exited, npos)

        # ---- merge: scattering lanes freeze at the scattering point
        pos = torch.where(scatter_now[..., None], pos_scatter, npos)
        level = torch.where(scatter_now, b.level, nlevel)
        ind = torch.where(scatter_now, b.ind, nind)
        dir = torch.where(scatter_now[..., None], b.dir, dirx) \
            if self.mirror_mask else b.dir
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
        st.b = replace(b, pos=pos, dir=dir, level=level, ind=ind,
                       photons=photons, scatterings=scat, anc=anc)

    def _mirror(self, cross, npos, nlevel, nind, anc, dir):
        """Reflect lanes leaving through a mirrored face (Mirror,
        kernel_ASOC_aux.c:1054): exiting lanes hold root coordinates in
        npos; a reflected lane is re-indexed from the root with its leaf
        walk's ancestor stack (stack_from_par's, read on the way down).
        Returns (npos, nlevel, nind, anc, dir)."""
        bounds = self.bounds
        exiting = cross & (nind < 0)
        lo_hit = npos <= 0.0
        hi_hit = npos >= bounds
        refl = ((lo_hit & self.lo_m) | (hi_hit & self.hi_m)) \
            & exiting[:, None]
        rpos = torch.where(lo_hit, PEPS - npos,
                           torch.where(hi_hit, 2.0 * bounds - PEPS - npos,
                                       npos))
        mpos = torch.where(refl, torch.minimum(torch.clamp_min(rpos, PEPS),
                                               bounds - PEPS), npos)
        dir = torch.where(refl, -dir, dir)
        mirrored = refl.any(-1)
        mp, ml, mi, ma = traverse.index_global_stack(self.grid, mpos)
        npos = torch.where(mirrored[:, None], mp, npos)
        nlevel = torch.where(mirrored, ml, nlevel)
        nind = torch.where(mirrored, mi, nind)
        if self.grid.levels > 1:
            anc = torch.where(mirrored[:, None], ma, anc)
        return npos, nlevel, nind, anc, dir

    def _emigrate(self, st, exited, npos):
        """Z-slab domains: an exit through an interior slab face (npos in
        root coordinates; z in the upper half of the slab goes up, else
        down) becomes an emigrant; only exits through the X/Y faces and
        the outer Z faces escape. Returns the lanes that escaped."""
        grid, dom = self.grid, self.domain
        rank, n = dom["rank"], dom["n_slabs"]
        inner = exited & (npos[:, 0] > 0.0) & (npos[:, 0] < grid.nx) \
            & (npos[:, 1] > 0.0) & (npos[:, 1] < grid.ny)
        upper = npos[:, 2] >= 0.5 * dom["nz_local"]
        up = inner & upper if rank < n - 1 else torch.zeros_like(inner)
        down = inner & ~upper if rank > 0 else torch.zeros_like(inner)
        st.emig = st.emig + up.to(torch.int64) - down.to(torch.int64)
        return exited & ~up & ~down

    def _roi_tally(self, st, cross, gidx, npos, nlevel, nind, b, photons):
        """WITH_ROI_SAVE (kernel_ASOC.c:617-660): a lane that crossed from
        a cell outside the ROI into one inside adds its photons at
        (channel, surface element, Healpix pixel of its direction)."""
        grid, roi = self.grid, self.roi
        mask = roi["mask"]
        was_in = mask[gidx]
        now_in = mask[traverse._gidx(grid, nlevel, nind.clamp_min(0))] \
            & (nind >= 0)
        entered = cross & now_in & ~was_in
        # soc_tpu takes the root position of npos; a lane that enters the
        # box crossed a root cell's face, and the march leaves it on the
        # root level (its descent deferred), so npos is that position (a
        # mirrored lane, re-indexed to its leaf, lands in the root cell it
        # left and does not enter)
        rnx, rny, rnz, rstep = roi["dim"]
        elem = roi_element_index(npos, roi["box"], rnx, rny, rnz, rstep)
        theta = torch.acos(torch.clamp(b.dir[:, 2], -1.0, 1.0))
        phi = torch.atan2(b.dir[:, 1], b.dir[:, 0])
        hpix = ang2pix_ring(int(roi["nside"]), theta, phi)
        per_freq = self.roi_size // self.nfreq
        slot = torch.where(entered, b.ifreq * per_freq
                           + elem * self.roi_npix + hpix, st.roi_spare)
        st.roi.index_add_(0, slot, torch.where(entered, photons, 0.0))


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
    dead = free_lanes(st)
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
    fp_new, w_new = kit.draw_birth_fp(nb.stream, nb.hi)
    if w_new is not None:
        # STEP_WEIGHT: the birth free path's weight
        st.b.photons = torch.where(can, st.b.photons * w_new,
                                   st.b.photons)
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


# replay a pool's march block as one CUDA graph on a card (PoolRun)
CUDA_GRAPHS = True


def _pool_tensors(st):
    """The per-lane state a march block reads and replaces, by name (the
    tallies, added to in place, and the fixed spare slots stay out)."""
    out = {"b." + f.name: getattr(st.b, f.name) for f in fields(st.b)}
    out.update(pending=st.pending, free_path=st.free_path, tau=st.tau,
               esc_pending=st.esc_pending, absd=st.absd)
    if st.emig is not None:
        out["emig"] = st.emig
    if st.sp is not None:
        out.update({"sp." + k: v for k, v in st.sp.items()})
    return out


def _set_pool_tensors(st, tensors):
    """Point st's state at ``tensors`` (as _pool_tensors names them)."""
    st.b = replace(st.b, **{k[2:]: v for k, v in tensors.items()
                            if k.startswith("b.")})
    for k, v in tensors.items():
        if k.startswith("sp."):
            st.sp[k[3:]] = v
        elif not k.startswith("b."):
            setattr(st, k, v)


class PoolRun:
    """One pool's drain, a body at a time: transport_steps and the Z-slab
    runner (parallel/domain.py) step their pools through it.

    A body, in soc_tpu's order: flush the escaped weight of the free lanes
    (dead, not emigrants) per frequency, serve the pending clones,
    ``before_refill`` (the slab runner's arrivals), refill from the budget
    of ``total`` ids, then ``inner`` march steps with a service every
    REFILL_PERIOD (soc_tpu's service period, capped at ``inner``). With
    ``births`` the weights launched and born outside the grid are summed
    per frequency too.

    On a CUDA device the march block is captured as one CUDA graph at the
    second body and replayed after (utils.graphs.GraphedBlock): the eager
    block issues some hundred kernels a march step from one host thread,
    which the card finishes faster than the host issues them. The replay
    runs the same kernels: the state is copied into the graph's inputs,
    and the pool takes its outputs; the tallies are the same tensors.
    Where the kit is ``fused`` the block is the one kernel of
    march_kernel.run_block, and the graph holds that kernel. Each body
    counts its block (`transport.blocks_fused` or `transport.blocks_eager`,
    utils/trace.py)."""

    def __init__(self, kit, st, gen, params, total, births=False,
                 inner=REFILL_PERIOD):
        if inner % min(inner, REFILL_PERIOD):
            raise ValueError("inner %d: a multiple of %d, or fewer"
                             % (inner, REFILL_PERIOD))
        self.kit, self.st, self.gen, self.params = kit, st, gen, params
        self.total, self.inner = int(total), int(inner)
        device = kit.grid.device
        # escaped weight per frequency, spread over ESC_SPREAD slots per
        # bin (slot = lane % ESC_SPREAD) so the card's atomic adds do not
        # all wait on NFREQ addresses; float64, so the order of the
        # additions cannot show in the energy balance
        self.esc_w = torch.zeros(kit.nfreq * ESC_SPREAD, dtype=torch.float64,
                                 device=device)
        self.esc_slot = torch.remainder(
            torch.arange(st.b.lanes, device=device), ESC_SPREAD)
        self.births = None
        if births:
            self.births = (torch.zeros_like(self.esc_w),
                           torch.zeros_like(self.esc_w), self.esc_slot)
        self.next_id = torch.zeros((), dtype=torch.int64, device=device)
        self.block = None
        if CUDA_GRAPHS and device.type == "cuda":
            from ..utils.graphs import GraphedBlock
            self.block = GraphedBlock(self._block_fn(), device,
                                       kind="pool")
        self.bodies = 0

    def more(self):
        """Device bool: live lanes, ids left, or clone requests pending."""
        st = self.st
        more = (st.b.ind >= 0).any() | (self.next_id < self.total)
        if st.sp is not None:
            # a pool whose ids are all issued may still hold requests
            more = more | st.sp["pending"].any()
        return more

    def body(self, before_refill=None):
        """One body of the pool (the class docstring's order)."""
        st, kit = self.st, self.kit
        dead = free_lanes(st)
        self.esc_w.index_add_(0, st.b.ifreq * ESC_SPREAD + self.esc_slot,
                              torch.where(dead, st.esc_pending, 0.0).double())
        st.esc_pending = torch.where(dead, 0.0, st.esc_pending)
        # pending clones go into dead lanes before fresh packets
        if st.sp is not None:
            serve_clones(kit.seed, st)
        if before_refill is not None:
            before_refill()
        if self.total:
            self.next_id = self.next_id + _refill(
                kit, st, self.gen, self.params, self.next_id, self.total,
                self.births)
        # the kernel reads the per-frequency constants itself
        lane_c = () if kit.fused else kit.lane_const_of(st.b)
        trace.count("transport.blocks_fused" if kit.fused
                    else "transport.blocks_eager")
        self.bodies += 1
        if self.block is not None:
            self._replay(lane_c)
        else:
            self._marches(st, lane_c)

    def _marches(self, st, lane_c):
        # soc_tpu's blocks: a service, then min(inner, REFILL_PERIOD) march
        # steps, inner // that many times
        period = min(self.inner, REFILL_PERIOD)
        if self.kit.fused:
            march_kernel.run_block(self.kit, st, self.inner // period, period)
            return
        for _ in range(self.inner // period):
            self.kit.service(st)
            for _ in range(period):
                self.kit.march(st, lane_c)

    def _block_fn(self):
        """The march block as a function of the pool's tensors (in the
        order _pool_tensors names them at the first body) and the lane
        constants, returning the tensors the block replaced: the
        GraphedBlock's fn."""
        def fn(*tensors):
            n = len(self.names)
            work = replace(self.st, sp=None if self.st.sp is None
                           else dict(self.st.sp))
            _set_pool_tensors(work, dict(zip(self.names, tensors[:n])))
            self._marches(work, tensors[n:])
            return tuple(_pool_tensors(work)[k] for k in self.names)
        return fn

    def _replay(self, lane_c):
        """The march block through the GraphedBlock: eager at the first
        body, captured at the second, replayed from then on."""
        pool = _pool_tensors(self.st)
        if self.bodies == 1:
            self.names = list(pool)
        out = self.block(*(pool[k] for k in self.names), *lane_c)
        if self.kit.fused and self.block.graph is not None:
            march_kernel.count_replay()
        _set_pool_tensors(self.st, dict(zip(self.names, out)))

    def finish(self):
        """The last flush (lanes that died in the last block); returns
        (escaped, (launched, missed) or None) [NFREQ] float64 on the
        device. The graph's memory goes with it."""
        st = self.st
        self.esc_w.index_add_(0, st.b.ifreq * ESC_SPREAD + self.esc_slot,
                              st.esc_pending.double())
        self.block = None
        nfreq = self.kit.nfreq
        births = None if self.births is None else tuple(
            w.view(nfreq, ESC_SPREAD).sum(1) for w in self.births[:2])
        return self.esc_w.view(nfreq, ESC_SPREAD).sum(1), births


def transport_run(grid, physics, source_params, total_packets, tabs, intf,
                  seed, source_kind="bg", nlanes=1 << 17,
                  per_freq_tally=False, with_ali=False, xab=None,
                  split_max=0, births=False, mirror_mask=0, roi=None,
                  tally_col0=0, max_iters=1 << 30,
                  refill_period=REFILL_PERIOD):
    """Drain ``total_packets`` packets through the grid with lane refill.

    physics : dict of device tensors 'kabs', 'ksca', 'tw' [NFREQ] and
        'csc' [NFREQ, BINS] (the mixed-frequency pool), optionally the
        per-cell tables of StepKit
    source_params : generator parameters (see sources.packet_identity),
        with the source's weights a tensor over the frequencies
    tabs : [CELLS] integrated tally; intf : [CELLS, NFREQ] per-frequency
        tally, or [CELLS, NFREQ, 4] for the (I, Ix, Iy, Iz) tally (any
        placeholder when per_freq_tally is False); both are added to in
        place. With ``tally_col0`` intf is [CELLS, NB(, 4)], the block of
        channels tally_col0 .. tally_col0 + NB - 1 (every packet of the run
        lies in it: `mmapabs`)
    with_ali : route deposits into a packet's own emitting cell to xab
        [CELLS] (added to in place; zeros when None) instead of tabs
    split_max : in-flight splitting at refinement boundaries, at most
        split_max (capped at 26) splits a packet; 0 turns it off
    births : also count the weights launched and born outside the grid
    mirror_mask : the mirrored faces (driver.mirror_mask_of)
    roi : the ROI save, dict(mask [CELLS] bool tensor, box, dim (rnx, rny,
        rnz, step), nside, tally [NFREQ, NELEM * NPIX] added to in place)
    max_iters : at most this many refill bodies, even with budget left
        (soc_tpu's loop bound: a fixed count of bodies on an unlimited
        budget runs exactly max_iters * refill_period * nlanes lane steps)
    refill_period : march steps a body (PoolRun's ``inner``): a service
        then min(refill_period, REFILL_PERIOD) march steps, repeated;
        REFILL_PERIOD or fewer, or a multiple of it

    Returns (tabs, intf, escaped [NFREQ] float64, absorbed scalar) on the
    device, then xab when with_ali, the clones served (int64 scalar) when
    split_max > 0 (0 under STEP_WEIGHT, which turns splitting off), and
    (launched, missed) [NFREQ] float64 with births; escaped is per
    frequency.
    """
    return drain(transport_steps(grid, physics, source_params,
                                 total_packets, tabs, intf, seed,
                                 source_kind, nlanes, per_freq_tally,
                                 with_ali, xab, split_max, births,
                                 mirror_mask, roi, tally_col0, max_iters,
                                 refill_period))


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
                    split_max=0, births=False, mirror_mask=0, roi=None,
                    tally_col0=0, max_iters=1 << 30,
                    refill_period=REFILL_PERIOD):
    """transport_run as a generator: it yields after each refill body (the
    escape flush, the clone service, a refill, a service step and
    refill_period march steps queued on the device, in soc_tpu's order)
    and returns transport_run's result, so one host thread can step the
    pools of several devices in turn (ProductMesh.map_steps). The body
    count is the host's, so a run stops after exactly max_iters bodies."""
    from .sources import GENERATORS
    gen = GENERATORS[source_kind]
    ncomp = intf.shape[2] if per_freq_tally and intf.ndim == 3 else 1
    kit = StepKit(grid, physics, seed, per_freq_tally, with_ali, split_max,
                  ncomp, intf.shape[1] if per_freq_tally else None,
                  tally_col0, mirror_mask, roi)
    device = grid.device
    if with_ali and xab is None:
        xab = torch.zeros(grid.cells, dtype=torch.float32, device=device)
    split = kit.split_max > 0
    st = new_pool(nlanes, grid, tabs, intf, xab if with_ali else None,
                  split)
    if roi is not None:
        st.roi = torch.zeros(kit.roi_size + nlanes, dtype=torch.float32,
                             device=device)
        st.roi_spare = kit.roi_size + torch.arange(nlanes, device=device)
    run = PoolRun(kit, st, gen, source_params, total_packets, births,
                  inner=refill_period)
    body = 0
    while body < max_iters:
        if body % CHECK_EVERY == 0 and body > 0:
            if not bool(run.more().item()):
                break
        body += 1
        run.body()
        yield
    esc, birth_w = run.finish()
    out = (tabs, intf, esc, st.absd)
    if with_ali:
        out = out + (xab,)
    if roi is not None:
        roi["tally"].view(-1).add_(st.roi[:kit.roi_size])
    if split_max > 0:
        out = out + (st.sp["clones"] if split else
                     torch.zeros((), dtype=torch.int64, device=device),)
    if births:
        out = out + birth_w
    return out
