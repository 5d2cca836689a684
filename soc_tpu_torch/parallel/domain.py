"""Z-slab domain decomposition: the `domains N` path (port of
soc_tpu.parallel.domain).

The root grid is split into N slabs of NZ/N root planes each
(split_grid_slabs: every sub-octree lies in one slab, child links
renumbered a slab). Slab s lies on device ``devices[s]`` with its own
tallies; its pool steps only the packets inside it, with transport_run's
own StepKit and the emigrant hook (``domain=``): a packet that leaves
through an interior slab face freezes as an emigrant and is handed to the
neighbouring slab between supersteps. This file holds no march,
scattering or deposit arithmetic: the physics, its options (per-frequency
tallies, ALI, EMWEI, splitting, mirrors, WITH_ABU/MSF, step and direction
weighting) and the births are the one-device path's.

A pass is run_freqs, with product.run_freqs's signature and result, so the
driver calls either one in the same place:
  * the pool is the one-device pass's mixed pool (sources.pool_params):
    the same ids, so the same packets on the same streams. Each id is
    owned by the slab its birth lies in, found once a pass: for cell
    sources through the inverse cell map, for surface and point sources
    from one chunked evaluation of the generator on a one-level grid of
    the global dimensions. An id no slab owns (its entry rounds onto an
    outer Z face, or it is born outside the grid) counts as launched and
    missed, as a one-device pool counts a packet born outside;
  * a birth is the generator's packet in global coordinates, shifted into
    the slab's frame (z clipped to [PEPS, nz_local - PEPS]) and re-indexed
    on the slab's grid; a cell packet keeps its position and takes its
    cell's slab-local index;
  * each slab drains one mixed-frequency pool. A superstep is the pool's
    body (propagate.PoolRun, the one-device pool's, in soc_tpu's order):
    flush the escaped weight of dead lanes that are not emigrants, serve
    split clones, drain the pending queue into free lanes (arrivals are
    re-indexed from their root position), refill from the slab's owned
    ids, K_INNER march steps with a service every REFILL_PERIOD (on a
    card one CUDA graph's replay), then pack
    each direction's emigrants (z in the neighbour's frame, clipped) into
    a buffer of all the pool's lanes, emigrants first (a stable partition
    by one scatter), hand it to the neighbour (``.to(device)``) and append
    its first count rows to the neighbour's pending queue (4 x lanes rows).
    Counts and slots are device prefix sums; the host looks at the slabs
    only every CHECK_EVERY supersteps;
  * arrivals past a queue's capacity are charged to a lost weight: the
    pass raises naming the channel and `lanes` (a larger pool drains the
    queues faster);
  * one host thread steps the slabs in turn, each under its device's
    scope, as ProductMesh.map_steps steps shards; a repeated device list
    puts several slabs on one device (the tests, and the smoke run on one
    card). A slab's exception propagates.

Per-cell physics (``_PER_CELL_PHYSICS``) is remapped to each slab's cells;
the rest is copied once to each distinct device. DomainSet.assemble maps
a slab's tallies back to the global cells.

What differs from the one-device run: the order of the float32 additions,
and the geometry near a slab face (a position shifted by nz_local and
clipped to PEPS), where a packet's path may part from its one-device twin.
Which clones a slab serves depends on its lanes and refill order, as on
the mesh. soc_tpu runs a uniform-frequency pool a channel and slab; the
identities are the same.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import PEPS
from ..grid import Grid, build_parents, decode_link_np, encode_link_np
from ..ops import traverse
from ..transport.propagate import (CHECK_EVERY, PacketBatch, PoolRun,
                                   StepKit, free_lanes, new_pool, pool_lanes)
from ..transport.sources import GENERATORS, emitting_cell, pool_params
from .product import _on, _to, _to_device

K_INNER = 32         # march steps a superstep (soc_tpu's k_inner)
QUEUE_FACTOR = 4     # pending-queue rows per lane
OWNER_CHUNK = 1 << 22  # ids a chunk of the owner evaluation
# physics entries that are per global cell: remapped to each slab's cells
_PER_CELL_PHYSICS = ("opt_abs", "opt_sca", "msf_abu")


@dataclass
class SlabSet:
    """Host-side container of S stacked slab grids (Z-decomposition)."""

    dens: np.ndarray        # [S, CELLS_PAD]
    lcells: np.ndarray      # [S, LEVELS]
    off: np.ndarray         # [LEVELS] shared (levels padded to max size)
    par: np.ndarray         # [S, CELLS_PAD]
    gidx: np.ndarray        # [S, CELLS_PAD] global cell index, -1 = padding
    nx: int = 0
    ny: int = 0
    nz: int = 0             # GLOBAL z extent
    nz_local: int = 0
    levels: int = 0
    cells_pad: int = 0
    n_slabs: int = 0


def split_grid_slabs(grid, n_slabs):
    """Split an octree grid into Z-slabs of nz/S root planes each (NumPy,
    soc_tpu's arrays bit for bit).

    Slab boundaries align with root-cell planes, so every sub-octree is
    fully contained in one slab; child links are renumbered per slab.
    """
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    if nz % n_slabs:
        raise ValueError("domains %d: NZ=%d not divisible" % (n_slabs, nz))
    nzl = nz // n_slabs
    dens = grid.dens.cpu().numpy()
    off = grid.off.cpu().numpy()
    levels = grid.levels

    per_slab = []       # per slab: list of (values, global_level_indices)
    for s in range(n_slabs):
        sel = np.arange(s * nx * ny * nzl, (s + 1) * nx * ny * nzl)
        level_vals = [dens[off[0] + sel].copy()]
        level_gidx = [off[0] + sel]
        for level in range(1, levels):
            vals_prev = level_vals[level - 1]
            parents = np.nonzero(vals_prev <= 0.0)[0]
            if len(parents) == 0:
                level_vals.append(np.zeros(0, np.float32))
                level_gidx.append(np.zeros(0, np.int64))
                continue
            first_old = decode_link_np(vals_prev[parents])
            child_old = (first_old[:, None]
                         + np.arange(8)[None, :]).reshape(-1)
            level_vals.append(dens[off[level] + child_old].copy())
            level_gidx.append(off[level] + child_old)
            # renumber: children of parent j occupy [8j, 8j+8)
            vals_prev[parents] = encode_link_np(8 * np.arange(len(parents)))
        per_slab.append((level_vals, level_gidx))

    # pad every level to the max size over slabs -> shared off[]
    max_l = [max(len(per_slab[s][0][l]) for s in range(n_slabs))
             for l in range(levels)]
    off_new = np.zeros(levels, np.int32)
    off_new[1:] = np.cumsum(max_l)[:-1]
    cells_pad = int(np.sum(max_l))
    dens_s = np.zeros((n_slabs, cells_pad), np.float32)
    lcells_s = np.zeros((n_slabs, levels), np.int32)
    par_s = np.full((n_slabs, cells_pad), -1, np.int32)
    gidx_s = np.full((n_slabs, cells_pad), -1, np.int32)
    max_l = np.asarray(max_l, np.int32)
    for s in range(n_slabs):
        level_vals, level_gidx = per_slab[s]
        lc = np.asarray([len(v) for v in level_vals], np.int32)
        lcells_s[s] = lc
        # padding cells carry a tiny positive density so they read as
        # (unreachable) leaves, never as child links
        flat = np.full(cells_pad, 1e-30, np.float32)
        for l in range(levels):
            flat[off_new[l]:off_new[l] + lc[l]] = level_vals[l]
            gidx_s[s, off_new[l]:off_new[l] + lc[l]] = level_gidx[l]
        dens_s[s] = flat
        par_s[s] = build_parents(flat, max_l, off_new, nx, ny, nzl)
    return SlabSet(dens=dens_s, lcells=lcells_s, off=off_new, par=par_s,
                   gidx=gidx_s, nx=nx, ny=ny, nz=nz, nz_local=nzl,
                   levels=levels, cells_pad=cells_pad, n_slabs=n_slabs)


class DomainSet:
    """The N slabs of `domains N` over ``devices`` (one a slab; a device
    may repeat). ``grid`` is the global grid, on the caller's device,
    where the passes' outputs are gathered. Per slab: its Grid on its
    device, its local -> global cell map (``gidx``, -1 padding) and its
    global -> local one (``inv``, -1 elsewhere); ``owner_of_cell`` the
    slab of each global cell."""

    def __init__(self, grid, devices):
        self.devices = [torch.device(d) for d in devices]
        self.n_slabs = n = len(self.devices)
        self.grid = grid
        self.slabs = sl = split_grid_slabs(grid, n)
        self.nz_local = sl.nz_local
        owner = np.full(grid.cells, -1, np.int64)
        self.grids, self.gidx, self.inv, self.rows = [], [], [], []
        for s, dev in enumerate(self.devices):
            self.grids.append(Grid(
                dens=torch.as_tensor(sl.dens[s], device=dev),
                lcells=torch.as_tensor(sl.lcells[s], device=dev),
                off=torch.as_tensor(sl.off, device=dev),
                par=torch.as_tensor(sl.par[s], device=dev),
                nx=sl.nx, ny=sl.ny, nz=sl.nz_local, levels=sl.levels,
                cells=sl.cells_pad))
            g = sl.gidx[s].astype(np.int64)
            m = g >= 0
            inv = np.full(grid.cells, -1, np.int64)
            inv[g[m]] = np.nonzero(m)[0]
            owner[g[m]] = s
            self.gidx.append(torch.as_tensor(g, device=dev))
            self.inv.append(torch.as_tensor(inv, device=dev))
            # (slab rows, global rows) of the slab's real cells, on the
            # caller's device: where its tallies go
            self.rows.append((torch.as_tensor(np.nonzero(m)[0],
                                              device=grid.device),
                              torch.as_tensor(g[m], device=grid.device)))
        self.owner_of_cell = torch.as_tensor(owner, device=grid.device)
        self._copies = {}

    route = "domains"   # a pass's route over the slabs (driver stats)

    def run_freqs(self, *args, **kw):
        """run_freqs over these slabs, as ProductMesh.run_freqs runs the
        mesh's (the driver calls a pass's layout)."""
        return run_freqs(self, *args, **kw)

    def copy(self, what, device):
        """The global grid ('grid') or a one-level grid of the global
        dimensions ('dummy': entry positions, never a density read) on
        ``device``, made once a device."""
        g = self.grid
        if what == "grid" and torch.device(device) == g.device:
            return g
        key = (what, str(device))
        if key not in self._copies:
            if what == "grid":
                self._copies[key] = _to_device(g, device)
            else:
                z = torch.zeros(1, dtype=torch.int32, device=device)
                self._copies[key] = Grid(
                    dens=torch.zeros(1, dtype=torch.float32, device=device),
                    lcells=z + g.root_cells, off=z, par=z, nx=g.nx, ny=g.ny,
                    nz=g.nz, levels=1, cells=g.root_cells)
        return self._copies[key]

    def to_slab(self, s, values):
        """A per-cell table [CELLS, ...] as slab s's [cells_pad, ...] on
        its device, zero on the padding."""
        g = self.gidx[s].to(values.device)
        loc = values[g.clamp_min(0)]
        loc[g < 0] = 0
        return loc.to(self.devices[s])

    def assemble(self, s, local, out):
        """Add slab s's [cells_pad, ...] tally into the global [CELLS,
        ...] ``out`` through gidx, the padding dropped; returns out."""
        lrows, grows = self.rows[s]
        return out.index_add_(0, grows, local.to(out.device)[lrows])


def _owners(ds, kind, params, total, seed, nfreq):
    """The ids of one pool that each slab owns, in ascending order (a
    device tensor on the slab's device), their counts, and the weight per
    channel (float64 [NFREQ] host array) of the ids no slab owns."""
    dev = ds.grid.device
    n, nzl = ds.n_slabs, ds.nz_local
    owner = torch.empty(total, dtype=torch.int32, device=dev)
    unowned = torch.zeros(nfreq, dtype=torch.float64, device=dev)
    gen = GENERATORS[kind]
    for i0 in range(0, total, OWNER_CHUNK):
        ids = torch.arange(i0, min(i0 + OWNER_CHUNK, total), device=dev)
        if kind == "cell":
            cell = emitting_cell(ids, params, ds.grid.cells)[0]
            ow = ds.owner_of_cell[cell]
        else:
            nb = gen(ds.copy("dummy", dev), ids, seed, params)
            z = nb.pos[:, 2]
            z = torch.where(torch.isfinite(z), z, -1.0).clamp(-1.0,
                                                              n * nzl + 1.0)
            ow = torch.floor(z / nzl).to(torch.int64)
            ow = torch.where((ow < 0) | (ow >= n) | (nb.ind < 0), -1, ow)
            out = ow < 0
            unowned.index_add_(0, nb.ifreq[out], nb.photons[out].double())
        owner[i0:i0 + ids.shape[0]] = ow
    lists = [torch.nonzero(owner == s).squeeze(1).to(d)
             for s, d in enumerate(ds.devices)]
    return lists, [int(x.shape[0]) for x in lists], unowned.cpu().numpy()


def _birth(ds, s, kind, own):
    """Slab s's generator for _refill: list positions -> the owned ids'
    packets, born by the source's own generator in global coordinates,
    then in the slab's frame."""
    dev, grid_s = ds.devices[s], ds.grids[s]
    gen = GENERATORS[kind]
    z0 = float(s * ds.nz_local)
    last = own.shape[0] - 1
    if kind == "cell":
        grid_g, inv = ds.copy("grid", dev), ds.inv[s]
        off = grid_s.off.to(torch.int64)

        def birth(_grid, idx, seed, params):
            nb = gen(grid_g, own[idx.clamp_max(last)], seed, params)
            # the emitting cell's slab-local index; a root cell's position
            # moves down by the slab's first plane (exact in float32), a
            # deeper one's octet coordinates stay
            ind = inv[nb.e_cell] - off[nb.level]
            z = torch.where(nb.level == 0, nb.pos[:, 2] - z0, nb.pos[:, 2])
            return dataclasses.replace(
                nb, pos=torch.stack([nb.pos[:, 0], nb.pos[:, 1], z], 1),
                ind=ind, anc=traverse.stack_from_par(grid_s, nb.level, ind))
    else:
        dummy = ds.copy("dummy", dev)

        def birth(_grid, idx, seed, params):
            nb = gen(dummy, own[idx.clamp_max(last)], seed, params)
            z = (nb.pos[:, 2] - z0).clamp(PEPS, ds.nz_local - PEPS)
            pos, level, ind, anc = traverse.index_global_stack(
                grid_s, torch.stack([nb.pos[:, 0], nb.pos[:, 1], z], 1))
            return dataclasses.replace(nb, pos=pos, level=level, ind=ind,
                                       anc=anc)
    return birth


# the words a packet crosses a slab face with: float32 and int64
_NF, _NI = 9, 8


class _Slab:
    """One slab's pool, pending queue and per-channel sums."""

    def __init__(self, ds, s, kit, nlanes, tally_shape, with_ali, split,
                 birth, params, own_n):
        dev, grid = ds.devices[s], ds.grids[s]
        self.dev, self.grid, self.nzl = dev, grid, ds.nz_local
        f32 = dict(dtype=torch.float32, device=dev)
        self.tabs = torch.zeros(grid.cells, **f32)
        self.intf = torch.zeros(tally_shape, **f32)
        self.st = new_pool(nlanes, grid, self.tabs, self.intf,
                           torch.zeros(grid.cells, **f32) if with_ali
                           else None, split)
        self.st.emig = torch.zeros(nlanes, dtype=torch.int64, device=dev)
        self.pool = PoolRun(kit, self.st, birth, params, own_n, births=True,
                            inner=K_INNER)
        self.lanes = torch.arange(nlanes, device=dev)
        self.lost = torch.zeros(kit.nfreq, dtype=torch.float64, device=dev)
        self.cap = QUEUE_FACTOR * nlanes
        # rows cap .. cap + nlanes - 1 take the arrivals past capacity
        self.pend_f = torch.zeros((self.cap + nlanes, _NF), **f32)
        self.pend_i = torch.zeros((self.cap + nlanes, _NI),
                                  dtype=torch.int64, device=dev)
        zi = torch.zeros((), dtype=torch.int64, device=dev)
        self.pend_n = self.lost_n = zi
        self.emigrants = self.emig_peak = self.queue_peak = zi
        self.out = None

    def active(self):
        """Device bool: anything left to do in this slab."""
        return self.pool.more() | (self.pend_n > 0)

    def superstep(self):
        """The pool's body with the arrivals before its refill, then the
        emigrant buffers to self.out as ((floats, ints, count) up,
        (...) down)."""
        st = self.st
        self.pool.body(before_refill=self._arrive)
        self.out = (self._pack(1), self._pack(-1))
        n = self.out[0][2] + self.out[1][2]
        self.emigrants = self.emigrants + n
        self.emig_peak = torch.maximum(self.emig_peak, n)
        st.emig = torch.zeros_like(st.emig)

    def _pack(self, sign):
        """This direction's emigrants, first in a buffer of every lane (a
        stable partition by one scatter), z in the neighbour's frame;
        returns (floats [N, 9], ints [N, 8], count)."""
        st = self.st
        b = st.b
        sel = st.emig == sign
        si = sel.to(torch.int64)
        rank = torch.cumsum(si, 0) - si
        count = si.sum()
        slot = torch.where(sel, rank, count + self.lanes - rank)
        z = (b.pos[:, 2] - sign * self.nzl).clamp(PEPS, self.nzl - PEPS)
        sp = st.sp or {}
        zi = torch.zeros_like(b.ind)
        flo = torch.stack([b.pos[:, 0], b.pos[:, 1], z, b.dir[:, 0],
                           b.dir[:, 1], b.dir[:, 2], b.photons,
                           st.free_path, st.tau], 1)
        ints = torch.stack([b.stream, b.hi, b.counter, b.scatterings,
                            b.e_cell, b.ifreq, sp.get("lane_depth", zi),
                            sp.get("lane_path", zi)], 1)
        return (torch.empty_like(flo).index_copy_(0, slot, flo),
                torch.empty_like(ints).index_copy_(0, slot, ints), count)

    def receive(self, flo, ints, count):
        """Append a neighbour's buffer's first ``count`` rows to the
        pending queue; rows past its capacity are lost, their weight
        charged to their channel."""
        flo, ints, count = flo.to(self.dev), ints.to(self.dev), \
            count.to(self.dev)
        idx = self.pend_n + self.lanes
        arr = self.lanes < count
        over = arr & (idx >= self.cap)
        self.lost.index_add_(0, ints[:, 5],
                             torch.where(over, flo[:, 6].abs(), 0.0).double())
        self.lost_n = self.lost_n + over.sum()
        slot = torch.where(arr & ~over, idx, self.cap + self.lanes)
        self.pend_f.index_copy_(0, slot, flo)
        self.pend_i.index_copy_(0, slot, ints)
        self.pend_n = torch.clamp_max(self.pend_n + count, self.cap)
        self.queue_peak = torch.maximum(self.queue_peak, self.pend_n)

    def _arrive(self):
        """Drain the pending queue (last in, first out) into free lanes;
        an arrival is re-indexed from its root position on this grid."""
        st = self.st
        free = free_lanes(st)
        fi = free.to(torch.int64)
        rank = torch.cumsum(fi, 0) - fi
        take = free & (rank < self.pend_n)
        slot = torch.where(take, self.pend_n - 1 - rank, 0)
        flo, ints = self.pend_f[slot], self.pend_i[slot]
        pos, level, ind, anc = traverse.index_global_stack(self.grid,
                                                           flo[:, 0:3])
        b, t1 = st.b, take[:, None]

        def pick(new, old):
            return torch.where(take if old.ndim == 1 else t1, new, old)
        st.b = PacketBatch(
            pos=pick(pos, b.pos), dir=pick(flo[:, 3:6], b.dir),
            level=pick(level, b.level), ind=pick(ind, b.ind),
            photons=pick(flo[:, 6], b.photons), ifreq=pick(ints[:, 5],
                                                           b.ifreq),
            stream=pick(ints[:, 0], b.stream), hi=pick(ints[:, 1], b.hi),
            counter=pick(ints[:, 2], b.counter),
            scatterings=pick(ints[:, 3], b.scatterings),
            e_cell=pick(ints[:, 4], b.e_cell), anc=pick(anc, b.anc))
        st.free_path = pick(flo[:, 7], st.free_path)
        st.tau = pick(flo[:, 8], st.tau)
        st.pending = st.pending & ~take
        if st.sp is not None:
            st.sp["lane_depth"] = pick(ints[:, 6], st.sp["lane_depth"])
            st.sp["lane_path"] = pick(ints[:, 7], st.sp["lane_path"])
        self.pend_n = self.pend_n - take.sum()

    def finish(self):
        """The last flush; returns (escaped, launched, missed) [NFREQ]
        float64 on the device."""
        esc, births = self.pool.finish()
        return (esc,) + births


def run_freqs(ds, grid, physics, kind, params, sel, counts, tabs, intf,
              seed, lanes, per_freq_tally, hi_base, maps=None, split_max=0,
              mirror_mask=0, roi=None, with_ali=False, col0=0):
    """The Z-slab transport of one source or cell pass, with the signature
    and result of product.run_freqs (``ds`` a DomainSet in the mesh's
    place, intf a one-element list holding the [CELLS, NFREQ(, 4)] tally,
    or a placeholder when per_freq_tally is False). Channel sel[j]
    carries counts[j] packets, ``maps`` EMWEI's id -> cell maps; the pool
    is the one-device pass's. Each slab's pool has pool_lanes(lanes // N)
    lanes. The ROI save and `mmapabs` blocks (roi,
    col0) are refused under domains by the driver.

    Returns (tabs, intf, out): out as product.run_freqs's (tabs the pass's
    own, escaped, launched, missed [NFREQ] float64 host arrays, clones,
    pools, packets, xab), and 'domain': the pass's supersteps, emigrants
    (total, mean and peak a superstep), the pending queues' peak and the
    lanes a slab. A queue overflow raises RuntimeError."""
    if roi is not None or col0:
        raise ValueError("domains: the ROI save and mmapabs blocks run on "
                         "one device or the `devices` mesh")
    nfreq = physics["csc"].shape[0]
    sel = np.asarray(sel, np.int64)
    counts = np.broadcast_to(np.asarray(counts, np.int64), sel.shape)
    keep = counts > 0
    if maps is not None:
        maps = [m for m, k in zip(maps, keep) if k]
    sel, counts = sel[keep], counts[keep]
    total = int(counts.sum())
    own_tabs = torch.zeros_like(tabs)
    out = dict(tabs=own_tabs, escaped=np.zeros(nfreq),
               launched=np.zeros(nfreq), missed=np.zeros(nfreq), clones=0,
               pools=0, packets=total, xab=None, domain=None)
    if with_ali:
        out["xab"] = torch.zeros_like(tabs)
    if total == 0:
        return tabs, intf, out
    n = ds.n_slabs
    pool = pool_params(params, sel, counts, hi_base, grid.device, maps=maps)
    lists, own_n, unowned = _owners(ds, kind, pool, total, seed, nfreq)
    nlanes = pool_lanes(max(1, lanes // n), max(own_n))
    tally = intf[0] if per_freq_tally else None
    tally_shape = (1, 1) if tally is None \
        else (ds.slabs.cells_pad,) + tuple(tally.shape[1:])
    copies = {}
    slabs = []
    for s, dev in enumerate(ds.devices):
        if dev not in copies:
            copies[dev] = (_to({k: v for k, v in physics.items()
                                if k not in _PER_CELL_PHYSICS}, dev),
                           _to(pool, dev))
        phys, par = copies[dev]
        phys = dict(phys, **{k: ds.to_slab(s, physics[k])
                             for k in _PER_CELL_PHYSICS if k in physics})
        with _on(dev):
            kit = StepKit(
                ds.grids[s], phys, seed, per_freq_tally, with_ali,
                split_max, tally_shape[2] if len(tally_shape) == 3 else 1,
                nfreq if per_freq_tally else None, 0, mirror_mask,
                domain=dict(rank=s, n_slabs=n, nz_local=ds.nz_local,
                            gidx=ds.gidx[s]))
            slabs.append(_Slab(ds, s, kit, nlanes, tally_shape, with_ali,
                               kit.split_max > 0, _birth(ds, s, kind,
                                                         lists[s]),
                               par, own_n[s]))
    steps = 0
    while True:
        if steps % CHECK_EVERY == 0 and steps > 0:
            flags = []
            for sl in slabs:
                with _on(sl.dev):
                    flags.append(sl.active().to(grid.device))
            if not bool(torch.stack(flags).any().item()):
                break
        steps += 1
        for sl in slabs:
            with _on(sl.dev):
                sl.superstep()
        for s, sl in enumerate(slabs):
            with _on(sl.dev):
                if s > 0:
                    sl.receive(*slabs[s - 1].out[0])
                if s < n - 1:
                    sl.receive(*slabs[s + 1].out[1])
    lost = np.zeros(nfreq)
    lost_n = emig = emig_peak = queue_peak = 0
    for s, sl in enumerate(slabs):
        with _on(sl.dev):
            esc, launched, missed = (v.cpu().numpy() for v in sl.finish())
        out["escaped"] += esc
        out["launched"] += launched
        out["missed"] += missed
        ds.assemble(s, sl.tabs, own_tabs)
        if tally is not None:
            ds.assemble(s, sl.intf, tally)
        if with_ali:
            ds.assemble(s, sl.st.xab, out["xab"])
        if sl.st.sp is not None:
            out["clones"] += int(sl.st.sp["clones"])
        lost += sl.lost.cpu().numpy()
        lost_n += int(sl.lost_n)
        emig += int(sl.emigrants)
        emig_peak = max(emig_peak, int(sl.emig_peak))
        queue_peak = max(queue_peak, int(sl.queue_peak))
        out["pools"] += 1
    if lost_n:
        f = int(np.argmax(lost))
        raise RuntimeError(
            "domains: pending-queue overflow destroyed %d packets (%g photon "
            "weight at channel %d, the most of any); raise `lanes` (%d: %d "
            "a slab, a queue of %d)" % (lost_n, lost[f], f, lanes, nlanes,
                                        QUEUE_FACTOR * nlanes))
    out["launched"] += unowned
    out["missed"] += unowned
    out["domain"] = dict(slabs=n, supersteps=steps, emigrants=emig,
                         emigrants_mean=emig / steps,
                         emigrants_peak=emig_peak, queue_peak=queue_peak,
                         lanes=nlanes)
    return tabs + own_tabs, intf, out
