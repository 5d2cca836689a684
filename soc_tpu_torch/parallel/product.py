"""Multi-device execution: the product path behind the `devices N` ini
keyword (port of soc_tpu.parallel.product).

Layout. N devices form a (dp, freq) mesh, shard (dp, fq) on device
``devices[dp * F + fq]``:
  * 'freq': frequency channels are blocked over F shards; block fq owns
    the L = NFREQ/F channels fq*L .. fq*L + L - 1 and their [CELLS, L]
    per-frequency tally slab (with `saveint 2` [CELLS, L, 4]);
  * 'dp': each channel's packet budget is split over the n_dp = N/F shards
    of its block by id range. Every packet keeps the stream of the
    one-device run (streams are keyed by (phase|iteration|channel,
    index within the channel)), so the tallies match the one-device run up
    to the order of the float32 additions. Each shard drains one pool over
    its block (run_freqs says why not one per channel).

What runs sharded: as in soc_tpu, every source of phase 1 (the isotropic
background with `split`, the Healpix sky, point sources, the diffuse
field, the ROI load) and the re-emission of phase 2 (the mixed cell pass,
ALI, EMWEI, WITH_REFERENCE, SUBITERATIONS), with no feature exclusions:
per-cell abundances (WITH_ABU, MSF, `optishalf`), `stepweight`,
`direweight`, mirrors, the ROI save's crossing tally, `saveint`, `simum`,
`mmapabs` (the frequency-sharded slabs take the host tally's place) and
mid-run checkpoints, one unit a sharded pass. The one-device driver
runs its passes through the same run_freqs, as a one-shard mesh
(one_shard): sharding wraps the transport, it does not fork it.
After each pass the dp partials of a block are folded into its dp-0 slab
(fold_intf), so that the reduced tally a checkpoint holds, restored into
the dp-0 slabs, continues the run bit for bit on the CPU.

Execution. One host thread, the caller's, drives every shard, each under
``torch.cuda.device(its device)`` on that device's current stream: the
kernels it queues run while the thread goes on to the next shard. The
transport steps the shards' pools in turn, one refill body each, so every
card's queue is kept filled (map_steps). A host thread per shard is
slower: on one H100 six shard threads took 4.9x as long as the same
shards stepped in turn (a stream per thread no faster), on four H100s
four threads 4.3x (PERF.md); torch's bindings release the interpreter
lock in each call, so shard threads contend for it at every op. A shard's
exception propagates out of the call; nothing falls back to another
device or to the plain versions. Grid, medium and temperature table are
copied once to each distinct device and cached on the mesh. A device may
repeat in the list: its shards then share that device and its stream;
the tests and the smoke run use this to drive the layout on one card or
on the CPU.

Several processes (parallel/dist.py): a mesh built over the global
device list (``owners``, the rank of each shard's device) spans every
process, shard i still on global device i. A rank steps only its own
shards (map_shards, map_steps; the others' slots are None, their slabs
meta tensors that hold a shape and no memory) and every rank takes part
in every combination, a rank with no shard too: run_freqs gathers each
shard's TABS, escape, launch and miss vectors, clones, XAB and ROI tally
onto every rank and adds them in shard order; fold_intf and reduce_intf
move each block's dp partials to the rank of its dp-0 slab and add them
in dp order there; solve_temperature and emission gather their cell
ranges. A run over P processes adds in the same order as one process over
the same shard list, so on the CPU it equals that run bit for bit.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from ..solve import equilibrium
from ..solve.a2e_kernel import shard_ranges
from . import dist
from ..transport.propagate import pool_lanes, transport_steps


def _on(device):
    """The device scope a shard runs under: its card, or nothing."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _to_device(obj, device):
    """A copy of a frozen dataclass with every tensor field on device."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))})


class ProductMesh:
    """(dp, freq) mesh of the `devices N` path.

    The freq axis gets the largest divisor of N that also divides NFREQ
    (soc_tpu's rule: the tally per shard shrinks by F and so does each
    shard's frequency loop), or ``freq_axis`` (parallel/mesh.make_mesh's
    explicit F; 1 where it does not divide N); the rest is packet
    data-parallelism. devices: None for the global device list's first N
    cards (cuda:0 .. cuda:N-1 in one process; raises when fewer are
    visible), or an explicit list of N devices, which may repeat one.
    owners: the rank of each device (dist.global_devices); given, the
    mesh spans those processes, else every shard is this process's.
    nfreq may be None with freq_axis (make_mesh): with_nfreq binds it.
    """

    def __init__(self, n, nfreq, devices=None, freq_axis=None, owners=None):
        if devices is None:
            devices, owners = dist.global_devices(torch.device("cuda"), n)
            if n > len(devices):
                raise ValueError("devices %d: only %d visible"
                                 % (n, len(devices)))
            devices, owners = devices[:n], owners[:n]
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError("devices %d: a list of %d devices was given"
                             % (n, len(devices)))
        if freq_axis is not None:
            f = freq_axis if n % freq_axis == 0 else 1
        else:
            f = max(d for d in range(1, n + 1)
                    if n % d == 0 and nfreq % d == 0)
        self.n_dp = n // f
        self.n_freq = f
        self.nfreq = nfreq
        self.nf_local = None if nfreq is None else nfreq // f
        self.devices = devices
        self.multi = owners is not None and dist.process_count() > 1
        self.owners = list(owners) if owners is not None else [0] * n
        me = dist.process_index()
        self.mine = [o == me or not self.multi for o in self.owners]
        self._replicas = {}

    route = "mesh"      # a pass's route over the mesh (driver stats)

    def with_nfreq(self, nfreq):
        """This mesh's layout for NFREQ channels (soc_tpu's assert: NFREQ
        must divide the freq axis)."""
        assert nfreq % self.n_freq == 0, \
            "NFREQ must divide the freq mesh axis"
        if self.nfreq == nfreq:
            return self
        pm = ProductMesh(len(self.devices), nfreq, self.devices,
                         freq_axis=self.n_freq,
                         owners=self.owners if self.multi else None)
        pm._replicas = self._replicas
        return pm

    def lead(self, default):
        """The device of what runs on one device (the replicated renders):
        the first shard's in one process, else ``default`` (every rank
        renders on its own)."""
        return default if self.multi else self.devices[0]

    def run_freqs(self, *args, **kw):
        """run_freqs over this mesh (the driver calls a pass's layout)."""
        return run_freqs(self, *args, **kw)

    def replica(self, obj, device):
        """``obj`` (a Grid, Medium or TemperatureTable) on ``device``: the
        object itself where it lies there already, else a copy made once
        per distinct device and cached."""
        device = torch.device(device)
        first = next(getattr(obj, f.name) for f in dataclasses.fields(obj)
                     if torch.is_tensor(getattr(obj, f.name)))
        if first.device == device:
            return obj
        key = (id(obj), str(device))
        hit = self._replicas.get(key)
        if hit is None:          # keep obj alive, so its id is not reused
            hit = self._replicas[key] = (obj, _to_device(obj, device))
        return hit[1]

    def map_shards(self, fn):
        """[fn(i, device) for every shard i of this rank], one after the
        other in the calling thread, each under its device's scope;
        results in shard order, None for another rank's shard. A shard's
        exception propagates."""
        out = []
        for i, d in enumerate(self.devices):
            if not self.mine[i]:
                out.append(None)
                continue
            with _on(d):
                out.append(fn(i, d))
        return out

    def map_steps(self, fn):
        """As map_shards for a generator function ``fn``: this rank's
        shards' generators are advanced in turn, one step each, each under
        its device's scope, until every one has returned; their return
        values in shard order (None for another rank's shard). A shard's
        exception propagates."""
        steps = {i: fn(i, d) for i, d in enumerate(self.devices)
                 if self.mine[i]}
        out = [None] * len(self.devices)
        while steps:
            for i in list(steps):
                with _on(self.devices[i]):
                    try:
                        next(steps[i])
                    except StopIteration as stop:
                        out[i] = stop.value
                        del steps[i]
        return out

    def gather_shards(self, values):
        """Every shard's value in shard order, from ``values`` (this rank's
        shards' values, None for the others'): the list itself in one
        process; over several, every rank's gathered, another rank's
        tensors arriving as host tensors."""
        if not self.multi:
            return values
        mine = {i: dist.host(v) for i, v in enumerate(values)
                if self.mine[i]}
        out = list(values)
        for got in dist.gather_objects(mine):
            for i, v in got.items():
                if not self.mine[i]:
                    out[i] = _tensors(v)
        return out

    # ---- per-frequency tally: one dp-partial [CELLS, L] slab per shard
    def zeros_intf(self, cells, comps=0):
        """Zero slabs [CELLS, NFREQ/F(, comps)] float32, one per shard on
        its device, in shard order (soc_tpu's zeros_intf(cells, comps));
        another rank's shard gets a meta tensor of that shape."""
        shape = (cells, self.nf_local) + ((comps,) if comps else ())
        return [torch.zeros(shape, dtype=torch.float32,
                            device=d if self.mine[i] else "meta")
                for i, d in enumerate(self.devices)]

    def reduce_intf(self, slabs, device):
        """The slabs summed over dp (in dp order) and concatenated over
        freq in block order: [CELLS, NFREQ(, comps)] on ``device``, column
        fq*L + fl the global channel fq*L + fl. Over several processes
        each block is summed on the rank of its dp-0 slab and shared with
        every rank."""
        blocks = []
        for fq in range(self.n_freq):
            dst = self.owners[fq]
            acc = None
            for dp in range(self.n_dp):
                i = dp * self.n_freq + fq
                t = self._move(slabs[i], i, dst)
                if t is not None:
                    acc = t.to(device) if acc is None else acc + t.to(device)
            if self.multi:
                acc = dist.broadcast(acc, dst, slabs[fq].shape,
                                     torch.float32).to(device)
            blocks.append(acc)
        return torch.cat(blocks, 1)

    def _move(self, t, i, dst):
        """Shard i's tensor ``t`` onto rank ``dst`` (None elsewhere); in
        one process ``t`` itself."""
        if not self.multi:
            return t
        return dist.move(t, self.owners[i], dst, t.shape, t.dtype)

    def fold_intf(self, slabs, parts=None):
        """End of a sharded pass: each block's dp partials (``parts``, a
        pass's own slabs, else the slabs themselves past dp 0) added into
        its dp-0 slab in dp order; the slabs past dp 0 are left zero. The
        reduced tally is then the dp-0 slabs, and a run restored into them
        (scatter_intf) adds in the same order as one never stopped."""
        for fq in range(self.n_freq):
            acc = slabs[fq]
            for dp in range(0 if parts is not None else 1, self.n_dp):
                i = dp * self.n_freq + fq
                src = slabs[i] if parts is None else parts[i]
                t = self._move(src, i, self.owners[fq])
                if t is not None:
                    acc.add_(t.to(acc.device))
                if parts is None and self.mine[i]:
                    src.zero_()

    def scatter_intf(self, host, slabs):
        """A reduced [CELLS, NFREQ(, comps)] host tally (a checkpoint's)
        into this rank's slabs: block fq into its dp-0 slab, the others
        zero."""
        host = np.asarray(host, np.float32)
        for i, slab in enumerate(slabs):
            if not self.mine[i]:
                continue
            dp, fq = divmod(i, self.n_freq)
            if dp == 0:
                blk = host[:, fq * self.nf_local:(fq + 1) * self.nf_local]
                slab.copy_(torch.as_tensor(np.ascontiguousarray(blk)))
            else:
                slab.zero_()
        return slabs


def _tensors(value):
    """dist.host's NumPy arrays back as host tensors."""
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_tensors(v) for v in value)
    if isinstance(value, dict):
        return {k: _tensors(v) for k, v in value.items()}
    return value


def _to(tree, dev):
    """A dict's tensors on ``dev`` (the same tensor where it lies there)."""
    return {k: v.to(dev) if torch.is_tensor(v) else v
            for k, v in tree.items()}


def run_freqs(pm, grid, physics, kind, params, sel, counts, tabs, intf,
              seed, lanes, per_freq_tally, hi_base, maps=None, split_max=0,
              mirror_mask=0, roi=None, with_ali=False, col0=0):
    """The sharded transport of one source or cell pass; the one-device
    driver runs its pools here too, over a one-shard mesh (one_shard).

    Channel sel[j] carries counts[j] packets. Shard (dp, fq) drains one
    mixed-frequency pool over the channels of ``sel`` in its block
    fq*L .. fq*L + L - 1, with its part of each channel's budget: of
    c packets, q = c // n_dp each, the first c % n_dp shards one more,
    from within-channel index k0 = dp*q + min(dp, r). Its pool's
    parameters come from sources.pool_params, as the one-device pool's do,
    with hi_base the run's, so hi = hi_base + g for global channel g and
    every packet keeps its stream; the shard's slab takes the block's
    columns (tally_col0 = fq*L). ``maps`` (EMWEI) holds channel sel[j]'s
    id -> cell map; a shard takes the slice [k0, k0 + its count).
    soc_tpu runs the L channels of a shard as L uniform-frequency pools one
    after the other; here each such pool would drain its own tail of eager
    sweeps, and on one H100 the 132 pools of a six-shard mesh took 15x as
    long as one pool per shard (PERF.md). The tallies of the two forms
    differ only in the order of the additions. The shards' pools are
    stepped in turn (pm.map_steps).

    physics and params lie on tabs' device (copied to each other distinct
    device once a call); ``roi`` the ROI save's dict, its tally added to
    by every shard's own in shard order; with_ali the XAB tally of ALI,
    one per shard, summed in shard order. tabs [CELLS] on the caller's
    device, intf the slabs of pm.zeros_intf (ignored when per_freq_tally
    is False); ``col0`` the first channel of the slabs (a one-shard
    mesh's `mmapabs` block: its tally holds channels col0 ..). Each shard
    deposits into a TABS of its own: the pass's own TABS is their sum in
    shard order, added once to tabs, so it holds the pass's deposits
    exactly whatever tabs held before. Returns (tabs, intf, out) with out
    holding tabs (the pass's own), escaped, launched, missed [NFREQ]
    float64 host arrays, clones, pools, packets and xab ([CELLS] on tabs'
    device, with_ali).
    """
    from ..transport.sources import pool_params
    nfreq = pm.nfreq
    F, L, n_dp = pm.n_freq, pm.nf_local, pm.n_dp
    sel = np.asarray(sel, np.int64)
    counts = np.broadcast_to(np.asarray(counts, np.int64), sel.shape)
    plans = []
    for i in range(len(pm.devices)):
        dp, fq = divmod(i, F)
        m = (sel >= fq * L) & (sel < fq * L + L) & (counts > 0)
        q, r = np.divmod(counts[m], n_dp)
        mine = q + (dp < r)
        k0 = dp * q + np.minimum(dp, r)
        keep = mine > 0
        mp = None
        if maps is not None:
            mp = [mv[a:a + n] for mv, a, n, k in zip(
                [mv for mv, mm in zip(maps, m) if mm], k0, mine, keep) if k]
        plans.append((sel[m][keep], mine[keep], k0[keep], mp))
    total = max(int(p[1].sum()) for p in plans)
    own = torch.zeros_like(tabs)
    out = dict(tabs=own, escaped=np.zeros(nfreq), launched=np.zeros(nfreq),
               missed=np.zeros(nfreq), clones=0, pools=0,
               packets=int(sum(int(p[1].sum()) for p in plans)), xab=None)
    if total == 0:
        if with_ali:
            out["xab"] = torch.zeros_like(tabs)
        return tabs, intf, out
    nlanes = pool_lanes(lanes, total)
    copies = {}

    def shard(i, dev):
        chans, mine, k0, mp = plans[i]
        fq = i % F
        dtabs = torch.zeros(grid.cells, dtype=torch.float32, device=dev)
        if len(chans) == 0:
            return dtabs, None, None
        if dev not in copies:
            copies[dev] = (_to(physics, dev), _to(params, dev))
        phys, par = copies[dev]
        p = pool_params(par, chans, mine, hi_base, dev, k0=k0, maps=mp)
        sroi = None
        if roi is not None:
            sroi = dict(roi, mask=roi["mask"].to(dev),
                        tally=torch.zeros(roi["tally"].shape,
                                          dtype=torch.float32, device=dev))
        slab = intf[i] if per_freq_tally \
            else torch.zeros((1, 1), dtype=torch.float32, device=dev)
        res = yield from transport_steps(
            pm.replica(grid, dev), phys, p, int(mine.sum()), dtabs, slab,
            seed, source_kind=kind, nlanes=nlanes,
            per_freq_tally=per_freq_tally, with_ali=with_ali,
            split_max=split_max, births=True, mirror_mask=mirror_mask,
            roi=sroi, tally_col0=col0 + fq * L if per_freq_tally else 0)
        return dtabs, res, sroi

    def result(got):
        # what a shard hands on: its TABS and, if it ran a pool, its
        # vectors, XAB, clones and ROI tally (not its slab)
        if got is None:
            return None
        dtabs, res, sroi = got
        if res is None:
            return dtabs, None
        return dtabs, dict(
            escaped=res[2], launched=res[-2], missed=res[-1],
            xab=res[4] if with_ali else None,
            clones=int(res[5 if with_ali else 4]) if split_max > 0 else 0,
            roi=None if sroi is None else sroi["tally"])

    for dtabs, res in pm.gather_shards([result(g)
                                        for g in pm.map_steps(shard)]):
        own += dtabs.to(own.device)
        if res is None:
            continue
        out["pools"] += 1
        for k in ("escaped", "launched", "missed"):
            out[k] += res[k].cpu().numpy()
        if with_ali:
            x = res["xab"].to(tabs.device)
            out["xab"] = x if out["xab"] is None else out["xab"] + x
        out["clones"] += res["clones"]
        if res["roi"] is not None:
            roi["tally"].add_(res["roi"].to(roi["tally"].device))
    if with_ali and out["xab"] is None:
        out["xab"] = torch.zeros_like(tabs)
    return tabs + own, intf, out


def one_shard(device, nfreq):
    """The mesh of a one-device run: one shard, every channel, on
    ``device`` (the grid's own, so nothing is copied)."""
    return ProductMesh(1, nfreq, [device])


def solve_temperature(pm, grid, table, tabs, gl_pc_parsec, beta=1.0,
                      cr_heating=0.0):
    """Equilibrium temperature [CELLS] on tabs' device, the cells split
    into contiguous ranges over all shards and gathered onto every rank
    (elementwise, so equal to the one-device solve bit for bit); beta ALI's escape probability (a
    scalar or [CELLS]), cr_heating as equilibrium.temperature_lookup's."""
    lev = equilibrium.cell_levels(grid)
    ranges = shard_ranges(grid.cells, len(pm.devices))

    def shard(i, dev):
        c0, c1 = ranges[i]
        b = beta[c0:c1].to(dev) if torch.is_tensor(beta) else beta
        return equilibrium.temperature_lookup(
            pm.replica(table, dev), tabs[c0:c1].to(dev),
            pm.replica(grid, dev).dens[c0:c1], lev[c0:c1].to(dev),
            gl_pc_parsec, beta=b, cr_heating=cr_heating)

    return torch.cat([t.to(tabs.device)
                      for t in pm.gather_shards(pm.map_shards(shard))])


def emission(pm, freq, abs_gl, temperature, gl_pc_parsec):
    """Thermal emission [CELLS, NFREQ] on temperature's device, the cells
    split over all shards and gathered onto every rank (elementwise:
    equal to the one-device emission bit for bit)."""
    ranges = shard_ranges(temperature.shape[0], len(pm.devices))

    def shard(i, dev):
        c0, c1 = ranges[i]
        return equilibrium.emission(freq, abs_gl,
                                    temperature[c0:c1].to(dev), gl_pc_parsec)

    return torch.cat([e.to(temperature.device)
                      for e in pm.gather_shards(pm.map_shards(shard))])
