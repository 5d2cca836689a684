"""Multi-device execution: the product path behind the `devices N` ini
keyword (port of soc_tpu.parallel.product for the background source).

Layout. N devices form a (dp, freq) mesh, shard (dp, fq) on device
``devices[dp * F + fq]``:
  * 'freq': frequency channels are blocked over F shards; block fq owns
    the L = NFREQ/F channels fq*L .. fq*L + L - 1 and their [CELLS, L]
    per-frequency tally slab;
  * 'dp': each channel's packet budget is split over the n_dp = N/F shards
    of its block by id range. Every packet keeps the stream of the
    one-device run (streams are keyed by (phase|iteration|channel,
    index within the channel)), so the tallies match the one-device run up
    to the order of the float32 additions. Each shard drains one pool over
    its block (run_freqs says why not one per channel).

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

Not ported here: cell emission (`cellpackets` iterations, ALI,
WITH_REFERENCE, SUBITERATIONS), the other sources, ROI, checkpoints,
splitting and mirrors under `devices` (the driver still refuses them), and
soc_tpu's multi-host globalisation.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from ..rng import MASK32
from ..solve import equilibrium
from ..solve.a2e_kernel import shard_ranges
from ..transport.propagate import pool_lanes, transport_steps
from ..transport.sources import stream_hi_base


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
    shard's frequency loop); the rest is packet data-parallelism.
    devices: None for cuda:0 .. cuda:N-1 (raises when fewer cards are
    visible), or an explicit list of N devices, which may repeat one.
    """

    def __init__(self, n, nfreq, devices=None):
        if devices is None:
            visible = torch.cuda.device_count()
            if n > visible:
                raise ValueError("devices %d: only %d visible" % (n, visible))
            devices = [torch.device("cuda", i) for i in range(n)]
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError("devices %d: a list of %d devices was given"
                             % (n, len(devices)))
        f = max(d for d in range(1, n + 1) if n % d == 0 and nfreq % d == 0)
        self.n_dp = n // f
        self.n_freq = f
        self.nfreq = nfreq
        self.nf_local = nfreq // f
        self.devices = devices
        self._replicas = {}

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
        """[fn(i, device) for every shard i], one after the other in the
        calling thread, each under its device's scope; results in shard
        order. A shard's exception propagates."""
        out = []
        for i, d in enumerate(self.devices):
            with _on(d):
                out.append(fn(i, d))
        return out

    def map_steps(self, fn):
        """As map_shards for a generator function ``fn``: the shards'
        generators are advanced in turn, one step each, each under its
        device's scope, until every one has returned; their return values
        in shard order. A shard's exception propagates."""
        steps = {i: fn(i, d) for i, d in enumerate(self.devices)}
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

    # ---- per-frequency tally: one dp-partial [CELLS, L] slab per shard
    def zeros_intf(self, cells):
        """Zero slabs [CELLS, NFREQ/F] float32, one per shard on its
        device, in shard order."""
        return [torch.zeros((cells, self.nf_local), dtype=torch.float32,
                            device=d) for d in self.devices]

    def reduce_intf(self, slabs, device):
        """The slabs summed over dp (in dp order) and concatenated over
        freq in block order: [CELLS, NFREQ] on ``device``, column fq*L + fl
        the global channel fq*L + fl."""
        blocks = []
        for fq in range(self.n_freq):
            acc = slabs[fq].to(device)
            for dp in range(1, self.n_dp):
                acc = acc + slabs[dp * self.n_freq + fq].to(device)
            blocks.append(acc)
        return torch.cat(blocks, 1)


def run_freqs(pm, grid, medium, kind, photons, per_freq, tabs, intf, seed,
              lanes, per_freq_tally, phase=None, iteration=0, sel=None):
    """The sharded transport of one source over every channel.

    Shard (dp, fq) drains one mixed-frequency pool over the channels
    g = fq*L .. fq*L + L - 1 of its block, with its part of each channel's
    budget: of ``per_freq`` packets, q = per_freq // n_dp each, the first
    per_freq % n_dp shards one more, from within-channel index
    k0 = dp*q + min(dp, r). Its local channel fl = g - fq*L is its tally
    column, and hi_base = hi0 + fq*L makes hi = hi_base + fl the stream
    word hi0 + g of the one-device run, so every packet keeps its stream.
    soc_tpu runs the L channels of a shard as L uniform-frequency pools one
    after the other; here each such pool would drain its own tail of eager
    sweeps, and on one H100 the 132 pools of a six-shard mesh took 15x as
    long as one pool per shard (PERF.md). The tallies of the two forms
    differ only in the order of the additions.

    The shards' pools are stepped in turn (pm.map_steps). ``sel`` (the
    channels to simulate, all by default; `libabs`'s FSELECT) leaves the
    other channels out of every shard's pool, each kept channel's packets
    unchanged.

    photons [NFREQ] host array of per-packet weights; tabs [CELLS] on the
    caller's device; intf the slabs of pm.zeros_intf (ignored when
    per_freq_tally is False). Returns (tabs, intf, escaped [NFREQ]) with
    tabs added to: the shards' tallies summed in shard order.
    """
    nfreq = medium.nfreq
    F, L, n_dp = pm.n_freq, pm.nf_local, pm.n_dp
    total = int(per_freq)
    escaped = np.zeros(nfreq)
    if total <= 0:
        return tabs, intf, escaped
    hi0 = stream_hi_base(phase or kind, iteration)
    q, r = divmod(total, n_dp)
    keep = np.ones(nfreq, bool) if sel is None else np.isin(
        np.arange(nfreq), sel)
    nlanes = pool_lanes(lanes, (q + int(r > 0))
                        * max(int(keep[f * L:f * L + L].sum())
                              for f in range(F)))
    photons = np.asarray(photons, np.float32)

    def shard(i, dev):
        dp, fq = divmod(i, F)
        mine = q + int(dp < r)
        dtabs = torch.zeros(grid.cells, dtype=torch.float32, device=dev)
        local = np.nonzero(keep[fq * L:fq * L + L])[0]
        if mine == 0 or len(local) == 0:
            return dtabs, np.zeros(L)
        block = slice(fq * L, fq * L + L)
        med = pm.replica(medium, dev)
        physics = dict(kabs=med.abs_gl[block], ksca=med.sca_gl[block],
                       csc=med.csc[block], tw=med.tw[block])
        params = dict(photons=torch.as_tensor(photons[block], device=dev),
                      per_freq=mine, k0=dp * q + min(dp, r),
                      hi_base=(hi0 + fq * L) & MASK32)
        if len(local) < L:
            params["sel"] = torch.as_tensor(local, device=dev)
        slab = intf[i] if per_freq_tally \
            else torch.zeros((1, 1), dtype=torch.float32, device=dev)
        _, _, esc, _ = yield from transport_steps(
            pm.replica(grid, dev), physics, params, mine * len(local), dtabs,
            slab,
            seed, source_kind=kind, nlanes=nlanes,
            per_freq_tally=per_freq_tally)
        return dtabs, esc.cpu().numpy()

    for i, (dtabs, esc) in enumerate(pm.map_steps(shard)):
        fq = i % F
        tabs = tabs + dtabs.to(tabs.device)
        escaped[fq * L:fq * L + L] += esc
    return tabs, intf, escaped


def solve_temperature(pm, grid, table, tabs, gl_pc_parsec, cr_heating=0.0):
    """Equilibrium temperature [CELLS] on tabs' device, the cells split
    into contiguous ranges over all shards (elementwise, so equal to the
    one-device solve bit for bit); cr_heating as
    equilibrium.temperature_lookup's."""
    lev = equilibrium.cell_levels(grid)
    ranges = shard_ranges(grid.cells, len(pm.devices))

    def shard(i, dev):
        c0, c1 = ranges[i]
        return equilibrium.temperature_lookup(
            pm.replica(table, dev), tabs[c0:c1].to(dev),
            pm.replica(grid, dev).dens[c0:c1], lev[c0:c1].to(dev),
            gl_pc_parsec, cr_heating=cr_heating)

    return torch.cat([t.to(tabs.device) for t in pm.map_shards(shard)])


def emission(pm, freq, abs_gl, temperature, gl_pc_parsec):
    """Thermal emission [CELLS, NFREQ] on temperature's device, the cells
    split over all shards (elementwise: equal to the one-device emission
    bit for bit)."""
    ranges = shard_ranges(temperature.shape[0], len(pm.devices))

    def shard(i, dev):
        c0, c1 = ranges[i]
        return equilibrium.emission(freq, abs_gl,
                                    temperature[c0:c1].to(dev), gl_pc_parsec)

    return torch.cat([e.to(temperature.device)
                      for e in pm.map_shards(shard)])
