"""End-to-end emission radiative transfer (port of soc_tpu.pipeline.driver
for clouds heated by constant sources, octrees included, with the dust's
self-heating).

Phases:
  1. the constant sources, each in one mixed-frequency packet pool over
     the simulated channels (`simum`): the isotropic background (`split`
     on refined clouds), the Healpix sky (`hpbg`, `hpbgw`), point sources
     (`pointsource`, PS_METHOD 0-5), the diffuse emission (`diffuse`)
     and the ROI boundary source (`roiload`) -> TABS (+ per-frequency
     absorptions, or with `saveint 2` the (I, Ix, Iy, Iz) tally); or TABS
     read from a `cload` file. With `abundance` (WITH_ABU, and MSF with a
     dsc file a dust) every transport pass takes per-cell cross sections,
     in bfloat16 under `optishalf`. Every pass takes the `mirror` faces
     and the `stepweight` / `direweight` weighting; `roi` + `roisave`
     histogram the packets entering the ROI box into the ROI file. With
     `mmapabs` (or a tally larger than SOC_TPU_TALLY_BYTES) the
     per-frequency tally lives in a host memmap and each pass runs one
     pool per block of channels whose tally fits the budget (HostTally)
  2. iterations: the dust's own emission re-emitted as cell packets
     (`cellpackets`, with EMWEI, ALI and the WITH_REFERENCE delta field;
     each pass one mixed-frequency pool over (cell, channel)),
     the equilibrium temperature solve and the thermal emission; or the
     SUBITERATIONS hot/cold schedule; or, with `loadtemp`, the emission of
     a stored temperature field
  3. maps: orthographic (map_dir_XX.bin, with `mapint`, `yshear`, FITS
     and `savetau`), Healpix all-sky (map.healpix, `interpolate`),
     perspective, MAP_HIER by level (map_dir_XX_H.bin), `roimap`'s gate,
     the point sources' `pssavetau` text files, and the polarization
     maps of `polmap` (Stokes I/Q/U/N, POLSTAT 1-3 statistics,
     orthographic and Healpix; render/polarization.py)
`CR_HEATING` adds its cosmic-ray rate to every temperature solve.
With `libabs` phase 1 simulates only the FSELECT reference channels and
the run stops after it, writing their absorptions (the library's input,
pipeline/full.py's uselib mode); with `libmaps` the maps render the
FSELECT channels, embedding an emitted file of those columns only.
With `devices N` (or an explicit device list) phases 1 and 2, the
temperature solves and phase 3 run over a (dp x freq) mesh of devices
(parallel/product.py): each transport pass with the channels blocked over
freq and each channel's budget split over dp, every source and keyword as
on one device; the solve with the cells split; phase 3 with the map's
rows and channels split.
With `domains N` (or an explicit list of N devices) the transport of
phases 1 and 2 runs over N Z-slabs of the grid, one a device
(parallel/domain.py): each slab steps the packets inside it and hands
those that cross a slab face to its neighbour; the solves, the A2E stage
and the maps run on the run's device. soc_tpu's refusals stand under it:
`roi`, SUBITERATIONS, `checkpoint`, `mmapabs` and `devices`.
Several processes (parallel/dist.py, the CLI's SOC_TPU_COORDINATOR,
SOC_TPU_NUM_PROCESSES and SOC_TPU_PROCESS_ID): `devices N` spans every
process's devices (N < 0 all of them), each process steps its own shards
and every one holds the same RunResult; process 0 alone writes the run's
files (soc_tpu has every process write them). The sharded map is off
there (every process renders the map whole, as soc_tpu's does), and
`domains` is refused.
With `checkpoint <file> [N]` (utils/checkpoint.py) the tallies and the
completed units (a source or cell pass, an mmapabs block, a pass over the
mesh, an iteration's state) are written to the file every N units; the same command run again resumes after the last
unit written, and a run that is never stopped gives the same outputs.
Outputs keep the reference's binary formats; nothing is silently
ignored.
"""

import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import RunConfig
from ..constants import FACTOR, PARSEC, PLANCK, f2um
from ..io.dust import read_scattering_function, read_simple_dust
from ..io.fits import write_fits_image
from ..io.fields import (read_background_intensity,
                         read_cell_frequency_array,
                         write_cell_frequency_array, write_map_file)

from ..grid import Grid
from ..io.cloud import read_cloud, read_hierarchy, write_cell_field
from ..render import mapping as render_mapping
from ..solve import equilibrium
from ..transport.medium import medium_from_optics
from ..transport import sources
from ..transport.roi import (read_roi_file, roi_cell_mask, roi_nelem,
                             write_roi_file)
from ..transport.sources import stream_hi_base
from ..utils import trace

# lanes of the packet pool: eager sweeps cost the same number of launches
# at any width, so a wider pool is cheaper per packet until the drain tail
# (the last, long-lived packets) dominates; 2^21 was the fastest of
# 2^19..2^22 on the 43M-packet soc_example-sized run on an H100
DEFAULT_LANES = 1 << 21
EMWEI2_STEP = 100      # EMWEI mode 2's packet quantum (ASOC.py:79)
HOT_LIMIT = 30.0       # SUBITERATIONS: cells at or above it [K] are hot
# pass_balance: channels carrying less than this share of the largest
# channel's weight are held relative to that share
BALANCE_FLOOR = 1e-12
# `mmapabs` without SOC_TPU_TALLY_BYTES: the device block of the host tally
MMAP_BLOCK_BYTES = 1 << 30


@dataclass
class RunResult:
    grid: Grid = None
    medium: object = None               # transport.medium.Medium
    seed: int = 0                       # the run's RNG seed
    freq: np.ndarray = None
    ctabs: np.ndarray = None            # integrated constant-source heating
    absorbed: np.ndarray = None         # [CELLS, NFREQ] (file scaling applied)
    temperature: np.ndarray = None      # [CELLS]
    emitted: np.ndarray = None          # [CELLS, NFREQ]
    pemitted: np.ndarray = None         # pipeline's polarised emission
    maps: dict = field(default_factory=dict)       # idir -> [NF, NY, NX]
    tau_maps: dict = field(default_factory=dict)   # idir -> [NF, NY, NX]
    render_passes: list = field(default_factory=list)  # a dict a render
    roi_tally: np.ndarray = None        # roisave's [NFREQ, NELEM * NPIX]
    intensity: np.ndarray = None        # saveint's [CELLS, NFREQ(, 4)]
    escaped: np.ndarray = None          # [NFREQ] photons that left the volume
    injected: np.ndarray = None         # [NFREQ] photons injected
    absorbed_photons: np.ndarray = None  # [NFREQ] photons absorbed (raw)
    launched: np.ndarray = None         # [NFREQ] phase 1's packet weights
    missed: np.ndarray = None           # [NFREQ] of those born outside
    packets: int = 0                   # packets traced in phase 1
    source_passes: list = field(default_factory=list)  # a dict a source
    cell_passes: list = field(default_factory=list)  # one dict a cell pass
    devices: list = None                # the product mesh's devices, or None
    domains: list = None                # the slabs' devices, or None
    checkpoint: object = None           # the run's RunCheckpoint, or None
    timings: dict = field(default_factory=dict)


_EXCLUSIVE = ("`devices` and `domains` are mutually exclusive: pick "
              "packet/frequency sharding or Z-slab decomposition")


def check_supported(cfg, devices=None, domains=None):
    """soc_tpu's refusal of `devices` with `domains` (the ini's keywords,
    or run's lists)."""
    if (int(cfg.n_domains) > 1 or domains is not None) \
            and (int(cfg.n_devices) not in (0, 1) or devices is not None):
        raise ValueError(_EXCLUSIVE)


def run(ini_path=None, cfg=None, device=None, lanes=DEFAULT_LANES,
        write_files=True, workdir=None, devices=None, domains=None,
        emitted=None):
    """Full run of one ini on ``device``; returns RunResult. workdir
    defaults to the ini's directory. ``devices``, a list of devices (which
    may repeat one), runs the product path over them in place of the
    ini's `devices N`; ``domains``, a list of devices (which may repeat
    one), the Z-slab path in place of the ini's `domains N`. The outputs
    are gathered on ``device``. ``emitted``, an [CELLS, NFREQ] array (or
    its remit or FSELECT columns), is the map-only mode's emission in
    place of the ini's emitted file (the pipeline's map run takes it from
    memory). Under several processes (parallel/dist.py) only process 0
    writes files."""
    from ..parallel import dist
    if device is None:
        raise ValueError("run: pass the device explicitly ('cuda' or 'cpu')")
    device = torch.device(device)
    t_start = time.time()
    if cfg is None:
        cfg = RunConfig(ini_path)
    if workdir is None:
        workdir = os.path.dirname(os.path.abspath(ini_path)) if ini_path \
            else "."
    write_files = write_files and dist.process_index() == 0
    orig = os.getcwd()
    os.chdir(workdir)
    try:
        with trace.run("driver.run"):
            return _run_inner(cfg, device, lanes, write_files, t_start,
                              devices, domains, emitted)
    finally:
        os.chdir(orig)


def mirror_mask_of(cfg):
    """'mirror xXyYzZ' keyword -> 6-bit mask (ASOC.py:321-324)."""
    m = 0
    for bit, ch in enumerate("xXyYzZ"):
        if ch in cfg.mirror:
            m |= 1 << bit
    return m


class HostTally:
    """The out-of-core per-frequency tally of `mmapabs` (and of a tally
    larger than SOC_TPU_TALLY_BYTES): [CELLS, NFREQ(, 4)] float32 in a
    host np.memmap whose scratch file is unlinked at once, as the
    reference mmaps FABSORBED (ASOC.py:39-42, 623-638). soc_tpu streams
    one [CELLS] column a channel; here a pass runs one pool per block of
    channels whose [CELLS, block] device tally fits ``budget`` bytes and
    flushes each block into the memmap (``blocks``)."""

    def __init__(self, shape, budget, device):
        tf = tempfile.NamedTemporaryFile(prefix=".fabsorbed.",
                                         suffix=".tally", dir=".",
                                         delete=False)
        tf.close()
        self.host = np.memmap(tf.name, dtype=np.float32, mode="w+",
                              shape=shape)
        os.unlink(tf.name)
        self.device = device
        col = int(np.prod(shape)) // shape[1] * 4
        self.cols = max(1, int(budget) // col)

    def blocks(self, channels, after=None):
        """Yields (channels of the block, its device tally [CELLS, NB(, 4)]
        of channels col0 .. col0 + NB - 1, col0); each block is added into
        the memmap when the caller's body for it is done, then
        ``after(channels of the block)`` is called."""
        channels = np.asarray(channels)
        host = self.host
        for i in range(0, len(channels), self.cols):
            chunk = channels[i:i + self.cols]
            c0, ncol = int(chunk[0]), int(chunk[-1] - chunk[0] + 1)
            dev = torch.zeros((host.shape[0], ncol) + host.shape[2:],
                              dtype=torch.float32, device=self.device)
            yield chunk, dev, c0
            host[:, c0:c0 + ncol] += dev.cpu().numpy()
            if after is not None:
                after(chunk)


def _tally_blocks(intf, channels, fresh=False, after=None, pmesh=None):
    """The per-frequency tallies a pass over ``channels`` adds into, as
    (channels, tally, col0): a HostTally's device blocks; over a mesh its
    slabs, each block's dp partials folded into its dp-0 slab afterwards;
    else intf itself. With ``fresh`` the pass adds into a tally of its own
    (over a mesh slabs of its own), added into intf afterwards: a cell
    pass, whose absorption is held to its own. ``after(channels)`` is
    called once a block's deposits are in intf (a checkpoint records its
    unit there)."""
    if isinstance(intf, HostTally):
        yield from intf.blocks(channels, after)
        return
    if isinstance(intf, list):
        own = intf
        if fresh:
            comps = intf[0].shape[2] if intf[0].ndim == 3 else 0
            own = pmesh.zeros_intf(intf[0].shape[0], comps)
        yield channels, own, 0
        pmesh.fold_intf(intf, parts=own if fresh else None)
    elif fresh:
        own = torch.zeros_like(intf)
        yield channels, own, 0
        intf.add_(own)
    else:
        yield channels, intf, 0
    if after is not None:
        after(channels)


def _intf_snapshot(intf, pmesh=None):
    """The per-frequency tally a checkpoint holds: the HostTally's memmap,
    over a mesh the reduced slabs (on the host), else intf."""
    if isinstance(intf, HostTally):
        return intf.host
    if isinstance(intf, list):
        return pmesh.reduce_intf(intf, torch.device("cpu"))
    return intf


def _units(intf, channels, key, ckpt, skip, record, fresh=False,
           pmesh=None):
    """The checkpoint units of one pass over ``channels``, as (key, the
    unit's channels, its tally, col0) from _tally_blocks: the pass is one
    unit ``key``; under `mmapabs` each HostTally block is one, keyed
    "<key>/f<first channel>". A unit the checkpoint holds is not yielded:
    skip(key) is called instead. record(key) is called once a yielded
    unit's deposits are in intf. Without a checkpoint neither is."""
    blocked = isinstance(intf, HostTally)
    ran = []

    def after(chans):
        if ran:
            record(ran.pop())

    for chans, tally, col0 in _tally_blocks(
            intf, channels, fresh, None if ckpt is None else after, pmesh):
        ukey = "%s/f%d" % (key, chans[0]) if blocked else key
        if ckpt is not None and ckpt.completed(ukey):
            skip(ukey)
            continue
        yield ukey, chans, tally, col0
        ran.append(ukey)


def _tally_mesh(layout):
    """The ProductMesh whose shards hold the per-frequency tally in slabs
    of their own, or None: one device, or Z-slabs (a DomainSet, whose
    passes add into the one tally on the run's device)."""
    from ..parallel.product import ProductMesh
    return layout if isinstance(layout, ProductMesh) else None


def _pass_absorbed(tally, col0, pm):
    """Per channel, float64, the absorption a pass's own per-frequency
    tally holds (a tensor from column col0, or over a mesh its slabs,
    every rank's summed in shard order)."""
    out = np.zeros(pm.nfreq)
    slabs = tally if isinstance(tally, list) else [tally]
    sums = pm.gather_shards([
        None if slab.is_meta else _absorbed_of(slab).sum(
            0, dtype=torch.float64).cpu().numpy() for slab in slabs])
    for i, (slab, part) in enumerate(zip(slabs, sums)):
        c = col0 + (i % pm.n_freq) * slab.shape[1]
        out[c:c + slab.shape[1]] += np.asarray(part)
    return out


def _host_tally(cfg, grid, nfreq, device, pmesh, dset=None):
    """A HostTally when `mmapabs` asks for one or the per-frequency tally
    exceeds SOC_TPU_TALLY_BYTES (never over a mesh; refused under
    domains, as soc_tpu refuses it), else None."""
    if pmesh is not None:
        return None
    shape = (grid.cells, nfreq) + ((4,) if cfg.save_intensity == 2 else ())
    need = 4 * int(np.prod(shape))
    budget = int(float(os.environ.get("SOC_TPU_TALLY_BYTES", "0") or 0))
    if not (cfg.mmap_absorbed or (budget and need > budget)):
        return None
    if dset is not None:
        raise ValueError("mmapabs under `domains` is not supported; use "
                         "`devices` (the freq-sharded tally)")
    return HostTally(shape, budget or MMAP_BLOCK_BYTES, device)


def remit_mask_of(cfg, freq):
    """bool[NFREQ]: frequencies inside the `remit` re-emission band."""
    return (np.asarray(freq) >= cfg.remit_f[0]) \
        & (np.asarray(freq) <= cfg.remit_f[1])


def nearest_freq_mask(freq, values):
    """bool[NFREQ] with the channel nearest each value set."""
    freq = np.asarray(freq)
    mask = np.zeros(len(freq), bool)
    for fv in values:
        mask[int(np.argmin(np.abs(freq - fv)))] = True
    return mask


def map_freq_mask(cfg, freq):
    """Map-frequency selection: the `wavelength` band, `mapum` single
    frequencies, or libmaps' FSELECT (ASOC.py:3003-3075)."""
    freq = np.asarray(freq)
    if cfg.lib_maps and cfg.fselect:
        return nearest_freq_mask(freq, cfg.fselect)
    if cfg.single_map_freq:
        return nearest_freq_mask(freq, cfg.single_map_freq)
    return (freq >= cfg.map_freq[0]) & (freq <= cfg.map_freq[1])


def _scale_absorbed(grid, tally, gl_cm, nnn_limit=0.0, block=1 << 20):
    """Per-frequency tallies -> absorbed.data payload, in place over blocks
    of rows of the float32 host array ``tally`` (the in-memory tally's host
    copy, or the `mmapabs` memmap, where a scaled copy of [CELLS, NFREQ]
    would defeat the point): scale by 8^level*FACTOR/(GL*PARSEC)/DENS in
    float64, mark parent cells -1e20, and cells with DENS <= nnn_limit the
    same way. Returns ``tally``."""
    lev = equilibrium.cell_levels(grid).cpu().numpy()
    dens = grid.dens.cpu().numpy()
    coeff = (8.0 ** lev) * (FACTOR / gl_cm)
    bad = dens <= max(0.0, nnn_limit)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = coeff / np.maximum(dens, 1e-35)
    # link and parent rows become -1e20 below; zeroing their scale first
    # keeps the float32 cast finite
    scale[bad] = 0.0
    for i0 in range(0, tally.shape[0], block):
        i1 = min(i0 + block, tally.shape[0])
        tally[i0:i1] = tally[i0:i1] * scale[i0:i1, None]
        tally[i0:i1][bad[i0:i1]] = -1.0e20
    return tally


def _write_emitted_file(cfg, freq, emitted):
    """emitted.data with the reference ABI: only the REMIT-band columns."""
    mask = remit_mask_of(cfg, freq)
    with trace.span("io.write"):
        write_cell_frequency_array(cfg.file_emitted,
                                   np.asarray(emitted)[:, mask])


def _physics(medium, physics_extra=None):
    """The transport's physics dict: the medium's tables, plus the
    per-cell tables of `abundance` when given."""
    out = dict(kabs=medium.abs_gl, ksca=medium.sca_gl, csc=medium.csc,
               tw=medium.tw)
    if physics_extra:
        out.update(physics_extra)
    return out


def _source_pass(grid, medium, kind, phase, params, counts, sel, tabs, intf,
                 seed, lanes, per_freq_tally, physics_extra=None,
                 split_max=0, mirror_mask=0, roi=None, pmesh=None,
                 ckpt=None):
    """One phase-1 source as one mixed-frequency pool over the channels
    ``sel``, counts[j] packets in channel sel[j] (channels with none are
    left out): soc_tpu runs a pool a channel here, and the packet
    identities (hi = stream_hi_base(phase) + channel, k the id within the
    channel) are the same, so the pool traces the same packets with one
    drain tail. Under `mmapabs` (intf a HostTally) one pool a block of
    channels; over a mesh (``pmesh`` a ProductMesh, intf its slabs) one
    pool a shard; over Z-slabs (``pmesh`` a DomainSet) the same pool, and
    the stats add its 'domain' numbers. Each runs through the layout's
    run_freqs, one device as a one-shard mesh.
    params['cell_maps'] (EMWEI) holds one id -> cell map a channel of sel,
    joined end to end for the pool. ``roi``: the ROI save's crossing
    tally (transport_run). ``ckpt``: the run's checkpoint; the pass
    (under `mmapabs` each block) is a unit (_units), skipped when the
    checkpoint holds it (its deposits are in the restored tallies) and
    recorded once its deposits are in them. Returns (tabs, intf, stats):
    the source's route, pools, packets, seconds, clones and, per channel
    in float64, the weights escaped, launched and born outside the grid,
    and its absorbed energy (the sum and the per-cell TABS it added, a
    host array, the pass's own: exact whatever tabs held before);
    ``restored`` when a unit came from the checkpoint."""
    timing = {}
    with trace.span("transport.pass", into=timing, key="seconds",
                    source=phase, levels=grid.levels) as sp:
        tabs, intf, stats = _source_pass_run(
            grid, medium, kind, phase, params, counts, sel, tabs, intf, seed,
            lanes, per_freq_tally, physics_extra, split_max, mirror_mask,
            roi, pmesh, ckpt)
        sp.set(packets=stats["packets"])
    if stats["pools"]:
        stats["seconds"] = timing["seconds"]
    return tabs, intf, stats


def _source_pass_run(grid, medium, kind, phase, params, counts, sel, tabs,
                     intf, seed, lanes, per_freq_tally, physics_extra,
                     split_max, mirror_mask, roi, pmesh, ckpt):
    """_source_pass's work; its caller times it (the span
    `transport.pass`, whose end is the pass's ``seconds``)."""
    from ..parallel import product
    nfreq = medium.nfreq
    mesh = _tally_mesh(pmesh)
    sel = np.asarray(sel, np.int64)
    counts = np.broadcast_to(np.asarray(counts, np.int64), sel.shape)
    keep = counts > 0
    params = dict(params)
    maps = params.pop("cell_maps", None)
    if maps is not None:
        maps = [m for m, k in zip(maps, keep) if k]
    sel, counts = sel[keep], counts[keep]
    total = int(counts.sum())
    zero = np.zeros(nfreq)
    stats = dict(source=phase, route="mixed" if pmesh is None
                 else pmesh.route,
                 pools=0, packets=total, clones=0, seconds=0.0,
                 escaped=zero, launched=zero, missed=zero,
                 absorbed_energy=0.0, tabs=None, restored=False,
                 slabs=getattr(pmesh, "n_slabs", 0))
    if total == 0:
        return tabs, intf, stats
    vec = dict(escaped=zero.copy(), launched=zero.copy(),
               missed=zero.copy())
    pm = pmesh or product.one_shard(grid.device, nfreq)
    physics = _physics(medium, physics_extra)
    own = torch.zeros_like(tabs)
    units = {}

    def skip(key):
        for k, v in ckpt.skipped(key).items():
            if k in vec:
                vec[k] += v
        stats["restored"] = True

    def record(key):
        ckpt.record(key, units.pop(key), tabs=tabs,
                    intf=_intf_snapshot(intf, mesh),
                    roi=None if roi is None else roi["tally"])

    for key, chans, tally, col0 in _units(intf, sel, phase, ckpt, skip,
                                          record, pmesh=mesh):
        m = np.isin(sel, chans)
        tabs, _, out = pm.run_freqs(
            grid, physics, kind, params, sel[m], counts[m], tabs,
            tally if mesh is not None else [tally], seed, lanes,
            per_freq_tally, stream_hi_base(phase), split_max=split_max,
            maps=None if maps is None else [mp for mp, k in zip(maps, m)
                                            if k],
            mirror_mask=mirror_mask, roi=roi, col0=col0)
        own += out["tabs"]
        units[key] = {k: out[k] for k in vec}
        for k in vec:
            vec[k] += out[k]
        stats["clones"] += out["clones"]
        stats["pools"] += out["pools"]
        if out.get("domain"):
            stats["domain"] = out["domain"]
    if stats["pools"] == 0:         # every unit came from the checkpoint
        stats.update(vec)
        return tabs, intf, stats
    stats.update(absorbed_energy=float(own.sum(dtype=torch.float64)),
                 tabs=own.cpu().numpy(), **vec)
    return tabs, intf, stats


def split_max_of(cfg, grid):
    """In-flight splitting applies only on refined (multi-level) clouds
    (SimBgSplit/SimHpSplit, kernel_ASOC.c:2121-3554)."""
    return int(cfg.do_split) if grid.levels > 1 else 0


def simulate_background(grid, medium, cfg, ibg, tabs, intf, seed,
                        lanes=DEFAULT_LANES, per_freq_tally=False,
                        pmesh=None, sel=None, physics_extra=None,
                        split_max=0, passes=None, roi=None, ckpt=None):
    """Phase-1 isotropic background over the channels ``sel`` (all by
    default), in one mixed pool; with ``pmesh`` (`devices N`) over the
    mesh, one pool per shard (product.run_freqs), intf then the mesh's
    slabs, with ``pmesh`` a DomainSet (`domains N`) over its Z-slabs;
    ``ckpt`` the run's checkpoint (_source_pass). The reference
    sends 8*AREA*BATCH packets per frequency; the same normalisation
    keeps the tallies comparable. The pass's stats (_source_pass) go to
    ``passes`` when given. Returns
    (tabs, intf, escaped[NF], injected[NF], packets)."""
    area = int(grid.area)
    batch = max(1, int(round(cfg.bgpac / (8.0 * area))))
    per_freq = 8 * area * batch                 # packets per frequency
    wbg = np.pi / (PLANCK * 8.0 * batch)
    bg_photons = (np.asarray(ibg, np.float64) * wbg
                  / np.asarray(cfg.freq, np.float64)).astype(np.float32)
    nfreq = medium.nfreq
    sel = np.arange(nfreq) if sel is None else np.asarray(sel)
    injected = _only(np.float64(per_freq)
                     * np.asarray(bg_photons, np.float64), sel)
    params = dict(photons=torch.as_tensor(bg_photons, device=grid.device))
    tabs, intf, st = _source_pass(
        grid, medium, "bg", "bg", params, per_freq, sel, tabs, intf, seed,
        lanes, per_freq_tally, physics_extra, split_max,
        mirror_mask_of(cfg), roi, pmesh, ckpt)
    st["injected"] = injected
    if passes is not None:
        passes.append(st)
    return tabs, intf, st["escaped"], injected, st["packets"]


def _only(values, sel):
    """values [NFREQ] with the channels outside sel zeroed."""
    out = np.zeros_like(values)
    out[sel] = values[sel]
    return out


def simulate_hpbg(grid, medium, cfg, hpbg, tabs, intf, seed,
                  lanes=DEFAULT_LANES, per_freq_tally=False, weighted=False,
                  sel=None, physics_extra=None, split_max=0, passes=None,
                  roi=None, pmesh=None, ckpt=None):
    """Phase-1 Healpix-sky background (SimRAM_HP), soc_tpu's
    simulate_hpbg in one mixed pool over the channels ``sel``.

    hpbg : [NFREQ, NPIX] sky intensities; photons a packet =
    (pi AREA / (PLANCK BGPAC)) / freq * HPBG[pix] (ASOC.py:1050-1063);
    ``weighted`` (`hpbgw`) draws pixels with probability ~ HPBG clipped
    to 1e-3..1e4 of its mean and corrects the weights by
    (1/NPIX) / p(pixel). Returns (tabs, intf, escaped[NF], injected[NF])
    and appends its stats to ``passes``."""
    area = grid.area
    per_freq = max(1, int(cfg.bgpac))
    wbg = np.pi * area / (PLANCK * per_freq)
    nfreq = medium.nfreq
    freq = np.asarray(cfg.freq, np.float64)
    sel = np.arange(nfreq) if sel is None else np.asarray(sel)
    npx = hpbg.shape[1]
    table = np.zeros((nfreq, npx), np.float32)
    injected = np.zeros(nfreq)
    cdf = None
    if weighted:
        # channel f's float32 cdf at 2 f + cdf_f in float64 (exact), so
        # one sorted search serves every lane in its own channel
        cdf = np.repeat(2.0 * np.arange(nfreq), npx).reshape(nfreq, npx)
    for i in sel:
        vals = np.asarray(hpbg[i], np.float64) * (wbg / freq[i])
        if weighted:
            p = vals / max(vals.mean(), 1e-300)
            p = np.clip(p, 1e-3, 1e4)
            p /= p.sum()
            w = (1.0 / npx) / p                  # packet weight correction
            c = np.cumsum(p)
            c[-1] = 1.00001
            table[i] = (vals * w).astype(np.float32)
            cdf[i] += c.astype(np.float32)
            injected[i] = np.sum(p * (vals * w))
        else:
            table[i] = vals.astype(np.float32)
            injected[i] = float(np.asarray(hpbg[i], np.float64).mean()
                                * (wbg / freq[i]))
    device = grid.device
    params = dict(hpbg=torch.as_tensor(table, device=device))
    if weighted:
        params["cdf"] = torch.as_tensor(cdf.reshape(-1), device=device)
    tabs, intf, st = _source_pass(
        grid, medium, "hpbg", "hpbg", params, per_freq, sel, tabs, intf,
        seed, lanes, per_freq_tally, physics_extra, split_max,
        mirror_mask_of(cfg), roi, pmesh, ckpt)
    st["injected"] = injected * per_freq
    if passes is not None:
        passes.append(st)
    return tabs, intf, st["escaped"], st["injected"]


def point_source_tables(grid, cfg):
    """The PS_METHOD's host tables for gen_point_source (NumPy)."""
    if cfg.ps_method == 2:
        nside, side, area = sources.analyse_external_point_sources(
            grid, cfg.ps_pos)
        return dict(xps_nside=nside, xps_side=side, xps_area=area)
    if cfg.ps_method == 3:
        bins3, prob3 = sources.healpix_visibility(grid, cfg.ps_pos)
        return dict(ps3_pix=bins3, ps3_p=prob3)
    if cfg.ps_method in (4, 5):
        side, cone = sources.illumination_cones(grid, cfg.ps_pos)
        return dict(cone_side=side, cone_cos=cone)
    if cfg.ps_method == 1:
        return dict(halfspace=1)
    return {}


def simulate_point_sources(grid, medium, cfg, lps, tabs, intf, seed,
                           lanes=DEFAULT_LANES, per_freq_tally=False,
                           sel=None, physics_extra=None, passes=None,
                           roi=None, pmesh=None, ckpt=None):
    """Phase-1 point sources (soc_tpu's simulate_point_sources) in one
    mixed pool over the channels ``sel``: PSPAC packets a source and a
    channel, photons = L / (PLANCK PSPAC (GL PARSEC)^2) / freq, the
    PS_METHOD's tables for external sources. Returns
    (tabs, intf, escaped[NF], injected[NF]) and appends its stats to
    ``passes``."""
    nfreq = medium.nfreq
    if cfg.no_ps < 1 or cfg.pspac < 1:
        return tabs, intf, np.zeros(nfreq), np.zeros(nfreq)
    pspac = max(1, cfg.pspac)
    wps = 1.0 / (PLANCK * pspac * (cfg.gl * PARSEC) ** 2)
    freq = np.asarray(cfg.freq, np.float64)
    ps_photons = (np.asarray(lps, np.float64) * wps
                  / freq[None, :]).astype(np.float32)    # [NO_PS, NFREQ]
    sel = np.arange(nfreq) if sel is None else np.asarray(sel)
    device = grid.device
    params = dict(ps_pos=torch.as_tensor(np.asarray(cfg.ps_pos, np.float32),
                                         device=device),
                  photons=torch.as_tensor(ps_photons, device=device))
    with trace.span("sources.ps_tables", method=cfg.ps_method):
        tables = point_source_tables(grid, cfg)
    for k, v in tables.items():
        params[k] = v if k == "halfspace" else torch.as_tensor(
            v, device=device)
    tabs, intf, st = _source_pass(
        grid, medium, "ps", "ps", params, pspac * cfg.no_ps, sel, tabs,
        intf, seed, lanes, per_freq_tally, physics_extra,
        mirror_mask=mirror_mask_of(cfg), roi=roi, pmesh=pmesh, ckpt=ckpt)
    st["injected"] = _only(
        np.sum(np.asarray(ps_photons, np.float64), axis=0) * pspac, sel)
    if passes is not None:
        passes.append(st)
    return tabs, intf, st["escaped"], st["injected"]


def read_diffuse_field(path, cells):
    """Read the diffuse-emission file: int32 [CELLS, NF'] header + float32
    payload, photons/Hz/cm^3 per cell (mmap_diffuserad,
    ASOC_aux.py:839-868). NF' may be smaller than NFREQ; the stored values
    are then the highest frequencies."""
    with open(path, "rb") as fp:
        c, nf = np.fromfile(fp, np.int32, 2)
        if c != cells:
            raise ValueError("%s: %d cells != model %d" % (path, c, cells))
        data = np.fromfile(fp, np.float32).reshape(int(c), int(nf))
    return data


def simulate_diffuse(grid, medium, cfg, diffuserad, tabs, intf, seed,
                     lanes=DEFAULT_LANES, per_freq_tally=False, sel=None,
                     physics_extra=None, passes=None, roi=None, pmesh=None,
                     ckpt=None):
    """Phase-1 diffuse volume emission (SimRAM_CL SOURCE==2, ASOC.py:
    1250-1272), soc_tpu's simulate_diffuse in one mixed pool.

    diffuserad : [CELLS, NF'] photons/Hz/cm^3, aligned on the highest
    frequencies. A cell's photon load is DIFFUSERAD * K_DIFFUSE *
    GL*PARSEC / 8^level (the cell-volume weighting); DFPAC (else CLPAC)
    // CELLS packets a cell, or with `emweight` soc_tpu's phase-1 EMWEI
    allocation (clip and roulette, a Philox generator keyed by the seed,
    one allocation every EMWEIGHT_SKIP-th simulated channel), the
    channels' id -> cell maps end to end. Returns
    (tabs, intf, escaped[NF], injected[NF]) and appends its stats to
    ``passes``."""
    nfreq = medium.nfreq
    cells = grid.cells
    nf_d = diffuserad.shape[1]
    dfpac = cfg.dfpac if cfg.dfpac > 0 else cfg.clpac
    per_cell = max(1, int(dfpac) // cells)
    per_freq = per_cell * cells
    lev = equilibrium.cell_levels(grid).cpu().numpy()
    coeff = (cfg.k_diffuse * cfg.gl * PARSEC / 8.0 ** lev).astype(np.float64)
    injected = np.zeros(nfreq)
    use_ew = cfg.use_emweight > 0
    cols_np = {}               # float64 columns kept only for EMWEI
    emit = np.zeros((cells, nfreq), np.float32)
    mask = np.zeros(nfreq, bool)
    for ifreq in range(nfreq):
        dr_ind = ifreq + (nf_d - nfreq)     # highest frequencies stored
        if dr_ind < 0:
            continue
        col = np.asarray(diffuserad[:, dr_ind], np.float64) * coeff
        if use_ew:
            cols_np[ifreq] = col
        emit[:, ifreq] = (col / per_cell).astype(np.float32)
        injected[ifreq] = col.sum()
        mask[ifreq] = True
    if sel is not None:
        mask &= np.isin(np.arange(nfreq), sel)
    injected[~mask] = 0.0
    sel = np.nonzero(mask)[0]
    device = grid.device
    params = dict(per_cell=per_cell)
    counts = per_freq
    if use_ew:
        # EMWEI on the diffuse source (ASOC.py:1277-1292: clip and
        # roulette only, budget DFPAC, EMWEIGHT_SKIP reuse over the
        # simulated channels)
        rng = np.random.Generator(np.random.Philox(
            key=np.uint64([int(seed) & 0xFFFFFFFF, 0xD1FF])))
        last = None
        skipn = max(1, int(cfg.emweight_skip))
        maps, counts = [], []
        for kth, i in enumerate(sel):
            if last is None or kth % skipn == 0:
                last = emweight_allocation(
                    cols_np[i], int(dfpac), lims=cfg.emweight_lim[:2],
                    rng=rng)
            cell_of_id, weight, total = last
            emit[:, i] = (cols_np[i] * weight).astype(np.float32)
            maps.append(cell_of_id)
            counts.append(total)
        params = dict(cell_maps=maps)
    params["emit"] = torch.as_tensor(emit, device=device)
    tabs, intf, st = _source_pass(
        grid, medium, "cell", "diffuse", params, counts, sel, tabs, intf,
        seed, lanes, per_freq_tally, physics_extra,
        mirror_mask=mirror_mask_of(cfg), roi=roi, pmesh=pmesh, ckpt=ckpt)
    if use_ew and pmesh is None:
        st["route"] = "emweight"
    st["injected"] = injected
    if passes is not None:
        passes.append(st)
    return tabs, intf, st["escaped"], injected


def simulate_roi_load(grid, medium, cfg, tabs, intf, seed,
                      lanes=DEFAULT_LANES, per_freq_tally=False, sel=None,
                      passes=None, pmesh=None, ckpt=None):
    """Phase-1 ROI boundary source (SOURCE==3, kernel_ASOC.c:469-505), in
    one mixed pool over the channels ``sel``: the (surface element x
    Healpix direction) photons of a previous run's `roisave` file,
    re-injected into this (sub-)model, `roipackets` // (NELEM NPIX)
    packets a pair (at least one), each load times `roiload`'s scale.
    As soc_tpu, without the run's per-cell or weighting physics and
    without splitting. Returns (tabs, intf, escaped[NF], injected[NF])
    and appends its stats to ``passes``."""
    rnx, rny, rnz, nside, data = read_roi_file(cfg.file_roi_load)
    nfreq = medium.nfreq
    if data.shape[0] != nfreq:
        raise ValueError("%s: %d freqs != model %d"
                         % (cfg.file_roi_load, data.shape[0], nfreq))
    npx = 12 * nside * nside
    nelem = data.shape[1] // npx
    reps = max(1, int(cfg.roipac) // (nelem * npx))
    per_freq = reps * nelem * npx
    load = np.asarray(data, np.float64) * cfg.roi_load_scale
    sel = np.arange(nfreq) if sel is None else np.asarray(sel)
    injected = _only(load.sum(1), sel)
    params = dict(roi_load=torch.as_tensor(
        load.astype(np.float32).reshape(nfreq, nelem, npx),
        device=grid.device), roi_dim=(rnx, rny, rnz), reps=reps)
    tabs, intf, st = _source_pass(
        grid, medium, "roi", "roi", params, per_freq, sel, tabs, intf, seed,
        lanes, per_freq_tally, mirror_mask=mirror_mask_of(cfg), pmesh=pmesh,
        ckpt=ckpt)
    st["injected"] = injected
    if passes is not None:
        passes.append(st)
    return tabs, intf, st["escaped"], injected


def roi_save_setup(cfg, grid, nfreq):
    """The ROI save's crossing tally (`roi` + `roisave`, the driver.py
    :1324-1340 of soc_tpu), or None: the box's cell mask, its limits, its
    discretisation (rnx, rny, rnz, step) and the device tally
    [NFREQ, NELEM * 12 NSIDE^2]."""
    if cfg.roi is None or not cfg.file_roi_save:
        return None
    step = cfg.roi_step
    x0, x1, y0, y1, z0, z1 = cfg.roi
    rnx, rny, rnz = ((x1 - x0 + 1) * step, (y1 - y0 + 1) * step,
                     (z1 - z0 + 1) * step)
    nside = int(cfg.roi_nside)
    device = grid.device
    return dict(nside=nside, box=tuple(float(v) for v in cfg.roi),
                mask=torch.as_tensor(roi_cell_mask(grid, cfg.roi),
                                     device=device),
                dim=(rnx, rny, rnz, float(step)),
                tally=torch.zeros((nfreq, roi_nelem(rnx, rny, rnz) * 12
                                   * nside * nside), dtype=torch.float32,
                                  device=device))


def emweight_allocation(emit_col, clpac, lims=(0.0, 1e10), rng=None,
                        mode=1):
    """Emission-weighted packets per cell (EMWEI), NumPy, soc_tpu's code.
    Returns (cell_of_id, weight[CELLS], total_packets).

    mode 1 (ASOC.py:1276-1298): packets ~ the cell's share of the total
    emission, clipped to lims[:2]; cells below one packet survive Russian
    roulette with probability EMWEI and carry weight 1/EMWEI; lims[2] > 0
    afterwards drops every cell whose (post-roulette) EMWEI falls below
    it (ASOC.py:1770-1772).

    mode 2 (USE_EMWEIGHT==2, ASOC.py:1773-1789): deterministic quotas,
    packets per cell = EMWEI2_STEP * round(share / EMWEI2_STEP) of the
    unclipped share, weight = 1/packets.
    """
    emit_col = np.asarray(emit_col, np.float64)
    cells = len(emit_col)
    raw = clpac * emit_col / max(emit_col.sum(), 1e-32)
    if mode == 2:
        counts = (EMWEI2_STEP
                  * np.round(raw / EMWEI2_STEP)).astype(np.int64)
        counts = np.maximum(counts, 0)
        weight = np.zeros(cells, np.float64)
        m = counts > 0
        weight[m] = 1.0 / counts[m]
        cell_of_id = np.repeat(np.arange(cells, dtype=np.int32), counts)
        return cell_of_id, weight.astype(np.float32), len(cell_of_id)
    wei = np.clip(raw, lims[0], lims[1])
    frac = wei < 1.0
    if rng is None:
        rng = np.random.default_rng(1234)
    survive = frac & (rng.random(cells) < wei)
    eff = np.where(frac, np.where(survive, wei, 0.0), wei)
    if len(lims) > 2 and lims[2] > 0.0:
        eff = np.where(eff < lims[2], 0.0, eff)
    counts = np.where(eff <= 0.0, 0,
                      np.where(eff < 1.0, 1,
                               np.floor(eff).astype(np.int64)))
    weight = np.zeros(cells, np.float64)
    m = counts > 0
    weight[m & (eff >= 1.0)] = 1.0 / counts[m & (eff >= 1.0)]
    weight[m & (eff < 1.0)] = 1.0 / np.maximum(eff[m & (eff < 1.0)], 1e-30)
    cell_of_id = np.repeat(np.arange(cells, dtype=np.int32), counts)
    return cell_of_id, weight.astype(np.float32), len(cell_of_id)


def _emweight_allocs(emitted_np, cfg, rng, nfreq):
    """Per-frequency EMWEI allocations, recomputed at every
    EMWEIGHT_SKIP-th channel and reused in between (ASOC.py:1643,
    1750-1752): the per-packet weight EMIT_f[cell] * weight keeps the
    estimator exact whichever column built the counts."""
    allocs = {}
    last = None
    skipn = max(1, int(cfg.emweight_skip))
    for i in range(nfreq):
        if last is None or i % skipn == 0:
            last = emweight_allocation(emitted_np[:, i], int(cfg.clpac),
                                       lims=cfg.emweight_lim, rng=rng,
                                       mode=cfg.use_emweight)
        allocs[i] = last
    return allocs


def _cell_source(cfg, grid, emitted, seed, iteration, nfreq):
    """The packets of a cell pass as (route, params, sel, counts, maps,
    injected, injected_abs): the source's parameters, the channels that
    launch, counts[j] packets in channel sel[j], EMWEI's id -> cell maps
    and the weight each channel injects (signed and absolute, float64 on
    the device). Routes, as soc_tpu's one-device driver takes them:
      * EMWEI (`emweight`): the allocations drawn on the host, from a
        Philox generator keyed by (seed, iteration), for every channel
        before the pass (so a resumed pass draws the same ones); a
        channel with none launches nothing;
      * ALI (`ali`): max(1, CLPAC // CELLS) packets a cell; a channel that
        emits nothing (outside `remit`'s band) launches nothing: its
        packets would carry zero weight, as EMWEI's empty allocations do;
      * otherwise the same packets a cell in every channel."""
    device = grid.device
    per_cell = max(1, int(cfg.clpac) // grid.cells)
    per_freq = per_cell * grid.cells
    sel, counts, maps = np.arange(nfreq), per_freq, None
    if cfg.use_emweight > 0:
        route = "emweight"
        rng = np.random.Generator(np.random.Philox(
            key=np.uint64([int(seed) & 0xFFFFFFFF, iteration])))
        allocs = _emweight_allocs(emitted.cpu().numpy(), cfg, rng, nfreq)
        sel = np.asarray([f for f in range(nfreq) if allocs[f][2] > 0],
                         np.int64)
        counts = [allocs[f][2] for f in sel]
        maps = [allocs[f][0] for f in sel]
        emit = emitted * torch.as_tensor(np.stack(
            [allocs[f][1] for f in range(nfreq)], 1), device=device)
        w = torch.zeros_like(emit, dtype=torch.float64)
        for f in sel:
            w[:, f] = torch.as_tensor(np.bincount(
                allocs[f][0], minlength=grid.cells),
                device=device) * emit[:, f].double()
        params = dict(emit=emit)
    else:
        if cfg.with_ali:
            route = "ali"
            emit = emitted / np.float32(per_cell)
            sel = np.nonzero(emit.ne(0).any(0).cpu().numpy())[0]
        else:
            route = "mixed"
            emit = emitted * np.float32(1.0 / per_cell)
        w = per_cell * emit.double()
        params = dict(emit=emit, per_cell=per_cell)
    return route, params, sel, counts, maps, w.sum(0), w.abs().sum(0)


def simulate_cell_emission(grid, medium, cfg, emitted, tabs, intf, seed,
                           lanes=DEFAULT_LANES, per_freq_tally=False,
                           iteration=0, physics_extra=None, pmesh=None,
                           ckpt=None):
    """Phase-2 dust re-emission (SimRAM_CL), one pass.

    emitted : [CELLS, NFREQ] photons/Hz/H per cell (a device tensor; a
    delta field under WITH_REFERENCE, so weights may be negative). The
    routes (plain, ALI, EMWEI: _cell_source) all run as one
    mixed-frequency pool over (cell, channel), so a pass pays its drain
    tail once; over a mesh (``pmesh``) one pool a shard; both through
    product.run_freqs, one device as a one-shard mesh. Packets keep
    soc_tpu's identity, hi = stream_hi_base("cell", iteration) + channel
    and k the id within the channel, so every route reproduces each
    packet's path (soc_tpu runs ALI and EMWEI a pool a channel): EMWEI
    with the channels' maps end to end, ALI with the lane's emitting cell
    in the XAB tally (so a mixed pool keeps the self-absorption exact),
    each shard's XAB summed in shard order. Over Z-slabs (``pmesh`` a
    DomainSet) its run_freqs runs the same pool.

    With per-frequency tallies the pass adds into a [CELLS, NFREQ] tally
    of its own, then into intf: its absorption per channel is then held
    in float32 relative to itself, not to the tally it joins. Under
    `mmapabs` (intf a HostTally) one pool a block of channels.

    ``ckpt``: the run's checkpoint. The pass is a unit ("it%d"; under
    `mmapabs` each block, "it%d/f%d"), recorded with the pass's partial
    tally (p2_tabs, with ALI p2_xab) and the per-frequency tally as it
    stands; a resumed pass starts from them and skips its completed
    units.

    Returns (tabs, intf, escaped [NFREQ], xab [CELLS] host array or None,
    stats): stats holds the pass's route, pools, packets, seconds and,
    per channel in float64, the weight injected (signed and absolute),
    escaped and, with per-frequency tallies, absorbed; over Z-slabs the
    slab count and domain.run_freqs's 'domain' numbers.
    """
    timing = {}
    with trace.span("transport.pass", into=timing, key="seconds",
                    source="cell", levels=grid.levels) as sp:
        out = _cell_emission_run(grid, medium, cfg, emitted, tabs, intf,
                                 seed, lanes, per_freq_tally, iteration,
                                 physics_extra, pmesh, ckpt)
        sp.set(packets=out[4]["packets"])
    out[4]["seconds"] = timing["seconds"]
    return out


def _cell_emission_run(grid, medium, cfg, emitted, tabs, intf, seed, lanes,
                       per_freq_tally, iteration, physics_extra, pmesh,
                       ckpt):
    """simulate_cell_emission's work; its caller times it (the span
    `transport.pass`, whose end is the pass's ``seconds``)."""
    from ..parallel import product
    device = grid.device
    nfreq = medium.nfreq
    mesh = _tally_mesh(pmesh)
    one = product.one_shard(device, nfreq)
    physics = _physics(medium, physics_extra)
    emitted = torch.as_tensor(emitted, device=device)
    route, params, sel, counts, maps, injected, inj_abs = _cell_source(
        cfg, grid, emitted, seed, iteration, nfreq)
    counts = np.broadcast_to(np.asarray(counts, np.int64), sel.shape)
    escaped = np.zeros(nfreq)
    absorbed = np.zeros(nfreq)
    # the vectors of the units a resumed pass skips
    restored = dict(escaped=np.zeros(nfreq), absorbed=np.zeros(nfreq))
    pools = packets = 0
    key = "it%d" % iteration
    resumed = ckpt is not None and any(
        d == key or d.startswith(key + "/") for d in ckpt.done)
    if resumed:
        tabs = torch.tensor(ckpt.saved("p2_tabs"), device=device)
    xab = None
    if route == "ali":
        xab = torch.zeros(grid.cells, dtype=torch.float32, device=device)
        if resumed and ckpt.saved("p2_xab") is not None:
            xab = torch.tensor(ckpt.saved("p2_xab"), device=device)
    units = {}
    dstats = None

    def skip(ukey):
        for k, v in ckpt.skipped(ukey).items():
            if k in restored:
                restored[k] += v

    def record(ukey):
        if ukey in units:
            ckpt.record(ukey, units.pop(ukey), p2_tabs=tabs, p2_xab=xab,
                        intf=_intf_snapshot(intf, mesh))

    for ukey, chans, tally, col0 in _units(
            intf, np.arange(nfreq), key, ckpt, skip, record,
            fresh=per_freq_tally, pmesh=mesh):
        m = np.isin(sel, chans)
        if not m.any():
            continue
        tabs, _, out = (pmesh or one).run_freqs(
            grid, physics, "cell", params, sel[m], counts[m], tabs,
            tally if mesh is not None else [tally], seed, lanes,
            per_freq_tally, stream_hi_base("cell", iteration),
            maps=None if maps is None else [mp for mp, k in zip(maps, m)
                                            if k],
            mirror_mask=mirror_mask_of(cfg), with_ali=route == "ali",
            col0=col0)
        if route == "ali":
            xab = xab + out["xab"]
        dstats = out.get("domain") or dstats
        ab = _pass_absorbed(tally, col0, mesh or one) if per_freq_tally \
            else np.zeros(nfreq)
        escaped += out["escaped"]
        absorbed += ab
        pools += out["pools"]
        packets += out["packets"]
        vec = dict(escaped=out["escaped"], absorbed=ab,
                   injected=np.zeros(nfreq), injected_abs=np.zeros(nfreq))
        vec["injected"][chans] = injected.cpu().numpy()[chans]
        vec["injected_abs"][chans] = inj_abs.cpu().numpy()[chans]
        units[ukey] = vec
    if xab is not None:
        xab = xab.cpu().numpy()
    escaped = escaped + restored["escaped"]
    absorbed = absorbed + restored["absorbed"]
    stats = dict(iteration=iteration, route=route, pools=pools,
                 packets=packets, injected=injected.cpu().numpy(),
                 injected_abs=inj_abs.cpu().numpy(), escaped=escaped,
                 absorbed=absorbed if per_freq_tally else None,
                 mesh=mesh is not None, restored=resumed,
                 slabs=getattr(pmesh, "n_slabs", 0))
    if dstats is not None:
        stats["domain"] = dstats
    return tabs, intf, escaped, xab, stats


def pass_balance(stats):
    """Per channel, (absorbed + escaped - injected) of a cell pass over
    its absolute injected weight: signed sums, so that a WITH_REFERENCE
    delta pass with its negative weights is held too. A channel carrying
    less than BALANCE_FLOOR of the largest channel's weight is divided by
    that share instead: its packets' weights sit near float32's denormal
    range, where deposits round away."""
    ia = np.asarray(stats["injected_abs"])
    den = np.maximum(ia, BALANCE_FLOOR * ia.max())
    err = stats["absorbed"] + stats["escaped"] - stats["injected"]
    return np.where(den > 0, err / np.where(den > 0, den, 1.0), 0.0)


def _product_setup(cfg, nfreq, device, devices=None):
    """The (dp x freq) mesh of the product path, or None for a one-device
    run: over ``devices`` when given, else over the ini's `devices N`
    (cuda:0 .. cuda:N-1 on a card, the CPU N times on the CPU; N < 0 means
    every visible card). Under several processes N counts the global
    device list (dist.global_devices: every process's cards, or its CPU
    shards), N < 0 all of it, and a device list is refused: it names one
    process's devices."""
    from ..parallel import dist
    from ..parallel.product import ProductMesh
    if devices is not None:
        if dist.process_count() > 1:
            raise ValueError(
                "devices: a device list names one process's devices; "
                "under %d processes use the ini's `devices N`"
                % dist.process_count())
        return ProductMesh(len(devices), nfreq, devices) \
            if len(devices) > 1 else None
    n = int(cfg.n_devices)
    if dist.process_count() > 1:
        if n == 0 or n == 1:
            return None
        devs, owners = dist.global_devices(device, n)
        if n < 0:
            n = len(devs)
        if n > len(devs):
            raise ValueError("devices %d: only %d visible" % (n, len(devs)))
        return ProductMesh(n, nfreq, devs[:n], owners=owners[:n]) \
            if n > 1 else None
    if n < 0:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n <= 1:
        return None
    return ProductMesh(n, nfreq, [device] * n if device.type == "cpu"
                       else None)


def _domain_setup(cfg, grid, device, domains=None):
    """The Z-slab decomposition of `domains N` (soc_tpu driver.py:975-1004)
    as a parallel.domain.DomainSet, or None: over ``domains`` when given,
    else cuda:0 .. cuda:N-1 (raises when fewer are visible), the CPU N
    times on the CPU; N <= 1 means none. `roi`, SUBITERATIONS and
    `checkpoint` are refused with soc_tpu's words (`mmapabs`: _host_tally;
    an NZ that N does not divide: split_grid_slabs)."""
    from ..parallel import dist
    from ..parallel.domain import DomainSet
    if dist.process_count() > 1 and (domains is not None
                                     or int(cfg.n_domains) > 1):
        # soc_tpu's Z-slab path fetches slab tallies that span the other
        # processes' devices and raises; this one refuses before it runs
        raise ValueError("domains %d: not supported over %d processes "
                         "(run it in one process, or use `devices`)"
                         % (len(domains) if domains is not None
                            else int(cfg.n_domains), dist.process_count()))
    if domains is None:
        n = int(cfg.n_domains)
        if n <= 1:
            return None
        if device.type == "cpu":
            domains = [device] * n
        else:
            visible = torch.cuda.device_count()
            if visible < n:
                raise ValueError("domains %d: only %d devices visible"
                                 % (n, visible))
            domains = [torch.device("cuda", i) for i in range(n)]
    if len(domains) <= 1:
        return None
    for bad, name in ((cfg.roi, "roi (crossing histograms need global "
                       "root coordinates; use `devices`)"),
                      (cfg.has_key("SUBITERATIONS"), "SUBITERATIONS "
                       "(use `devices`)"),
                      (cfg.file_checkpoint, "checkpoint (use `devices`)")):
        if bad:
            raise ValueError("domains: `%s` is not supported under "
                             "domain decomposition" % name)
    return DomainSet(grid, domains)


def _checkpoint_setup(cfg, nfreq, pmesh, host):
    """The run's RunCheckpoint: the fingerprint takes the mesh's layout
    and the mmapabs block width, which shape the units, and the process
    count: a device name is one process's (each rank's cuda:0 is another
    card), so a layout over P processes is never taken for one over
    another count. Under several processes every rank reads the file and
    process 0 alone writes it; they meet at a barrier before any unit
    runs, so no rank reads a file written by this run."""
    from ..parallel import dist
    from ..utils.checkpoint import RunCheckpoint, fingerprint_of
    layout = "one" if pmesh is None else "mesh %d x %d (%s)" % (
        pmesh.n_dp, pmesh.n_freq, ",".join(map(str, pmesh.devices)))
    if host is not None:
        layout += " blocks of %d" % host.cols
    if dist.process_count() > 1:
        layout += " over %d processes" % dist.process_count()
    ckpt = RunCheckpoint(cfg.file_checkpoint, cfg.checkpoint_every,
                         fingerprint_of(cfg, layout), nfreq,
                         write=dist.process_index() == 0)
    dist.barrier()
    return ckpt


def _restore(ckpt, tabs, intf, roi, pmesh):
    """The tallies of a resumed run, in place of the fresh ones: TABS, the
    per-frequency tally (the HostTally's memmap; over a mesh into the
    dp-0 slabs, the others zero, as soc_tpu driver.py:1402-1407 does) and
    the ROI save's crossing tally."""
    saved_tabs, saved = ckpt.restore(None, None)
    if saved_tabs is None:
        return tabs, intf
    tabs = torch.tensor(saved_tabs, device=tabs.device)
    if isinstance(intf, HostTally):
        intf.host[:] = saved
    elif isinstance(intf, list):
        pmesh.scatter_intf(saved, intf)
    else:
        intf.copy_(torch.as_tensor(saved))
    if roi is not None:
        roi["tally"].copy_(torch.as_tensor(ckpt.restore_roi(roi["tally"])))
    return tabs, intf


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_inner(cfg, device, lanes, write_files, t_start, devices, domains,
               emitted_in=None):
    cfg.validate()
    check_supported(cfg, devices, domains)
    res = RunResult()
    timings = res.timings

    # ---- model input
    with trace.span("driver.input", into=timings, key="input"):
        grid = read_cloud(cfg.file_cloud, device, cfg.kdensity,
                          cfg.max_levels)
        optics = [read_simple_dust(f, cfg.gl) for f in cfg.file_optical]
        freq = optics[0].freq
        cfg.freq = freq
        cfg.nfreq = len(freq)
        nfreq = len(freq)
        bins = cfg.dsc_bins if cfg.dsc_bins > 0 else 2500
        abu = read_abundances(cfg, grid.cells, len(optics))
        # MSF takes one scattering function a dust; otherwise only the first
        # file is read
        scafuncs = [read_scattering_function(f, nfreq, bins)
                    for f in (cfg.file_scafunc if abu is not None
                              else cfg.file_scafunc[:1])]
        dsc, csc = scafuncs[0]
        medium = medium_from_optics(optics, dsc, csc, device, freq)
        pmesh = _product_setup(cfg, nfreq, device, devices)
        physics_extra = {**(abundance_physics(cfg, optics, scafuncs, abu,
                                              device) or {}),
                         **weighting_physics(cfg, medium, abu)} or None
        res.grid, res.medium, res.freq = grid, medium, freq
        res.devices = None if pmesh is None else pmesh.devices
        seed = res.seed = int(np.uint32(max(0.0, cfg.seed) * 2**31)
                              + np.uint32(12345))
    gl_cm = cfg.gl * PARSEC
    if write_files:
        np.asarray([cfg.bgpac, cfg.pspac, cfg.dfpac, cfg.clpac],
                   np.int32).tofile("packet.info")

    # ---- loadtemp mode (ASOC.py:744-769): the emission of a stored
    # temperature field, then the maps
    if cfg.load_temperature and cfg.iterations < 1:
        _, _, _, _, vals = read_hierarchy(cfg.file_temperature)
        temperature = torch.as_tensor(np.concatenate(vals), device=device)
        res.temperature = temperature.cpu().numpy()
        emitted = _remit_band(cfg, freq, equilibrium.emission(
            freq, optics[0].abs_gl, temperature, gl_cm))
        res.emitted = emitted.cpu().numpy()
        res.ctabs = np.zeros(grid.cells, np.float32)
        res.escaped = np.zeros(nfreq)
        res.injected = np.zeros(nfreq)
        if write_files and cfg.file_emitted:
            _write_emitted_file(cfg, freq, res.emitted)
        # as soc_tpu, the loadtemp and map-only modes render with the
        # medium's extinction, not WITH_ABU's per-cell one
        _render_phase(cfg, grid, medium, res, freq, emitted, write_files,
                      timings, pmesh)
        timings["total"] = time.time() - t_start
        return res

    # ---- map-only mode (iterations 0 + an existing emitted file, or the
    # caller's emission)
    if cfg.iterations < 1 and (emitted_in is not None
                               or os.path.exists(cfg.file_emitted)):
        emitted = read_cell_frequency_array(cfg.file_emitted) \
            if emitted_in is None else np.asarray(emitted_in, np.float32)
        if emitted.shape[1] != nfreq:
            # a remit-band (or libmaps FSELECT) file: embed into the full
            # frequency grid
            mask = remit_mask_of(cfg, freq)
            if cfg.lib_maps and cfg.fselect:
                mask = nearest_freq_mask(freq, cfg.fselect)
            if mask.sum() != emitted.shape[1]:
                raise ValueError(
                    "emitted file has %d freqs; the remit/libmaps selection "
                    "has %d" % (emitted.shape[1], int(mask.sum())))
            full = np.zeros((emitted.shape[0], nfreq), np.float32)
            full[:, mask] = emitted
            emitted = full
        res.emitted = emitted
        res.ctabs = np.zeros(grid.cells, np.float32)
        res.escaped = np.zeros(nfreq)
        res.injected = np.zeros(nfreq)
        _render_phase(cfg, grid, medium, res, freq, res.emitted,
                      write_files, timings, pmesh)
        timings["total"] = time.time() - t_start
        return res

    # ---- phase 1: the constant sources
    with trace.span("driver.sources", into=timings, key="constant_sources"):
        dset = _domain_setup(cfg, grid, device, domains)
        res.domains = None if dset is None else dset.devices
        per_freq_tally = (not cfg.noabsorbed) or cfg.save_intensity > 0
        tabs = torch.zeros(grid.cells, dtype=torch.float32, device=device)
        host = _host_tally(cfg, grid, nfreq, device, pmesh, dset) \
            if per_freq_tally else None
        if pmesh is not None and per_freq_tally:
            # dp-partial per-frequency slabs, one per shard on its device
            # (under `mmapabs` too: the slabs take the host tally's place)
            intf = pmesh.zeros_intf(grid.cells,
                                    4 if cfg.save_intensity == 2 else 0)
        elif host is not None:
            intf = host
        else:
            shape = (1, 1)
            if cfg.save_intensity == 2:
                shape = (grid.cells, nfreq, 4)      # (I, Ix, Iy, Iz)
            elif per_freq_tally:
                shape = (grid.cells, nfreq)
            intf = torch.zeros(shape, dtype=torch.float32, device=device)
        # `simum`: only the channels inside the band are simulated; `libabs`:
        # of those only the FSELECT reference frequencies (ASOC.py:63-65,
        # 1126-1131)
        sim = (freq >= cfg.sim_f[0]) & (freq <= cfg.sim_f[1])
        if cfg.lib_abs and cfg.fselect:
            sim &= nearest_freq_mask(freq, cfg.fselect)
        sel = np.nonzero(sim)[0]
        escaped = np.zeros(nfreq)
        injected = np.zeros(nfreq)
        packets = 0
        roi = roi_save_setup(cfg, grid, nfreq)
        ckpt = None
        if cfg.file_checkpoint:
            ckpt = _checkpoint_setup(cfg, nfreq, pmesh, host)
            tabs, intf = _restore(ckpt, tabs, intf, roi, pmesh)
        res.checkpoint = ckpt
        kw = dict(sel=sel, physics_extra=physics_extra,
                  passes=res.source_passes, roi=roi, pmesh=dset or pmesh,
                  ckpt=ckpt)
        split_max = split_max_of(cfg, grid)
        if cfg.file_constant_load:
            # CLOAD: the constant sources are not simulated; their integrated
            # heating comes from a previous run's csave file
            # (ASOC.py:1013-1020)
            tabs = torch.as_tensor(np.fromfile(cfg.file_constant_load,
                                               np.float32, grid.cells),
                                   device=device)
        else:
            if cfg.bgpac > 0 and cfg.file_background:
                ibg = read_background_intensity(cfg.file_background, nfreq)
                ibg = ibg * cfg.scale_background
                tabs, intf, esc, inj, packets = simulate_background(
                    grid, medium, cfg, ibg, tabs, intf, seed, lanes,
                    per_freq_tally, split_max=split_max, **kw)
                escaped += esc
                injected += inj
            if cfg.bgpac > 0 and cfg.file_hpbg:
                hpbg = np.fromfile(cfg.file_hpbg,
                                   np.float32).reshape(nfreq, -1)
                hpbg = hpbg * cfg.scale_background
                tabs, intf, esc, inj = simulate_hpbg(
                    grid, medium, cfg, hpbg, tabs, intf, seed + 3, lanes,
                    per_freq_tally, cfg.has_key("hpbgw"), split_max=split_max,
                    **kw)
                escaped += esc
                injected += inj
            if cfg.no_ps > 0 and cfg.pspac > 0:
                lps = np.zeros((cfg.no_ps, nfreq), np.float32)
                for i, f in enumerate(cfg.file_pointsource):
                    lps[i] = np.fromfile(f, np.float32, nfreq) \
                        * cfg.ps_scale[i]
                tabs, intf, esc, inj = simulate_point_sources(
                    grid, medium, cfg, lps, tabs, intf, seed, lanes,
                    per_freq_tally, **kw)
                escaped += esc
                injected += inj
            if cfg.file_diffuse and (cfg.dfpac > 0 or cfg.clpac > 0):
                diffuserad = read_diffuse_field(cfg.file_diffuse, grid.cells)
                tabs, intf, esc, inj = simulate_diffuse(
                    grid, medium, cfg, diffuserad, tabs, intf, seed + 5, lanes,
                    per_freq_tally, **kw)
                escaped += esc
                injected += inj
            if cfg.file_roi_load and cfg.roipac > 0:
                tabs, intf, esc, inj = simulate_roi_load(
                    grid, medium, cfg, tabs, intf, seed + 9, lanes,
                    per_freq_tally, sel, res.source_passes, dset or pmesh,
                    ckpt)
                escaped += esc
                injected += inj
        if ckpt is not None and ckpt.pending:
            # the end of phase 1 (soc_tpu driver.py:1470-1480)
            ckpt.flush(tabs=tabs, intf=_intf_snapshot(intf, pmesh),
                       roi=None if roi is None else roi["tally"])
        _sync(device)
        # traced in phase 1
        res.packets = sum(st["packets"] for st in res.source_passes) \
            if res.source_passes else packets
        res.ctabs = tabs.cpu().numpy()
        res.escaped = escaped
        res.injected = injected
        if res.source_passes:
            res.launched = sum(st["launched"] for st in res.source_passes)
            res.missed = sum(st["missed"] for st in res.source_passes)
        if write_files and cfg.file_constant_save:
            # CSAVE: bare float32 [CELLS] integrated constant heating
            res.ctabs.astype(np.float32).tofile(cfg.file_constant_save)
        if roi is not None:
            res.roi_tally = roi["tally"].cpu().numpy()
            if write_files:
                rnx, rny, rnz, _ = roi["dim"]
                write_roi_file(cfg.file_roi_save, rnx, rny, rnz, roi["nside"],
                               res.roi_tally)

    if cfg.lib_abs:
        # `libabs`: the absorptions of the FSELECT frequencies, then stop
        # (ASOC.py:63-65); res.absorbed keeps every column, the file only
        # the FSELECT ones, for the library (A2E_LIB) to take over
        with trace.span("driver.outputs", into=timings, key="outputs"):
            if pmesh is not None and per_freq_tally:
                intf = pmesh.reduce_intf(intf, device)
            if per_freq_tally:
                with trace.span("driver.readback"):
                    absorbed = _absorbed_of(
                        intf.host if isinstance(intf, HostTally) else intf)
                    host = absorbed if isinstance(absorbed, np.ndarray) \
                        else np.array(absorbed.cpu().numpy(), np.float32)
                    res.absorbed = _scale_absorbed(grid, host, gl_cm,
                                                   cfg.nnn_limit)
                if write_files and cfg.file_absorbed:
                    write_cell_frequency_array(
                        cfg.file_absorbed,
                        res.absorbed[:, nearest_freq_mask(freq, cfg.fselect)])
        timings["total"] = time.time() - t_start
        return res

    # ---- phase 2: iterations (T solve + emission, optional self-heating)
    temperature = None
    emitted = None
    with trace.span("driver.solve", into=timings, key="solve"):
        if not cfg.nosolve and cfg.iterations >= 1:
            table = equilibrium.build_temperature_table(
                freq, optics[0].abs_gl, cfg.gl, device)
            # SUBITERATIONS is refused under domains (_domain_setup)
            phase2 = _subiterations if cfg.has_key("SUBITERATIONS") \
                else _iterations
            temperature, emitted, intf = phase2(
                cfg, grid, medium, optics, table, tabs, intf, seed, lanes,
                per_freq_tally, freq, gl_cm, write_files, res,
                dset or pmesh, physics_extra, ckpt)
            res.temperature = temperature.cpu().numpy()
            res.emitted = emitted.cpu().numpy()
        if ckpt is not None and ckpt.pending:
            ckpt.flush()
        if pmesh is not None and per_freq_tally:
            intf = pmesh.reduce_intf(intf, device)

    # ---- outputs (reference end-of-run scaling): the tally's readback
    # and scaling, then the files
    with trace.span("driver.outputs", into=timings, key="outputs"):
        ext_cells = _outputs(cfg, grid, medium, optics, freq, abu, res,
                             intf, per_freq_tally, temperature, emitted,
                             gl_cm, write_files)
    _render_phase(cfg, grid, medium, res, freq, emitted, write_files,
                  timings, pmesh, ext_cells)
    timings["total"] = time.time() - t_start
    return res


def _outputs(cfg, grid, medium, optics, freq, abu, res, intf,
             per_freq_tally, temperature, emitted, gl_cm, write_files):
    """The run's outputs into ``res`` and its files: the absorption
    tally's readback and scaling (the spans `driver.readback`), the
    intensity, then absorbed.data, the temperatures and emitted.data.
    Returns WITH_ABU's per-cell extinction for the maps, or None."""
    if per_freq_tally:
        with trace.span("driver.readback"):
            if isinstance(intf, HostTally):
                # the out-of-core tally: summed, scaled in place and
                # written in blocks of rows, never copied whole
                intf = intf.host
                absorbed = _absorbed_of(intf)
                res.absorbed_photons = np.sum(absorbed, 0, dtype=np.float64)
            else:
                absorbed = _absorbed_of(intf)
                res.absorbed_photons = absorbed.sum(
                    0, dtype=torch.float64).cpu().numpy()
        if cfg.save_intensity > 0:
            res.intensity = _intensity(grid, medium, freq, intf)
            if write_files:
                _write_intensity(cfg.file_intensity, res.intensity)
        if not cfg.noabsorbed:
            with trace.span("driver.readback"):
                host = absorbed if isinstance(absorbed, np.ndarray) \
                    else np.array(absorbed.cpu().numpy(), np.float32)
                res.absorbed = _scale_absorbed(grid, host, gl_cm,
                                               cfg.nnn_limit)
            if write_files and cfg.file_absorbed:
                write_cell_frequency_array(cfg.file_absorbed, res.absorbed)
    if write_files and temperature is not None and cfg.file_temperature:
        write_cell_field(cfg.file_temperature, grid, res.temperature)
    if write_files and emitted is not None and cfg.file_emitted:
        _write_emitted_file(cfg, freq, res.emitted)
    if abu is None:
        return None
    abs_d = np.stack([np.asarray(o.abs_gl) for o in optics])
    sca_d = np.stack([np.asarray(o.sca_gl) for o in optics])
    return (abu @ (abs_d + sca_d)).astype(np.float32)


def _absorbed_of(intf):
    """The absorption tally [CELLS, NFREQ] of a per-frequency tally: the
    I component of saveint 2's (I, Ix, Iy, Iz) tally."""
    return intf[..., 0] if intf.ndim == 3 else intf


def _intensity(grid, medium, freq, intf):
    """The intensity output for DustEM coupling (SAVE_INTENSITY,
    ASOC.py:1496-1505, 2733-2760), host NumPy as soc_tpu computes it:
    I[cell, f] = (PLANCK FREQ / ABS_f) 8^level INT / DENS, zero on cells
    of no density; saveint 2's direction moments (Ix, Iy, Iz) divided by
    the total intensity."""
    lev = equilibrium.cell_levels(grid).cpu().numpy()
    dens = grid.dens.cpu().numpy()
    absf = medium.abs_gl.cpu().numpy().astype(np.float64)
    coeff = (PLANCK * np.asarray(freq, np.float64)[None, :]
             / np.maximum(absf, 1e-300)[None, :] * (8.0 ** lev)[:, None])
    raw = intf.cpu().numpy() if isinstance(intf, torch.Tensor) else intf
    if raw.ndim == 3:
        with np.errstate(divide="ignore", invalid="ignore"):
            intensity = (coeff[:, :, None] * raw
                         / np.maximum(dens, 1e-35)[:, None, None])
        intensity[dens <= 0.0] = 0.0
        for k in (1, 2, 3):
            intensity[:, :, k] /= intensity[:, :, 0] + 1e-33
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            intensity = coeff * raw / np.maximum(dens, 1e-35)[:, None]
        intensity[dens <= 0.0] = 0.0
    return intensity.astype(np.float32)


def _write_intensity(path, intensity):
    """The intensity file: [CELLS, NFREQ] as absorbed.data, or saveint 2's
    int32 [CELLS, NFREQ, 4] header and float32 payload."""
    if intensity.ndim == 2:
        write_cell_frequency_array(path, intensity)
        return
    with open(path, "wb") as fp:
        np.asarray(intensity.shape, np.int32).tofile(fp)
        intensity.tofile(fp)


def read_abundances(cfg, cells, ndust):
    """[CELLS, NDUST] float32 abundances of `abundance` (a file a dust;
    a missing or '#' entry keeps 1), or None for a single dust or without
    the keyword (soc_tpu's WITH_ABU condition)."""
    if ndust < 2 or not cfg.file_abundance:
        return None
    abu = np.ones((cells, ndust), np.float32)
    for d, path in enumerate(cfg.file_abundance[:ndust]):
        if path and not path.startswith("#"):
            abu[:, d] = np.fromfile(path, np.float32, cells)
    return abu


def abundance_physics(cfg, optics, scafuncs, abu, device):
    """The transport's per-cell tables of WITH_ABU (ASOC.py:1146-1175):
    opt_abs / opt_sca [CELLS, NFREQ] = ABU @ the dusts' cross sections,
    each column formed as soc_tpu forms it (a float32 matmul, no TF32),
    stored bfloat16 under `optishalf`; with one scattering function a
    dust, MSF's msf_csc [NDUST, NFREQ, BINS], msf_abu and msf_sca
    [NFREQ, NDUST]. None without abundances."""
    if abu is None:
        return None
    abs_d = np.stack([np.asarray(o.abs_gl, np.float32) for o in optics])
    sca_d = np.stack([np.asarray(o.sca_gl, np.float32) for o in optics])
    abu_t = torch.as_tensor(abu, device=device)
    dtype = torch.bfloat16 if cfg.optishalf else torch.float32
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = dict(opt_abs=(abu_t @ torch.as_tensor(abs_d, device=device)
                            ).to(dtype),
                   opt_sca=(abu_t @ torch.as_tensor(sca_d, device=device)
                            ).to(dtype))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if len(scafuncs) == len(optics):
        out.update(msf_csc=torch.as_tensor(
            np.stack([c for _, c in scafuncs]).astype(np.float32),
            device=device), msf_abu=abu_t,
            msf_sca=torch.as_tensor(sca_d.T.copy(), device=device))
    return out


def weighting_physics(cfg, medium, abu):
    """The transport's weighting keys (soc_tpu driver.py:1239-1258):
    STEP_WEIGHT's 'sw_a' (and method 2's 'sw_b'); DIR_WEIGHT's 'dw_a' with
    the [NFREQ, BINS] phase function 'dsc', which a mixed pool reads at
    each lane's channel (not with abundances, as in the reference)."""
    out = {}
    if cfg.step_weight[0] in (1, 2) and cfg.step_weight[1] > 0:
        out["sw_a"] = float(cfg.step_weight[1])
        if cfg.step_weight[0] == 2:
            # B < 1, or the quadratic degenerates (the reference divides
            # by 2 - 2B just the same)
            out["sw_b"] = float(cfg.step_weight[2])
    if cfg.dir_weight[0] >= 0 and abs(cfg.dir_weight[1]) > 1e-6 \
            and abu is None:
        out["dw_a"] = float(cfg.dir_weight[1])
        out["dsc"] = medium.dsc
    return out


def _remit_band(cfg, freq, emitted):
    """Emission [CELLS, NFREQ] tensor with the channels outside the
    `remit` band zeroed."""
    mask = remit_mask_of(cfg, freq)
    if mask.all():
        return emitted
    return emitted * torch.as_tensor(mask.astype(np.float32),
                                     device=emitted.device)[None, :]


def _solve_and_emit(grid, table, heating, gl_cm, freq, abs_gl, cfg, pmesh,
                    beta=1.0):
    """Equilibrium temperature of a heating field (with `CR_HEATING`'s
    rate) and its emission (remit band applied), over the mesh when one is
    given."""
    if pmesh is not None:
        from ..parallel import product
        temperature = product.solve_temperature(
            pmesh, grid, table, heating, gl_cm, beta=beta,
            cr_heating=cfg.cr_heating)
        emitted = product.emission(pmesh, freq, abs_gl, temperature, gl_cm)
    else:
        temperature = equilibrium.solve_temperature(
            grid, table, heating, gl_cm, beta=beta,
            cr_heating=cfg.cr_heating)
        emitted = equilibrium.emission(freq, abs_gl, temperature, gl_cm)
    return temperature, _remit_band(cfg, freq, emitted)


def _iterations(cfg, grid, medium, optics, table, ctabs, intf, seed, lanes,
                per_freq_tally, freq, gl_cm, write_files, res, pmesh,
                physics_extra=None, ckpt=None):
    """Phase 2's iterations (soc_tpu driver.py:1512-1691): with cell
    packets each iteration after the first re-emits the previous
    iteration's emission and solves again on the total heating.

    WITH_REFERENCE (`reference`) simulates only the change in emission
    since the last iteration and carries the previous tally, ramped by
    k = iteration / ITERATIONS; `reference AABB` makes k = (iteration +
    BB) / AA and continues from OEMITTED.save / OTABS.save, which it writes
    back. ALI (`ali`) divides each cell's absorbed energy by its escape
    probability beta = clip((XEM - XAB) / XEM, 1e-2, 1), in float64 on
    the host, with the same k-ramped carry of XAB under the reference
    field (OXAB.save read, OXAB.save / OXEM.save written); `alibeta`
    refines beta with the previous iteration's temperature. With a
    checkpoint (``ckpt``) each iteration with cell packets ends with an
    "iter%d" unit holding what the next one reads (emitted, temperature,
    emit_total, the reference carries, XAB), and a resumed run starts
    after the last one written (soc_tpu driver.py:1552-1600, 1660-1680);
    the cell passes record their own units (simulate_cell_emission).
    ``pmesh``, the passes' layout: a ProductMesh runs the cell passes and
    the solves over the mesh, a DomainSet the cell passes over its
    Z-slabs and the solves on the run's device.
    Returns (temperature, emitted, intf) on the device."""
    device = grid.device
    mesh = _tally_mesh(pmesh)
    abs_gl = optics[0].abs_gl
    wr = int(cfg.with_reference)
    wr_fir, wr_tot = 0, max(1, cfg.iterations)
    oemitted = otabs = oxab = xab = None
    if wr > 1:
        wr_fir = wr % 100
        wr_tot = max(1, wr // 100)
        if os.path.exists("OEMITTED.save") and os.path.exists("OTABS.save"):
            oemitted = torch.as_tensor(np.fromfile(
                "OEMITTED.save", np.float32).reshape(grid.cells, -1),
                device=device)
            otabs = torch.as_tensor(np.fromfile("OTABS.save", np.float32,
                                                grid.cells), device=device)
    if cfg.with_ali and wr % 100 > 0 and os.path.exists("OXAB.save"):
        # continuation of the ALI accounting from a previous run
        oxab = np.fromfile("OXAB.save", np.float32, grid.cells)
    tw = medium.tw.cpu().numpy().astype(np.float64)
    emit_total = ctabs
    temperature = emitted = None
    it0 = 0
    if ckpt is not None:
        done = [int(d[4:]) for d in ckpt.done if d.startswith("iter")]
        if done and ckpt.saved("it_emitted") is not None:
            # jump past the last iteration written
            it0 = max(done) + 1

            def saved(name):
                v = ckpt.saved(name)
                return None if v is None else torch.tensor(v, device=device)
            emitted, temperature = saved("it_emitted"), \
                saved("it_temperature")
            emit_total = saved("it_emit_total")
            if ckpt.saved("it_oemitted") is not None:
                oemitted, otabs = saved("it_oemitted"), saved("it_otabs")
            if ckpt.saved("it_oxab") is not None:
                oxab = np.array(ckpt.saved("it_oxab"))
            if ckpt.saved("it_xab") is not None:
                xab = np.array(ckpt.saved("it_xab"))
            res.cell_passes.extend(_restored_passes(cfg, ckpt, it0, mesh))
    for iteration in range(it0, max(1, cfg.iterations)):
        with trace.span("driver.iteration", iteration=iteration):
            beta = 1.0
            k = ((iteration + wr_fir) / float(wr_tot)) if wr > 1 \
                else (iteration / float(max(1, cfg.iterations)))
            if cfg.clpac > 0 and emitted is not None:
                # delta_sim: this iteration simulates only the change in
                # emission (decided before oemitted is reassigned below)
                delta_sim = bool(wr) and oemitted is not None
                if delta_sim:
                    oemitted = oemitted * np.float32(k)
                    otabs = otabs * np.float32(k)
                    sim_emit = emitted - oemitted
                else:
                    sim_emit = emitted
                tabs_it = torch.zeros(grid.cells, dtype=torch.float32,
                                      device=device)
                tabs_it, intf, _, xab, stats = simulate_cell_emission(
                    grid, medium, cfg, sim_emit, tabs_it, intf, seed, lanes,
                    per_freq_tally, iteration=iteration,
                    physics_extra=physics_extra, pmesh=pmesh,
                    ckpt=ckpt)
                res.cell_passes.append(stats)
                if delta_sim:
                    tabs_it = tabs_it + otabs
                if wr:
                    otabs = tabs_it
                    oemitted = emitted
                emit_total = tabs_it + ctabs
                if cfg.with_ali and xab is not None:
                    xab, beta = _ali_beta(emitted, tw, xab,
                                          oxab if delta_sim else None, k,
                                          device)
                    if wr:
                        oxab = xab
            t_prev = temperature
            temperature, emitted = _solve_and_emit(
                grid, table, emit_total, gl_cm, freq, abs_gl, cfg, mesh,
                beta)
            if cfg.has_key("alibeta") and cfg.with_ali \
                    and t_prev is not None and torch.is_tensor(beta):
                # the beta(T, tau) refinement with the previous iteration's
                # temperature (the reference ships it disabled; opt-in here)
                from ..solve.ali import refine_beta
                with trace.span("ali.update", step="alibeta"):
                    beta2 = refine_beta(beta.cpu().numpy(),
                                        temperature.cpu().numpy(), freq,
                                        medium.abs_gl.cpu().numpy(),
                                        grid.dens.cpu().numpy(),
                                        t_old=t_prev.cpu().numpy())
                temperature, emitted = _solve_and_emit(
                    grid, table, emit_total, gl_cm, freq, abs_gl, cfg, mesh,
                    torch.as_tensor(beta2, device=device))
            if ckpt is not None and cfg.clpac > 0:
                # the iteration's state: everything the next one reads
                ckpt.record("iter%d" % iteration, None,
                            intf=_intf_snapshot(intf, mesh),
                            it_emitted=emitted, it_temperature=temperature,
                            it_emit_total=emit_total, it_oemitted=oemitted,
                            it_otabs=otabs, it_oxab=oxab, it_xab=xab)
            if cfg.clpac <= 0:
                break   # nothing changes between iterations without CLPAC
    if write_files and wr > 1 and oemitted is not None:
        oemitted.cpu().numpy().astype(np.float32).tofile("OEMITTED.save")
        otabs.cpu().numpy().astype(np.float32).tofile("OTABS.save")
    if write_files and cfg.with_ali and xab is not None:
        np.asarray(xab, np.float32).tofile("OXAB.save")
        (emitted.cpu().numpy().astype(np.float64) @ tw).astype(
            np.float32).tofile("OXEM.save")
    return temperature, emitted, intf


def _ali_beta(emitted, tw, xab, oxab, k, device):
    """ALI's escape probability beta = clip((XEM - XAB) / XEM, 1e-2, 1)
    per cell (1 where XEM is 0), XEM the cell's emitted energy, in float64
    on the host (the span `ali.update`). Under WITH_REFERENCE the pass
    covered only the delta field, so the full-field XAB takes the same
    k-ramped carry of ``oxab`` as OTABS (None where the pass simulated the
    whole field). Returns (xab, beta on the device)."""
    with trace.span("ali.update"):
        xem = emitted.cpu().numpy().astype(np.float64) @ tw
        if oxab is not None:
            xab = xab + oxab * np.float32(k)
        beta = np.clip((xem - xab) / np.maximum(xem, 1e-30), 1e-2, 1.0)
        beta[xem <= 0] = 1.0
        return xab, torch.as_tensor(beta.astype(np.float32), device=device)


def _restored_passes(cfg, ckpt, it0, pmesh):
    """The cell passes of the iterations a resumed run jumps past, each
    from its units' vectors in the checkpoint (seconds and pools zero)."""
    route = "emweight" if cfg.use_emweight > 0 else "ali" if cfg.with_ali \
        else "mixed"
    out = []
    for it in range(1, it0):
        keys = [k for k in ckpt.done
                if k == "it%d" % it or k.startswith("it%d/" % it)]
        if not keys:
            continue
        vec = [ckpt.vectors(k) for k in keys]
        stats = {name: sum(v[name] for v in vec)
                 for name in ("escaped", "absorbed", "injected",
                              "injected_abs")}
        out.append(dict(stats, iteration=it, route=route, pools=0,
                        packets=0, seconds=0.0, mesh=pmesh is not None,
                        restored=True))
    return out


def _subiterations(cfg, grid, medium, optics, table, ctabs, intf, seed,
                   lanes, per_freq_tally, freq, gl_cm, write_files, res,
                   pmesh, physics_extra=None, ckpt=None):
    """SUBITERATIONS: hot/cold cells with the reference field
    (soc_tpu driver.py:1773-1871, ASOC.py:2261-2420). Over
    max(4, ITERATIONS) rounds:
      0        : all cells, no reference
      1        : the cold cells only -> PTABS (T not solved)
      2..N-2   : the hot cells only, reference ramp k = (it-2)/(N-3);
                 heating = TABS + OTABS + PTABS
      N-1      : all cells again (the reference keeps hot cells only)
    A cell is hot at T >= HOT_LIMIT, or where the `externalmask` file
    (int32 per cell) is positive. As in soc_tpu, the rounds take no
    checkpoint (``ckpt`` is not used; phase 1's units still are).
    Returns (temperature, emitted, intf)."""
    device = grid.device
    iters = max(4, cfg.iterations)
    external = None
    if cfg.file_external_mask:
        external = np.fromfile(cfg.file_external_mask, np.int32,
                               grid.cells) > 0
    zeros = torch.zeros(grid.cells, dtype=torch.float32, device=device)
    oemitted = torch.zeros((grid.cells, len(freq)), dtype=torch.float32,
                           device=device)
    otabs = ptabs = zeros
    temperature = emitted = None
    told = np.zeros(grid.cells, np.float32)
    for iteration in range(iters):
        k = np.float32(np.clip((iteration - 2.0) / max(1.0, iters - 3.0),
                               0.0, 1.0))
        hot = external if external is not None else told >= HOT_LIMIT
        solve_t = iteration != 1
        use_ptabs = iteration >= 2 and iteration != iters - 1
        if iteration == 0:
            ignore = np.zeros(grid.cells, bool)
        elif iteration == 1:
            ignore = hot           # simulate the cold cells once -> PTABS
        elif iteration == iters - 1:
            # the final full round: the cold cells leave the reference
            oemitted = torch.where(torch.as_tensor(~hot, device=device)
                                   [:, None], 0.0, oemitted)
            ignore = np.zeros(grid.cells, bool)
        else:
            ignore = ~hot
        if iteration <= 2:
            oemitted = oemitted * 0
            otabs = otabs * 0
        oemitted = oemitted * k
        otabs = otabs * k

        if emitted is not None:
            sim_emit = torch.where(torch.as_tensor(ignore, device=device)
                                   [:, None], 0.0, emitted - oemitted)
            tabs_it, intf, _, _, stats = simulate_cell_emission(
                grid, medium, cfg, sim_emit, zeros.clone(), intf, seed,
                lanes, per_freq_tally, iteration=iteration,
                physics_extra=physics_extra, pmesh=pmesh)
            res.cell_passes.append(stats)
            if iteration == 1:
                ptabs = tabs_it
            else:
                tabs_it = tabs_it + otabs
                otabs = tabs_it
                oemitted = emitted
                emit_total = tabs_it + ptabs + ctabs if use_ptabs \
                    else tabs_it + ctabs
        else:
            emit_total = ctabs
        if solve_t:
            temperature, emitted = _solve_and_emit(
                grid, table, emit_total, gl_cm, freq, optics[0].abs_gl, cfg,
                pmesh)
            told = temperature.cpu().numpy()
    return temperature, emitted, intf


def _render_phase(cfg, grid, medium, res, freq, emitted, write_files,
                  timings, pmesh=None, ext_cells=None):
    """Phase 3 (soc_tpu driver.py:1899-2201): the maps and the point
    sources' optical depths.

    emitted: [CELLS, NFREQ] host array or device tensor (or None);
    ext_cells: WITH_ABU's per-cell extinction [CELLS, NFREQ] (host), or
    None for the medium's. By the ini, one of: MAP_HIER by level, Healpix
    (map_dir_XX_H.bin, `mapping NSIDE -1 dx 999`) or orthographic; a
    Healpix all-sky map from the internal observer (map.healpix,
    `interpolate`); a perspective panorama (`intobs`); else orthographic
    maps (map_dir_XX.bin, with `mapint` and `yshear`/`maxlos`), with FITS
    files (`FITS`) and `savetau`'s optical depth at the asked
    frequencies or column density (a frequency outside the map band is
    rendered but kept out of map_dir_XX.bin). Then `pssavetau`'s text
    files, then the polarization maps (_polarization_maps). With
    `threshold L` the maps take no emission from cells on
    levels below L; with `roimap` none from cells whose root cell lies
    outside the ROI box (a where, so a NaN there cannot reach a map; the
    hierarchy maps have no gate, as in the reference). They still absorb
    along the line of sight.
    With ``pmesh`` the plain orthographic map's rows and channels are
    split over the mesh when NY divides by dp and the selected channels
    by freq, in one process (soc_tpu's conditions, driver.py:2063-2068
    there); every other map renders on the first shard's device, as
    soc_tpu falls back, and under several processes on each one's own.
    Each render's seconds, rays and march steps (None for the sharded
    map) go to res.render_passes. The phase is the span `maps.render`,
    its seconds timings["maps"].
    """
    with trace.span("maps.render", into=timings, key="maps"):
        _render(cfg, grid, medium, res, freq, emitted, write_files, pmesh,
                ext_cells)


def _render(cfg, grid, medium, res, freq, emitted, write_files, pmesh,
            ext_cells):
    """_render_phase's work."""
    device = grid.device
    gl_cm = cfg.gl * PARSEC
    if emitted is not None and cfg.level_threshold > 0:
        lev = equilibrium.cell_levels(grid)
        emitted = torch.where((lev < cfg.level_threshold)[:, None], 0.0,
                              torch.as_tensor(emitted, device=device))
    fsel = map_freq_mask(cfg, freq) if emitted is not None else None
    ortho_maps = (cfg.fast_map < 999 and cfg.npix[1] > 0
                  and cfg.intobs[0] <= -1e7)
    # savetau's frequencies are rendered even outside the map band, but
    # kept out of map_dir_XX.bin and res.maps (map_of_sel)
    savetau_idx = []
    map_sel = None if fsel is None else fsel.copy()
    if ortho_maps and cfg.file_savetau and cfg.savetau_freq \
            and fsel is not None:
        for fv in cfg.savetau_freq:
            if fv > 0:
                i = int(np.argmin(np.abs(np.asarray(freq) - fv)))
                fsel[i] = True
                savetau_idx.append(i)
            else:
                savetau_idx.append(-1)          # column density
    sel_of_full = {}
    if fsel is not None:
        sel_of_full = {int(i): k for k, i in enumerate(np.nonzero(fsel)[0])}
    map_of_sel = None
    if fsel is not None and not np.array_equal(fsel, map_sel):
        map_of_sel = np.asarray([sel_of_full[int(i)]
                                 for i in np.nonzero(map_sel)[0]], int)

    def timed(name, fn, *args, counted=True, **kw):
        # counted=False: a render that does not count its rays and steps
        # (the mesh's); they stay None
        stats = dict(render=name, rays=0 if counted else None,
                     steps=0 if counted else None)
        _sync(device)
        t = time.time()
        out = fn(*args, stats=stats, **kw) if counted else fn(*args, **kw)
        _sync(device)
        stats["seconds"] = time.time() - t
        res.render_passes.append(stats)
        return out

    shard_maps = (pmesh is not None and ortho_maps and cfg.y_shear == 0.0
                  and int(cfg.map_interpolation) == 0 and ext_cells is None
                  and cfg.maxlos >= 1e9
                  and cfg.npix[1] % pmesh.n_dp == 0
                  and fsel is not None
                  and int(fsel.sum()) % pmesh.n_freq == 0
                  and not pmesh.multi)
    if pmesh is not None and not shard_maps:
        device = pmesh.lead(device)
        grid = pmesh.replica(grid, device)
    if not cfg.nomap and emitted is not None and fsel.any():
        centre = cfg.mapcentre
        if centre[0] < -1e7:
            centre = (0.5 * grid.nx, 0.5 * grid.ny, 0.5 * grid.nz)
        kk = render_mapping.map_scale_kk(cfg.gl)
        freq_s = np.asarray(freq)[fsel]
        emitted = torch.as_tensor(emitted, device=device)
        scale = torch.as_tensor((kk * freq_s).astype(np.float32),
                                device=device)
        sel_idx = torch.as_tensor(np.nonzero(fsel)[0], device=device)
        emit_map = emitted[:, sel_idx].to(torch.float32) * scale[None, :]
        if cfg.roi_map and cfg.roi is not None and cfg.fast_map < 999:
            # ROI_MAP: emission only from cells whose root cell lies in
            # the box (kernel_ASOC_map.c:515-961 InRoi)
            inside = torch.as_tensor(roi_cell_mask(grid, cfg.roi),
                                     device=device)
            emit_map = torch.where(inside[:, None], emit_map, 0.0)
        if ext_cells is not None:
            # WITH_ABU: each cell's own extinction [CELLS, NF]
            ext_gl = torch.as_tensor(ext_cells[:, fsel], device=device)
        else:
            ext_gl = torch.as_tensor(
                (medium.abs_gl.cpu().numpy()
                 + medium.sca_gl.cpu().numpy())[fsel], device=device)
        ndir = len(cfg.obs_theta)
        if cfg.fast_map >= 999 and cfg.npix[1] <= 0:
            # MAP_HIER + Healpix: per-level all-sky maps from the internal
            # observer, one file a direction (all the same product):
            # [NSIDE, NPIX.y] + [NF, LEVELS] int32, float32
            # [NF, LEVELS, 12 NSIDE^2]
            intobs = cfg.intobs if cfg.intobs[0] > -1e7 else centre
            phot, _, _ = timed("healpix_hier",
                               render_mapping.render_healpix_hier, grid,
                               emit_map, ext_gl, intobs, int(cfg.npix[0]))
            hier = phot.permute(1, 0, 2).cpu().numpy()
            for idir in range(ndir):
                res.maps[("hier_hp", idir)] = hier
                if write_files:
                    _write_hier("map_dir_%02d_H.bin" % idir, cfg, grid,
                                hier)
        elif cfg.fast_map >= 999:
            # MAP_HIER: per-level orthographic maps, [NX, NY] + [NF,
            # LEVELS] int32, float32 [NF, LEVELS, NY, NX]
            for idir in range(ndir):
                odir, ra, de = render_mapping.observer_basis(
                    cfg.obs_theta[idir], cfg.obs_phi[idir])
                phot = timed("ortho_hier", render_mapping.render_ortho_hier,
                             grid, emit_map, ext_gl, odir, ra, de, centre,
                             cfg.map_dx, tuple(cfg.npix))
                hier = phot.permute(1, 0, 2, 3).cpu().numpy()
                res.maps[("hier", idir)] = hier
                if write_files:
                    _write_hier("map_dir_%02d_H.bin" % idir, cfg, grid,
                                hier)
        elif cfg.npix[1] <= 0:
            # all-sky Healpix map around the internal observer (NPIX.x is
            # NSIDE; a headerless map.healpix)
            intobs = cfg.intobs if cfg.intobs[0] > -1e7 else centre
            phot, tau, _ = timed("healpix", render_mapping.render_healpix,
                                 grid, emit_map, ext_gl, intobs,
                                 int(cfg.npix[0]),
                                 interpolate=int(cfg.interpolate))
            res.maps[0] = phot.cpu().numpy()
            res.tau_maps[0] = tau.cpu().numpy()
            if write_files:
                with trace.span("io.write", bytes=res.maps[0].size * 4):
                    res.maps[0].astype(np.float32).tofile("map.healpix")
        elif cfg.intobs[0] > -1e7:
            # perspective panorama from inside the model
            phot, tau, _ = timed("perspective",
                                 render_mapping.render_perspective, grid,
                                 emit_map, ext_gl, cfg.intobs,
                                 tuple(cfg.npix))
            res.maps[0] = phot.cpu().numpy()
            res.tau_maps[0] = tau.cpu().numpy()
            if write_files:
                write_map_file("map_dir_00.bin", res.maps[0])
        else:
            fmaps = freq_s if map_of_sel is None else freq_s[map_of_sel]
            for idir in range(ndir):
                odir, ra, de = render_mapping.observer_basis(
                    cfg.obs_theta[idir], cfg.obs_phi[idir])
                if shard_maps:
                    from ..parallel.mesh import sharded_render_ortho
                    phot, tau, colden = timed(
                        "ortho", sharded_render_ortho, grid, emit_map,
                        ext_gl, odir, ra, de, centre, cfg.map_dx,
                        tuple(cfg.npix), pmesh, counted=False)
                else:
                    phot, tau, colden = timed(
                        "ortho", render_mapping.render_ortho, grid,
                        emit_map, ext_gl, odir, ra, de, centre, cfg.map_dx,
                        tuple(cfg.npix), use_shear=cfg.y_shear != 0.0,
                        y_shear=cfg.y_shear, maxlos=cfg.maxlos,
                        map_interp=int(cfg.map_interpolation))
                phot_np = phot.cpu().numpy()
                res.maps[idir] = phot_np if map_of_sel is None \
                    else phot_np[map_of_sel]
                res.tau_maps[idir] = tau.cpu().numpy()
                res.maps[("colden", idir)] = colden.cpu().numpy()
                if cfg.file_savetau and savetau_idx:
                    _savetau(cfg, res, freq, idir, savetau_idx, sel_of_full,
                             colden, gl_cm, write_files)
                if not write_files:
                    continue
                write_map_file("map_dir_%02d.bin" % idir, res.maps[idir])
                if cfg.fits > 0:
                    # one FITS file a frequency, '<prefix>_<um>[_NNN].fits'
                    # (ASOC.py:3142-3147)
                    for k, f0 in enumerate(np.atleast_1d(fmaps)):
                        name = ("%s_%s.fits" % (cfg.fits_prefix, _um_tag(f0))
                                if ndir == 1 else "%s_%s_%03d.fits"
                                % (cfg.fits_prefix, _um_tag(f0), idir))
                        write_fits_image(name, res.maps[idir][k],
                                         ra_deg=cfg.fits_ra,
                                         de_deg=cfg.fits_de,
                                         pix_deg=_fits_pix_deg(cfg))

    # PSTau: column density and optical depth from each point source
    # toward the observer (ASOC.py:3631-3650), "%s_%d.dat" text files
    if cfg.file_pssavetau and cfg.no_ps > 0:
        ext_all = torch.as_tensor(
            ext_cells if ext_cells is not None
            else medium.abs_gl.cpu().numpy() + medium.sca_gl.cpu().numpy(),
            device=device)
        itau = int(np.argmin(np.abs(np.asarray(freq)
                                    - max(cfg.pssavetau_freq, 0.0))))
        for idir in range(len(cfg.obs_theta)):
            odir, _, _ = render_mapping.observer_basis(cfg.obs_theta[idir],
                                                       cfg.obs_phi[idir])
            tau, colden = timed("pstau", render_mapping.render_pstau, grid,
                                ext_all, np.asarray(cfg.ps_pos, np.float32),
                                odir)
            tau = tau.cpu().numpy()
            colden_cm = colden.cpu().numpy() * gl_cm
            res.maps[("pstau", idir)] = (colden_cm, tau[:, itau])
            if write_files:
                with open("%s_%d.dat" % (cfg.file_pssavetau, idir),
                          "w") as fp:
                    for i in range(cfg.no_ps):
                        fp.write("%6d  %12.4e  %12.4e\n"
                                 % (i, colden_cm[i], tau[i, itau]))
    if cfg.polmap > 0 and emitted is not None and len(cfg.b_files) == 3:
        # outside the `nomap` gate, on the first shard's device
        _polarization_maps(
            cfg, grid if pmesh is None else pmesh.replica(
                grid, pmesh.lead(grid.device)), medium, res, freq, emitted,
            write_files, timed, ext_cells, gl_cm)


def _polarization_maps(cfg, grid, medium, res, freq, emitted, write_files,
                       timed, ext_cells, gl_cm):
    """The polarization maps (soc_tpu driver.py:2203-2377), outside the
    `nomap` gate: the field of the three `polmap` / `Bfiles` hierarchy
    files and the emission of every channel (scaled by KK freq in float64,
    then float32), with WITH_ABU's per-cell extinction when given. By the
    ini, one of: the Healpix POLSTAT maps (`polstat` > 0 with `intobs` or
    NPIX.y <= 0; pol_healpix.bin [NSIDE, NF] + [4, NF, NPIX] rhoTheta,
    rhoGamma, jTheta, jGamma); the Healpix I/Q/U/N maps (pol_healpix.bin);
    else per direction POLSTAT 2 (I/Q/U/N with the shearing replication
    up to `maxlos`), POLSTAT 1/3 (polstat_dir_XX.bin: NPIX + [7, NY, NX]
    rT, rI, B, B_LOS, B_POS, tau, N) or plain I/Q/U/N (polmap_dir_XX.bin
    [4, NF, NY, NX]). The Healpix maps also write pol_healpix.fits.%d and
    POLSTAT 0-2 polmap_%.1f_%02d.fits, one a map-band channel. N is in
    cm^-2. ``grid`` lies on the device the maps render on."""
    from ..io.fits import write_healpix_map
    from ..render import polarization as rpol
    device = grid.device
    bvec = [np.concatenate(read_hierarchy(bf)[4]) for bf in cfg.b_files]
    bfield = torch.as_tensor(np.stack(bvec, -1).astype(np.float32),
                             device=device)
    centre = cfg.mapcentre
    if centre[0] < -1e7:
        centre = (0.5 * grid.nx, 0.5 * grid.ny, 0.5 * grid.nz)
    kk = render_mapping.map_scale_kk(cfg.gl)
    scale = torch.as_tensor(kk * np.asarray(freq, np.float64), device=device)
    emit_map = (torch.as_tensor(emitted, device=device).to(torch.float64)
                * scale[None, :]).to(torch.float32)
    ext_gl = torch.as_tensor(
        ext_cells if ext_cells is not None
        else medium.abs_gl.cpu().numpy() + medium.sca_gl.cpu().numpy(),
        device=device)
    cell_w = None
    if cfg.level_threshold > 0:
        # `threshold` zeroes the POLSTAT density weight too
        cell_w = (equilibrium.cell_levels(grid)
                  >= cfg.level_threshold).to(torch.float32)
    polred = len(cfg.file_polred) > 0
    nf = len(freq)
    band = np.nonzero(map_freq_mask(cfg, freq))[0]
    healpix = cfg.intobs[0] > -1e7 or cfg.npix[1] <= 0
    intobs = cfg.intobs if cfg.intobs[0] > -1e7 else centre
    nside = int(cfg.npix[0])

    def write_healpix(stack, names=None):
        with open("pol_healpix.bin", "wb") as fp:
            np.asarray([nside, nf], np.int32).tofile(fp)
            stack.astype(np.float32).tofile(fp)
        for ifq in band:
            kw = {} if names is None else dict(column_names=names)
            write_healpix_map("pol_healpix.fits.%d" % ifq,
                              tuple(stack[k, ifq] for k in range(4)), nside,
                              **kw)

    if cfg.polstat > 0 and healpix:
        st = timed("polstat_healpix", rpol.render_polstat_healpix, grid,
                   emit_map, ext_gl, bfield, intobs, nside, polred=polred,
                   maxlos=cfg.maxlos, use_shear=cfg.y_shear != 0.0,
                   y_shear=cfg.y_shear)
        st = {k: v.cpu().numpy() for k, v in st.items()}
        npx = 12 * nside * nside
        stack = np.stack([np.broadcast_to(st["rT"][None], (nf, npx)),
                          np.broadcast_to(st["rI"][None], (nf, npx)),
                          st["jT"], st["jI"]])
        res.maps[("polstat_hp", 0)] = stack
        if write_files:
            write_healpix(stack, ("rhoTheta", "rhoGamma", "jTheta",
                                  "jGamma"))
        return
    if healpix:
        out = timed("pol_healpix", rpol.render_pol_healpix, grid, emit_map,
                    ext_gl, bfield, cfg.p0, intobs, nside, polred=polred,
                    maxlos=cfg.maxlos, minlos=cfg.minlos,
                    interpolate=int(cfg.interpolate))
        s_i, s_q, s_u, colden = (v.cpu().numpy() for v in out)
        res.maps[("pol_hp", 0)] = (s_i, s_q, s_u, colden)
        if write_files:
            colden_cm = colden * gl_cm
            write_healpix(np.stack([s_i, s_q, s_u, np.broadcast_to(
                colden_cm[None], (nf, colden.size))]))
        return
    for idir in range(len(cfg.obs_theta)):
        odir, ra, de = render_mapping.observer_basis(cfg.obs_theta[idir],
                                                     cfg.obs_phi[idir])
        if cfg.polstat > 0 and cfg.polstat != 2:
            st = timed("polstat", rpol.render_polstat, grid, emit_map,
                       ext_gl, bfield, odir, ra, de, centre, cfg.map_dx,
                       tuple(cfg.npix), polred=polred, cell_w=cell_w)
            st = {k: v.cpu().numpy() for k, v in st.items()}
            stack = np.stack([st[k] for k in ("rT", "rI", "B", "B_LOS",
                                              "B_POS", "tau", "colden")])
            stack[6] *= gl_cm
            res.maps[("polstat", idir)] = stack
            four = np.stack([np.broadcast_to(st["rT"][None], st["jT"].shape),
                             np.broadcast_to(st["rI"][None], st["jI"].shape),
                             st["jT"], st["jI"]])
            res.maps[("polstat4", idir)] = four
            if write_files:
                with open("polstat_dir_%02d.bin" % idir, "wb") as fp:
                    np.asarray(cfg.npix, np.int32).tofile(fp)
                    stack.astype(np.float32).tofile(fp)
                if cfg.polstat == 1:
                    _write_polmap_fits(cfg, freq, band, four, idir)
            continue
        # POLSTAT 2: the shearing replication until the path passes maxlos
        shear = cfg.polstat == 2
        out = timed("pol", rpol.render_pol, grid, emit_map, ext_gl, bfield,
                    cfg.p0, odir, ra, de, centre, cfg.map_dx,
                    tuple(cfg.npix), polred=polred,
                    rho_weight=cfg.pol_rho_weight, use_shear=shear,
                    y_shear=cfg.y_shear if shear else 0.0,
                    maxlos=cfg.maxlos, minlos=cfg.minlos)
        s_i, s_q, s_u, colden = (v.cpu().numpy() for v in out)
        res.maps[("pol", idir)] = (s_i, s_q, s_u, colden)
        if write_files:
            colden_cm = colden * gl_cm
            stack = np.stack([s_i, s_q, s_u, np.broadcast_to(
                colden_cm[None], (nf,) + colden.shape)])
            stack.astype(np.float32).tofile("polmap_dir_%02d.bin" % idir)
            _write_polmap_fits(cfg, freq, band, stack, idir)


def _write_polmap_fits(cfg, freq, band, stack, idir):
    """The polmap product: one FITS a map-band channel,
    'polmap_%.1f_%02d.fits' (um, direction), holding that channel's
    [4, NY, NX] planes of ``stack`` [4, NF, NY, NX]."""
    pix_deg = None
    if cfg.distance > 0:
        pix_deg = np.degrees(cfg.gl * cfg.map_dx / cfg.distance)
    for ifq in band:
        write_fits_image("polmap_%.1f_%02d.fits" % (f2um(freq[ifq]), idir),
                         stack[:, ifq], pix_deg=pix_deg)


def _write_hier(path, cfg, grid, hier):
    """A MAP_HIER file: int32 NPIX (2) and [NF, LEVELS], then float32
    hier [NF, LEVELS, ...]."""
    with trace.span("io.write", bytes=hier.size * 4), open(path, "wb") as fp:
        np.asarray(cfg.npix, np.int32).tofile(fp)
        np.asarray([hier.shape[0], grid.levels], np.int32).tofile(fp)
        hier.astype(np.float32).tofile(fp)


def _um_tag(f):
    """A frequency's wavelength as the reference's FITS names write it."""
    um = f2um(f)
    return "%.0f" % um if um > 20.0 else "%.1f" % um if um > 2.0 \
        else "%.2f" % um


def _fits_pix_deg(cfg):
    """The FITS pixel size [deg]: GL MAP_DX / distance (1 kpc when no
    `distance` is given)."""
    dist = cfg.distance if cfg.distance > 0 else 1000.0
    return np.degrees(cfg.gl * cfg.map_dx / dist)


def _savetau(cfg, res, freq, idir, savetau_idx, sel_of_full, colden, gl_cm,
             write_files):
    """savetau: for each asked frequency its optical-depth map, or for a
    negative one the column density [cm^-2], in "%s[_k].%d" % (savetau,
    idir) (NPIX int32 + float32 map, ASOC.py:3010-3075, 3420-3434); with
    `FITS` also '<savetau>_colden' / '<savetau>_tau_<um>' FITS files with
    the reference's _dirN and _NNN tags (ASOC.py:3123-3124, 3157-3170)."""
    ndir = len(cfg.obs_theta)
    for k, idx in enumerate(savetau_idx):
        if idx < 0:
            payload = colden.cpu().numpy() * gl_cm
        else:
            payload = res.tau_maps[idir][sel_of_full[idx]]
        suffix = "" if len(savetau_idx) == 1 else "_%d" % k
        res.maps[("savetau", idir, k)] = payload
        if not write_files:
            continue
        with open("%s%s.%d" % (cfg.file_savetau, suffix, idir), "wb") as fp:
            np.asarray(cfg.npix, np.int32).tofile(fp)
            payload.astype(np.float32).tofile(fp)
        if cfg.fits > 0:
            dtag = "" if ndir == 1 else "_dir%d" % idir
            if idx < 0:
                base, unit = "%s_colden%s" % (cfg.file_savetau, dtag), "cm-2"
            else:
                base, unit = ("%s_tau_%s%s" % (cfg.file_savetau,
                                               _um_tag(freq[idx]), dtag),
                              "tau")
            fname = "%s.fits" % base if ndir == 1 \
                else "%s_%03d.fits" % (base, idir)
            write_fits_image(fname, payload, ra_deg=cfg.fits_ra,
                             de_deg=cfg.fits_de, pix_deg=_fits_pix_deg(cfg),
                             bunit=unit)
