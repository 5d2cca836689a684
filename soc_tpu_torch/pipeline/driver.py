"""End-to-end emission radiative transfer (port of soc_tpu.pipeline.driver
for the background-heated, single-level slice).

Phases:
  1. the isotropic background, all frequencies in one mixed-frequency
     packet pool -> TABS (+ per-frequency absorptions)
  2. the equilibrium temperature solve and the thermal emission
  3. orthographic maps -> map_dir_XX.bin
With `devices N` (or an explicit device list) every phase runs over a
(dp x freq) mesh of devices (parallel/product.py): phase 1 with the
channels blocked over freq and each channel's budget split over dp;
phase 2 with the cells split; phase 3 with the map's rows and channels
split.
Outputs keep the reference's binary formats. A keyword or input the port
does not support yet raises NotImplementedError naming it; nothing is
silently ignored.
"""

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import RunConfig
from ..constants import FACTOR, PARSEC, PLANCK
from ..io.dust import read_scattering_function, read_simple_dust
from ..io.fields import (read_background_intensity,
                         read_cell_frequency_array,
                         write_cell_frequency_array, write_map_file)

from ..grid import Grid
from ..io.cloud import read_cloud, write_cell_field
from ..render import mapping as render_mapping
from ..solve import equilibrium
from ..transport.medium import medium_from_optics
from ..transport.propagate import pool_lanes, transport_run
from ..transport.sources import stream_hi_base

# lanes of the packet pool: eager sweeps cost the same number of launches
# at any width, so a wider pool is cheaper per packet until the drain tail
# (the last, long-lived packets) dominates; 2^21 was the fastest of
# 2^19..2^22 on the 43M-packet soc_example-sized run on an H100
DEFAULT_LANES = 1 << 21


@dataclass
class RunResult:
    grid: Grid = None
    freq: np.ndarray = None
    ctabs: np.ndarray = None            # integrated constant-source heating
    absorbed: np.ndarray = None         # [CELLS, NFREQ] (file scaling applied)
    temperature: np.ndarray = None      # [CELLS]
    emitted: np.ndarray = None          # [CELLS, NFREQ]
    maps: dict = field(default_factory=dict)       # idir -> [NF, NY, NX]
    escaped: np.ndarray = None          # [NFREQ] photons that left the volume
    injected: np.ndarray = None         # [NFREQ] photons injected
    absorbed_photons: np.ndarray = None  # [NFREQ] photons absorbed (raw)
    packets: int = 0                   # packets traced in phase 1
    devices: list = None                # the product mesh's devices, or None
    timings: dict = field(default_factory=dict)


def unsupported_features(cfg):
    """Names of the ini features this port does not implement yet."""
    out = []

    def need(cond, name):
        if cond:
            out.append(name)

    need(cfg.file_hpbg, "hpbg (Healpix background)")
    need(cfg.no_ps > 0, "pointsource")
    need(cfg.file_diffuse, "diffuse")
    need(cfg.roi is not None or cfg.file_roi_save or cfg.file_roi_load,
         "roi / roisave / roiload")
    need(cfg.roi_map, "roimap")
    need(cfg.clpac > 0 and cfg.iterations > 1,
         "cellpackets > 0 with iterations > 1")
    need(cfg.with_ali, "ali")
    need(cfg.with_reference, "reference (WITH_REFERENCE)")
    need(cfg.has_key("SUBITERATIONS"), "SUBITERATIONS")
    need(len(cfg.file_abundance) > 0, "abundance (WITH_ABU / WITH_MSF)")
    need(cfg.step_weight[0] in (1, 2) and cfg.step_weight[1] > 0,
         "stepweight")
    need(cfg.dir_weight[0] >= 0 and abs(cfg.dir_weight[1]) > 1e-6,
         "direweight")
    need(cfg.mirror, "mirror")
    need(cfg.do_split, "split")
    need(cfg.n_domains, "domains")
    need(cfg.mmap_absorbed, "mmapabs")
    need(cfg.optishalf, "optishalf")
    need(cfg.polmap or cfg.polstat or cfg.b_files, "polmap / polstat")
    need(cfg.file_savetau, "savetau")
    need(cfg.file_pssavetau, "pssavetau")
    need(cfg.npix[1] <= 0, "healpix maps (mapping N 0)")
    need(cfg.intobs[0] > -1e7, "perspective maps")
    need(cfg.fast_map >= 999, "MAP_HIER maps (mapping ... 999)")
    need(cfg.map_interpolation, "mapint (MAP_INTERPOLATION)")
    need(cfg.interpolate, "interpolate")
    need(cfg.y_shear != 0.0, "yshear")
    need(cfg.level_threshold > 0, "threshold")
    need(cfg.fits, "FITS")
    need(cfg.file_checkpoint, "checkpoint")
    need(cfg.lib_abs or cfg.lib_maps or cfg.file_library,
         "libabs / libmaps / library")
    need(cfg.nn_make or cfg.nn_solve, "nnmake / nnsolve")
    need(cfg.abs_thin > 1, "absthin")
    need(cfg.cr_heating, "CR_HEATING")
    need(cfg.aalg, "polarisation")
    need(cfg.save_intensity > 0, "saveint / dustem")
    need(cfg.load_temperature, "loadtemp")
    need(cfg.file_constant_load or cfg.file_constant_save, "cload / csave")
    need(not (cfg.sim_f[0] <= 1.0e8 and cfg.sim_f[1] >= 1.0e17), "simum")
    return out


def check_supported(cfg):
    if int(cfg.n_domains) > 1 and int(cfg.n_devices) not in (0, 1):
        raise ValueError("`devices` and `domains` are mutually exclusive: "
                         "pick packet/frequency sharding or Z-slab "
                         "decomposition")
    missing = unsupported_features(cfg)
    if missing:
        raise NotImplementedError(
            "not supported by soc_tpu_torch yet: " + ", ".join(missing))


def run(ini_path=None, cfg=None, device=None, lanes=DEFAULT_LANES,
        write_files=True, workdir=None, devices=None):
    """Full run of one ini on ``device``; returns RunResult. workdir
    defaults to the ini's directory. ``devices``, a list of devices (which
    may repeat one), runs the product path over them in place of the
    ini's `devices N`; the outputs are gathered on ``device``."""
    if device is None:
        raise ValueError("run: pass the device explicitly ('cuda' or 'cpu')")
    device = torch.device(device)
    t_start = time.time()
    if cfg is None:
        cfg = RunConfig(ini_path)
    if workdir is None:
        workdir = os.path.dirname(os.path.abspath(ini_path)) if ini_path \
            else "."
    orig = os.getcwd()
    os.chdir(workdir)
    try:
        return _run_inner(cfg, device, lanes, write_files, t_start,
                          devices)
    finally:
        os.chdir(orig)


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
    """Map-frequency selection: the `wavelength` band or `mapum`."""
    freq = np.asarray(freq)
    if cfg.single_map_freq:
        return nearest_freq_mask(freq, cfg.single_map_freq)
    return (freq >= cfg.map_freq[0]) & (freq <= cfg.map_freq[1])


def _scaled_absorbed(grid, intf, gl_cm, nnn_limit=0.0):
    """Per-frequency tallies -> absorbed.data payload: scale by
    8^level*FACTOR/(GL*PARSEC)/DENS, mark parent cells -1e20, and cells
    with DENS <= nnn_limit the same way."""
    lev = equilibrium.cell_levels(grid).cpu().numpy()
    dens = grid.dens.cpu().numpy()
    fabs = intf.cpu().numpy() if isinstance(intf, torch.Tensor) \
        else np.asarray(intf)
    coeff = (8.0 ** lev) * (FACTOR / gl_cm)
    with np.errstate(divide="ignore", invalid="ignore"):
        fabs = fabs * (coeff / np.maximum(dens, 1e-35))[:, None]
    fabs[dens <= max(0.0, nnn_limit)] = -1.0e20
    return fabs


def _write_emitted_file(cfg, freq, emitted):
    """emitted.data with the reference ABI: only the REMIT-band columns."""
    mask = remit_mask_of(cfg, freq)
    write_cell_frequency_array(cfg.file_emitted,
                               np.asarray(emitted)[:, mask])


def simulate_background(grid, medium, cfg, ibg, tabs, intf, seed,
                        lanes=DEFAULT_LANES, per_freq_tally=False,
                        pmesh=None):
    """Phase-1 isotropic background over all frequencies, in one mixed
    pool; with ``pmesh`` (`devices N`) over the mesh, one pool per shard
    (product.run_freqs), intf then the mesh's slabs. The reference
    sends 8*AREA*BATCH packets per frequency; the same normalisation keeps
    the tallies comparable. Returns
    (tabs, intf, escaped[NF], injected[NF], packets)."""
    area = int(grid.area)
    batch = max(1, int(round(cfg.bgpac / (8.0 * area))))
    per_freq = 8 * area * batch                 # packets per frequency
    wbg = np.pi / (PLANCK * 8.0 * batch)
    bg_photons = (np.asarray(ibg, np.float64) * wbg
                  / np.asarray(cfg.freq, np.float64)).astype(np.float32)
    total = per_freq * medium.nfreq
    injected = np.float64(per_freq) * np.asarray(bg_photons, np.float64)
    if pmesh is not None:
        from ..parallel import product
        tabs, intf, escaped = product.run_freqs(
            pmesh, grid, medium, "bg", bg_photons, per_freq, tabs, intf,
            seed, lanes, per_freq_tally)
        return tabs, intf, escaped, injected, total
    physics = dict(kabs=medium.abs_gl, ksca=medium.sca_gl, csc=medium.csc,
                   tw=medium.tw)
    params = dict(photons=torch.as_tensor(bg_photons, device=grid.device),
                  per_freq=per_freq, hi_base=stream_hi_base("bg"))
    tabs, intf, escaped, _ = transport_run(
        grid, physics, params, total, tabs, intf, seed, source_kind="bg",
        nlanes=pool_lanes(lanes, total), per_freq_tally=per_freq_tally)
    return tabs, intf, escaped.cpu().numpy(), injected, total


def _product_setup(cfg, nfreq, device, devices=None):
    """The (dp x freq) mesh of the product path, or None for a one-device
    run: over ``devices`` when given, else over the ini's `devices N`
    (cuda:0 .. cuda:N-1 on a card, the CPU N times on the CPU; N < 0 means
    every visible card)."""
    from ..parallel.product import ProductMesh
    if devices is not None:
        return ProductMesh(len(devices), nfreq, devices) \
            if len(devices) > 1 else None
    n = int(cfg.n_devices)
    if n < 0:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n <= 1:
        return None
    return ProductMesh(n, nfreq, [device] * n if device.type == "cpu"
                       else None)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_inner(cfg, device, lanes, write_files, t_start, devices):
    cfg.validate()
    check_supported(cfg)
    res = RunResult()
    timings = res.timings

    # ---- model input
    t0 = time.time()
    grid = read_cloud(cfg.file_cloud, device, cfg.kdensity, cfg.max_levels)
    if grid.levels > 1:
        raise NotImplementedError(
            "not supported by soc_tpu_torch yet: octree with more than 1 "
            "level (%d levels in %s)" % (grid.levels, cfg.file_cloud))
    optics = [read_simple_dust(f, cfg.gl) for f in cfg.file_optical]
    freq = optics[0].freq
    cfg.freq = freq
    cfg.nfreq = len(freq)
    nfreq = len(freq)
    bins = cfg.dsc_bins if cfg.dsc_bins > 0 else 2500
    dsc, csc = read_scattering_function(cfg.file_scafunc[0], nfreq, bins)
    medium = medium_from_optics(optics, dsc, csc, device, freq)
    pmesh = _product_setup(cfg, nfreq, device, devices)
    res.grid, res.freq = grid, freq
    res.devices = None if pmesh is None else pmesh.devices
    seed = int(np.uint32(max(0.0, cfg.seed) * 2**31) + np.uint32(12345))
    timings["input"] = time.time() - t0

    if write_files:
        np.asarray([cfg.bgpac, cfg.pspac, cfg.dfpac, cfg.clpac],
                   np.int32).tofile("packet.info")

    # ---- map-only mode (iterations 0 + an existing emitted file)
    if cfg.iterations < 1 and os.path.exists(cfg.file_emitted):
        emitted = read_cell_frequency_array(cfg.file_emitted)
        if emitted.shape[1] != nfreq:
            # remit-band file: embed into the full frequency grid
            mask = remit_mask_of(cfg, freq)
            if mask.sum() != emitted.shape[1]:
                raise ValueError(
                    "emitted file has %d freqs; the remit selection has %d"
                    % (emitted.shape[1], int(mask.sum())))
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

    # ---- phase 1: the isotropic background
    t0 = time.time()
    per_freq_tally = not cfg.noabsorbed
    tabs = torch.zeros(grid.cells, dtype=torch.float32, device=device)
    if pmesh is not None and per_freq_tally:
        # dp-partial per-frequency slabs, one per shard on its device
        intf = pmesh.zeros_intf(grid.cells)
    else:
        intf = torch.zeros((grid.cells, nfreq) if per_freq_tally else (1, 1),
                           dtype=torch.float32, device=device)
    escaped = np.zeros(nfreq)
    injected = np.zeros(nfreq)
    if cfg.bgpac > 0 and cfg.file_background:
        ibg = read_background_intensity(cfg.file_background, nfreq)
        ibg = ibg * cfg.scale_background
        tabs, intf, esc, inj, npk = simulate_background(
            grid, medium, cfg, ibg, tabs, intf, seed, lanes, per_freq_tally,
            pmesh)
        escaped += esc
        injected += inj
        res.packets = npk
    if pmesh is not None and per_freq_tally:
        intf = pmesh.reduce_intf(intf, device)
    _sync(device)
    res.ctabs = tabs.cpu().numpy()
    res.escaped = escaped
    res.injected = injected
    timings["constant_sources"] = time.time() - t0

    # ---- phase 2: equilibrium temperature + emission (one iteration:
    # with no cell packets nothing changes between iterations)
    t0 = time.time()
    gl_cm = cfg.gl * PARSEC
    temperature = None
    emitted = None
    if not cfg.nosolve and cfg.iterations >= 1:
        table = equilibrium.build_temperature_table(
            freq, optics[0].abs_gl, cfg.gl, device)
        if pmesh is not None:
            from ..parallel import product
            temperature = product.solve_temperature(pmesh, grid, table, tabs,
                                                    gl_cm)
            emitted = product.emission(pmesh, freq, optics[0].abs_gl,
                                       temperature, gl_cm)
        else:
            temperature = equilibrium.solve_temperature(grid, table, tabs,
                                                        gl_cm)
            emitted = equilibrium.emission(freq, optics[0].abs_gl,
                                           temperature, gl_cm)
        mask = remit_mask_of(cfg, freq)
        if not mask.all():
            emitted = emitted * torch.as_tensor(
                mask.astype(np.float32), device=device)[None, :]
        res.temperature = temperature.cpu().numpy()
        res.emitted = emitted.cpu().numpy()
    timings["solve"] = time.time() - t0

    # ---- outputs (reference end-of-run scaling)
    t0 = time.time()
    if per_freq_tally:
        res.absorbed_photons = intf.sum(0, dtype=torch.float64).cpu().numpy()
        res.absorbed = _scaled_absorbed(grid, intf, gl_cm, cfg.nnn_limit)
        if write_files and cfg.file_absorbed:
            write_cell_frequency_array(cfg.file_absorbed, res.absorbed)
    if write_files and temperature is not None and cfg.file_temperature:
        write_cell_field(cfg.file_temperature, grid, res.temperature)
    if write_files and emitted is not None and cfg.file_emitted:
        _write_emitted_file(cfg, freq, res.emitted)
    timings["outputs"] = time.time() - t0
    _render_phase(cfg, grid, medium, res, freq, emitted, write_files,
                  timings, pmesh)
    timings["total"] = time.time() - t_start
    return res


def _render_phase(cfg, grid, medium, res, freq, emitted, write_files,
                  timings, pmesh=None):
    """Phase 3: orthographic frequency-fused maps, map_dir_XX.bin.

    emitted: [CELLS, NFREQ] host array or device tensor (or None).
    With ``pmesh`` the map's rows and channels are split over the mesh
    when NY divides by dp and the selected channels by freq (soc_tpu's
    conditions, driver.py:2063-2068 there, less those on keywords the
    port does not take yet); otherwise it renders on the first shard's
    device, as soc_tpu falls back."""
    t0 = time.time()
    device = grid.device
    if cfg.nomap or emitted is None:
        timings["maps"] = time.time() - t0
        return
    fsel = map_freq_mask(cfg, freq)
    if not fsel.any():
        timings["maps"] = time.time() - t0
        return
    centre = cfg.mapcentre
    if centre[0] < -1e7:
        centre = (0.5 * grid.nx, 0.5 * grid.ny, 0.5 * grid.nz)
    kk = render_mapping.map_scale_kk(cfg.gl)
    freq_s = np.asarray(freq)[fsel]
    shard_maps = (pmesh is not None and cfg.npix[1] % pmesh.n_dp == 0
                  and int(fsel.sum()) % pmesh.n_freq == 0)
    if pmesh is not None and not shard_maps:
        device = pmesh.devices[0]
        grid = pmesh.replica(grid, device)
    emitted = torch.as_tensor(emitted, device=device)
    scale = torch.as_tensor((kk * freq_s).astype(np.float32), device=device)
    sel_idx = torch.as_tensor(np.nonzero(fsel)[0], device=device)
    emit_map = emitted[:, sel_idx].to(torch.float32) * scale[None, :]
    ext_gl = torch.as_tensor(
        (medium.abs_gl.cpu().numpy() + medium.sca_gl.cpu().numpy())[fsel],
        device=device)
    for idir in range(len(cfg.obs_theta)):
        odir, ra, de = render_mapping.observer_basis(cfg.obs_theta[idir],
                                                     cfg.obs_phi[idir])
        if shard_maps:
            from ..parallel.mesh import sharded_render_ortho
            phot, _, _ = sharded_render_ortho(
                grid, emit_map, ext_gl, odir, ra, de, centre, cfg.map_dx,
                tuple(cfg.npix), pmesh)
        else:
            phot, _, _ = render_mapping.render_ortho(
                grid, emit_map, ext_gl, odir, ra, de, centre, cfg.map_dx,
                tuple(cfg.npix))
        res.maps[idir] = phot.cpu().numpy()
        if write_files:
            write_map_file("map_dir_%02d.bin" % idir, res.maps[idir])
    timings["maps"] = time.time() - t0
