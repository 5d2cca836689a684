"""Scattered-light pipeline (port of soc_tpu.pipeline.scattering, the
ASOCS.py workload).

Simulates packets from every configured source with peel-off toward the
observers and accumulates OUT over the channels in the `simum` band:

  * isotropic background   (`background` + `bgpackets`; SimRAM_PB)
  * Healpix-sky background (`hpbg`; SimRAM_HP), each pixel's weight times
    the cloud's projected area toward it (_hpbg_projected_area)
  * point sources          (`pointsource` + `pspackets`; SimRAM_PS)
  * dust cell emission     (`cellpackets`, read from the `emitted` file:
    EMIT = EMITTED 1e-20 GL PARSEC / 8^level DENS, ASOCS.py:790-795)
  * the ROI boundary load  (`roiload` + `roipackets`; ASOCS II==3)
  * the diffuse field      (`diffuse`: EMIT = DIFFUSERAD K_DIFFUSE GL
    PARSEC / 8^level, ASOCS.py:640-650)

soc_tpu runs a pool a channel and source; the port runs one mixed pool a
source over the band's channels (render/scattered.py), each packet with
soc_tpu's identity (the source's phase tag, its channel, its index within
the channel), so it traces the packets of soc_tpu's run. ``per_channel``
runs soc_tpu's pool a channel instead (the tests hold the two to each
other). With `perspective x y z` (and `outnside N`, default 128) the
output is an all-sky Healpix map around the internal observer (NDIR<0,
ASOCS.py:43-49); otherwise [NDIR, NY, NX] orthographic maps. Two or more
dusts with one `dsc` file each turn WITH_MSF on (the species roulette
and the abundance-weighted mean DSC; abundances 1/NDUST unless read from
the `abundance` files). `devices N` splits each source's budget over N
devices by id range (scattered.simulate_scattering_sharded), over
several processes too, each stepping its own shards.

Output container `outcoming.socs` (ASOCS.py:385-402):
  flat maps: int32 [NY, NX, NFREQ] + float32 FFREQ + [NFREQ, NDIR, NY, NX]
  healpix  : int32 [NSIDE, NFREQ]  + float32 FFREQ + [NFREQ, 12 NSIDE^2]
or, with `fits 1`, one direction and flat maps, '<scattering>.fits'.
Values are scaled to surface brightness by FREQ 1e23 PLANCK / DX^2
(Healpix: / the pixel's solid angle), ASOCS.py:873-884.
"""

import os

import numpy as np
import torch

from ..config import RunConfig
from ..constants import PARSEC, PLANCK
from ..io.cloud import read_cloud
from ..io.dust import read_scattering_function, read_simple_dust
from ..io.fields import read_background_intensity, read_cell_frequency_array
from ..render import healpix as hp
from ..render import mapping as render_mapping
from ..render import scattered
from ..solve.equilibrium import cell_levels
from ..transport.medium import medium_from_optics
from ..transport.propagate import pool_lanes
from ..transport.sources import stream_hi_base
from ..utils import trace

# the lane pool of each of the two loops: a march step is about 250
# eager kernels that the host issues one by one, so a step's time grows
# little with the pool and a wider pool sends more packets a second
# (PERF.md)
DEFAULT_LANES = 1 << 20
DEFAULT_CAPACITY = 1 << 20  # scattering events buffered between peel-offs


def _hpbg_projected_area(grid, npix):
    """Per-pixel A_proj(dir) / (AREA/4): the cloud's projected area toward
    each Healpix pixel over the isotropic mean (<|cos|> = 1/2 a face makes
    the mean of A_proj over the sphere AREA/4)."""
    nside = int(np.sqrt(npix // 12))
    theta, phi = hp.pix2ang_ring(nside, torch.arange(npix))
    theta = theta.numpy()
    phi = phi.numpy()
    st = np.sin(theta)
    d = np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], -1)
    aproj = (np.abs(d[:, 0]) * grid.ny * grid.nz
             + np.abs(d[:, 1]) * grid.nx * grid.nz
             + np.abs(d[:, 2]) * grid.nx * grid.ny)
    return aproj / (grid.area / 4.0)


def run(ini_path=None, cfg=None, device=None, lanes=DEFAULT_LANES,
        write_files=True, workdir=None, devices=None, per_channel=False,
        passes=None):
    """The `sca` verb on one ini; returns OUT [NFREQ, NDIR, NY, NX] (or
    [NFREQ, 12 NSIDE^2]) float32, as soc_tpu's run does. workdir defaults
    to the ini's directory. ``devices`` (a list, which may repeat one
    device) runs every source over them in place of the ini's `devices
    N`. ``passes``, a list if given, receives one dict a source pass:
    its source, channels, packets, pools, seconds, events, peel-off rays,
    lane steps of the transport and of the peel-off and their bodies.
    Under several processes (parallel/dist.py) `devices N` spans every
    process's devices (dist.global_devices, as for rt): a process steps
    its own shards and every process returns the same maps; without it
    every process runs the whole run on its own device. Process 0 alone
    writes files."""
    from ..parallel import dist
    if device is None:
        raise ValueError("run: pass the device explicitly ('cuda' or 'cpu')")
    device = torch.device(device)
    if cfg is None:
        cfg = RunConfig(ini_path)
    write_files = write_files and dist.process_index() == 0
    if workdir is None:
        workdir = os.path.dirname(os.path.abspath(ini_path)) if ini_path \
            else "."
    orig = os.getcwd()
    os.chdir(workdir)
    try:
        return _run_inner(cfg, device, lanes, write_files, devices,
                          per_channel, passes)
    finally:
        os.chdir(orig)


def _sources(cfg, grid, freq, area):
    """[(source tag, generator kind, host tables, packets a channel,
    channels)] of the ini's sources, each table full width over the
    channels and each channel's values formed as soc_tpu forms them for
    its pool."""
    nfreq = len(freq)
    sim_lo, sim_hi = cfg.sim_f
    band = [i for i in range(nfreq) if sim_lo <= freq[i] <= sim_hi]
    out = []
    if cfg.bgpac > 0 and cfg.file_background:
        ibg = read_background_intensity(cfg.file_background, nfreq) \
            * cfg.scale_background
        batch = max(1, int(round(cfg.bgpac / (8.0 * area))))
        per_freq = 8 * area * batch
        wbg = np.pi / (PLANCK * 8.0 * batch)
        ph = np.zeros(nfreq, np.float32)
        for i in band:
            ph[i] = np.float32(ibg[i] * wbg / freq[i])
        out.append(("sca_bg", "bg", dict(photons=ph), per_freq, band))
    if cfg.bgpac > 0 and cfg.file_hpbg:
        sky = np.fromfile(cfg.file_hpbg, np.float32).reshape(nfreq, -1) \
            * cfg.scale_background
        per_freq = max(1, int(cfg.bgpac))
        wbg = np.pi * area / (PLANCK * per_freq)
        aproj = _hpbg_projected_area(grid, sky.shape[1])
        table = np.zeros(sky.shape, np.float32)
        for i in band:
            vals = np.asarray(sky[i], np.float64) * (wbg / freq[i])
            table[i] = (vals * aproj).astype(np.float32)
        out.append(("sca_hpbg", "hpbg", dict(hpbg=table), per_freq, band))
    if cfg.no_ps > 0 and cfg.pspac > 0:
        lps = np.zeros((cfg.no_ps, nfreq), np.float32)
        for i, f in enumerate(cfg.file_pointsource):
            lps[i] = np.fromfile(f, np.float32, nfreq) * cfg.ps_scale[i]
        pspac = max(1, cfg.pspac)
        wps = 1.0 / (PLANCK * pspac * (cfg.gl * PARSEC) ** 2)
        ph = np.zeros((cfg.no_ps, nfreq), np.float32)
        for i in band:
            ph[:, i] = (lps[:, i] * wps / freq[i]).astype(np.float32)
        out.append(("sca_ps", "ps", dict(
            ps_pos=np.asarray(cfg.ps_pos, np.float32), photons=ph),
            pspac * cfg.no_ps, band))
    lev = dens = None
    if cfg.clpac > 0 or cfg.file_diffuse:
        lev = cell_levels(grid).cpu().numpy()
        dens = grid.dens.cpu().numpy()
    if cfg.clpac > 0:
        if not os.path.exists(cfg.file_emitted):
            # soc_tpu raises rather than drop the dust-emission source
            raise FileNotFoundError(
                "scattering: cellpackets %d but the emitted file %r does "
                "not exist (run the rt/emission stage first, or set "
                "cellpackets 0)" % (cfg.clpac, cfg.file_emitted))
        emitted = read_cell_frequency_array(cfg.file_emitted)
        if emitted.shape[1] != nfreq:
            from .driver import remit_mask_of
            full = np.zeros((emitted.shape[0], nfreq), np.float32)
            full[:, remit_mask_of(cfg, freq)] = emitted
            emitted = full
        per_cell = max(1, int(cfg.clpac) // grid.cells)
        table = np.zeros((grid.cells, nfreq), np.float32)
        for i in band:
            emit = (np.asarray(emitted[:, i], np.float64)
                    * (1.0e-20 * cfg.gl * PARSEC / 8.0 ** lev) * dens)
            emit[dens < 1e-10] = 0.0
            table[:, i] = (emit / per_cell).astype(np.float32)
        out.append(("sca_cell", "cell", dict(emit=table, per_cell=per_cell),
                    per_cell * grid.cells, band))
    if cfg.file_roi_load and cfg.roipac > 0:
        from ..transport.roi import read_roi_file
        rnx, rny, rnz, rl_nside, rl_data = read_roi_file(cfg.file_roi_load)
        rl_npix = 12 * rl_nside * rl_nside
        rl_nelem = rl_data.shape[1] // rl_npix
        reps = max(1, int(cfg.roipac) // (rl_nelem * rl_npix))
        load = np.zeros((nfreq, rl_nelem, rl_npix), np.float32)
        for i in band:
            load[i] = (np.asarray(rl_data[i], np.float64)
                       * cfg.roi_load_scale).reshape(
                           rl_nelem, rl_npix).astype(np.float32)
        out.append(("roi", "roi", dict(roi_load=load,
                                       roi_dim=(rnx, rny, rnz), reps=reps),
                    reps * rl_nelem * rl_npix, band))
    if cfg.file_diffuse and (cfg.dfpac > 0 or cfg.clpac > 0):
        from .driver import read_diffuse_field
        field = read_diffuse_field(cfg.file_diffuse, grid.cells)
        dfpac = cfg.dfpac if cfg.dfpac > 0 else cfg.clpac
        per_cell = max(1, int(dfpac) // grid.cells)
        table = np.zeros((grid.cells, nfreq), np.float32)
        chans = []
        for i in band:
            dr_ind = i + (field.shape[1] - nfreq)
            if dr_ind < 0:
                continue
            emit = (np.asarray(field[:, dr_ind], np.float64)
                    * (cfg.k_diffuse * cfg.gl * PARSEC / 8.0 ** lev))
            emit[dens < 1e-10] = 0.0
            table[:, i] = (emit / per_cell).astype(np.float32)
            chans.append(i)
        out.append(("diffuse", "cell", dict(emit=table, per_cell=per_cell),
                    per_cell * grid.cells, chans))
    return out


def _physics(medium, optics, dscs, cscs, grid, cfg, device):
    """The transport's tables over all channels; with WITH_MSF (two or
    more dusts, a `dsc` file each) the species tables and abundances
    (1/NDUST unless given by the `abundance` files)."""
    physics = dict(kabs=medium.abs_gl, ksca=medium.sca_gl, csc=medium.csc,
                   dsc=medium.dsc)
    ndust = len(optics)
    if ndust > 1 and len(dscs) == ndust:
        abu = np.ones((grid.cells, ndust), np.float32) / ndust
        for d, path in enumerate(cfg.file_abundance[:ndust]):
            if path and not path.startswith("#"):
                abu[:, d] = np.fromfile(path, np.float32, grid.cells)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)
        sca = np.stack([np.asarray(o.sca_gl) for o in optics])
        physics.update(msf_abu=t(abu), msf_csc=t(np.stack(cscs)),
                       msf_dsc=t(np.stack(dscs).transpose(1, 0, 2)),
                       msf_sca=t(sca.T))
    return physics


def _run_inner(cfg, device, lanes, write_files, devices, per_channel,
               passes):
    cfg.validate()
    grid = read_cloud(cfg.file_cloud, device, cfg.kdensity, cfg.max_levels)
    optics = [read_simple_dust(f, cfg.gl) for f in cfg.file_optical]
    freq = optics[0].freq
    cfg.freq = freq
    nfreq = len(freq)
    bins = cfg.dsc_bins if cfg.dsc_bins > 0 else 2500
    if not cfg.file_scafunc:
        raise ValueError("scattered-light run needs a `dsc` file in the ini")
    dscs, cscs = [], []
    for path in cfg.file_scafunc:
        d, c = read_scattering_function(path, nfreq, bins)
        dscs.append(d)
        cscs.append(c)
    medium = medium_from_optics(optics, dscs[0], cscs[0], device, freq)
    seed = int(np.uint32(max(0.0, cfg.seed) * 2**31) + np.uint32(77777))
    physics = _physics(medium, optics, dscs, cscs, grid, cfg, device)

    ndir = len(cfg.obs_theta)
    npix = tuple(cfg.npix)
    healpix_nside = 0
    obs_pos = None
    if cfg.intobs[0] > -1e7:
        # the internal observer: an all-sky Healpix map
        healpix_nside = int(cfg.keys.get("outnside", [[128]])[0][0])
        obs_pos = cfg.intobs
    odirs = np.zeros((ndir, 3), np.float32)
    ras = np.zeros((ndir, 3), np.float32)
    des = np.zeros((ndir, 3), np.float32)
    for i in range(ndir):
        odirs[i], ras[i], des[i] = render_mapping.observer_basis(
            cfg.obs_theta[i], cfg.obs_phi[i])
    centre = cfg.mapcentre
    if centre[0] < -1e7:
        centre = (0.5 * grid.nx, 0.5 * grid.ny, 0.5 * grid.nz)
    from .driver import _product_setup
    pm = _product_setup(cfg, nfreq, device, devices)
    # room for two groups of bodies between checks (a body appends at most
    # a row a lane and service): a round then ends only when the buffer is
    # half full, so the peel-off's drain tail is paid once per many bodies
    capacity = max(DEFAULT_CAPACITY, 2 * scattered.CHECK_EVERY * lanes
                   * (scattered.SCA_PERIOD // scattered.SERVICE_PERIOD))
    shape = scattered.out_shape_of(nfreq, npix, ndir, healpix_nside)
    total_out = torch.zeros(shape, dtype=torch.float32, device=device)

    def sim(kind, params, total):
        nl = pool_lanes(lanes, total)
        args = (grid, physics, params, total, odirs, ras, des, centre,
                cfg.map_dx, npix, seed, kind, nl, cfg.ffs > 0, capacity,
                healpix_nside, obs_pos)
        if pm is not None:
            return scattered.simulate_scattering_sharded(pm, *args,
                                                         return_stats=True)
        return scattered.simulate_scattering(*args, return_stats=True)

    for tag, kind, tables, per_freq, chans in _sources(
            cfg, grid, freq, int(grid.area)):
        if not chans:
            continue
        st = dict(source=tag, channels=len(chans),
                  packets=per_freq * len(chans), events=0, rays=0,
                  lane_steps=0, peel_lane_steps=0, sca_iters=0, peel_iters=0)
        with trace.span("transport.pass", into=st, key="seconds",
                        source=tag, packets=st["packets"]):
            params = {k: torch.as_tensor(v, device=device)
                      if isinstance(v, np.ndarray) else v
                      for k, v in tables.items()}
            params["hi_base"] = stream_hi_base(tag)
            runs = ([dict(params, ifreq=i) for i in chans] if per_channel
                    else [dict(params, per_freq=per_freq,
                               sel=torch.as_tensor(
                                   np.asarray(chans, np.int64),
                                   device=device))])
            st["pools"] = len(runs)
            for p in runs:
                out, s = sim(kind, p, per_freq if per_channel
                             else per_freq * len(chans))
                total_out += out.to(device)
                for k in ("events", "rays", "lane_steps", "peel_lane_steps",
                          "sca_iters", "peel_iters"):
                    st[k] += s[k]
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if passes is not None:
            passes.append(st)

    outcoming = total_out.cpu().numpy()
    # final surface-brightness scaling (ASOCS.py:873-884)
    for ifreq in range(nfreq):
        if healpix_nside > 0:
            k = freq[ifreq] * 1.0e23 * PLANCK \
                / (4.0 * np.pi / (12.0 * healpix_nside ** 2))
        else:
            k = freq[ifreq] * 1.0e23 * PLANCK / (cfg.map_dx ** 2)
        outcoming[ifreq] *= k

    if write_files:
        if cfg.fits > 0 and healpix_nside <= 0 and ndir == 1:
            # a one-direction FITS cube in place of the container
            # (ASOCS.py:387-392, 892); 1 kpc when `distance` is unset
            from ..io.fits import write_fits_image
            pix_deg = np.degrees(cfg.map_dx * cfg.gl
                                 / (cfg.distance if cfg.distance > 0
                                    else 1000.0))
            write_fits_image("%s.fits" % cfg.file_scattering,
                             outcoming[:, 0], ra_deg=cfg.fits_ra,
                             de_deg=cfg.fits_de, pix_deg=pix_deg)
        else:
            with open("outcoming.socs", "wb") as fp:
                if healpix_nside > 0:
                    np.asarray([healpix_nside, nfreq], np.int32).tofile(fp)
                else:
                    np.asarray([npix[1], npix[0], nfreq],
                               np.int32).tofile(fp)
                np.asarray(freq, np.float32).tofile(fp)
                outcoming.tofile(fp)
    return outcoming
