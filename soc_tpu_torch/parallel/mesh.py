"""Multi-device execution as a library (port of soc_tpu.parallel.mesh):
make_mesh, the sharded sources, solves and render, and sharded_pipeline,
the simulate -> solve -> re-emit -> map chain over a mesh.

A mesh is a product.ProductMesh: N devices in a (dp, freq) layout, shard
(dp, fq) on device devices[dp*F + fq], over every process's devices when
the run spans several (parallel/dist.py). Each transport function runs
one product.run_freqs pass: each shard drains one mixed-frequency pool
over its block of channels with its dp part of each channel's budget,
the same packets on the same streams as soc_tpu's per-channel
transport_run with k0 = dp*per_dev, and the shards' TABS and escape
vectors summed in shard order. soc_tpu's asserts stand: NFREQ must divide
the freq axis, per_freq the dp axis.
"""

import numpy as np
import torch

from ..constants import PARSEC
from ..render import mapping as render_mapping
from ..solve import equilibrium
from ..transport.sources import stream_hi_base
from . import dist, product
from .product import ProductMesh


def make_mesh(devices=None, freq_axis=1):
    """A (dp, freq) mesh over ``devices`` (None: every process's cards,
    dist.global_devices) with F = freq_axis, or 1 where it does not divide
    the device count (soc_tpu's make_mesh)."""
    if devices is None:
        devs, owners = dist.global_devices(torch.device("cuda"))
        return ProductMesh(len(devs), None, devs, freq_axis=freq_axis,
                           owners=owners)
    return ProductMesh(len(devices), None, devices, freq_axis=freq_axis)


def _sharded_transport(grid, medium, mesh, kind, hi_base, per_freq, params,
                       seed, nlanes):
    """One uniform-budget pass of source ``kind`` over every channel:
    per_freq packets a channel split over dp. Returns (tabs [CELLS] on
    the grid's device, escaped [NFREQ] float64)."""
    pm = mesh.with_nfreq(medium.nfreq)
    assert per_freq % pm.n_dp == 0, "per_freq must divide the dp mesh axis"
    physics = dict(kabs=medium.abs_gl, ksca=medium.sca_gl, csc=medium.csc,
                   tw=medium.tw)
    tabs = torch.zeros(grid.cells, dtype=torch.float32, device=grid.device)
    tabs, _, out = product.run_freqs(
        pm, grid, physics, kind, params, np.arange(medium.nfreq), per_freq,
        tabs, None, seed, nlanes, False, hi_base)
    return tabs, out["escaped"]


def _t(x, grid):
    return torch.as_tensor(np.asarray(x, np.float32), device=grid.device)


def sharded_background_run(grid, medium, bg_photons, per_freq, seed, mesh,
                           nlanes=1 << 14):
    """The isotropic background over the mesh: bg_photons [NFREQ] photons
    a packet, per_freq packets a channel."""
    return _sharded_transport(grid, medium, mesh, "bg",
                              stream_hi_base("bg"), per_freq,
                              dict(photons=_t(bg_photons, grid)), seed,
                              nlanes)


def sharded_point_source_run(grid, medium, ps_pos, ps_photons, per_freq,
                             seed, mesh, nlanes=1 << 14):
    """Point sources over the mesh: ps_pos [S, 3], ps_photons [S, NFREQ]
    photons a packet."""
    return _sharded_transport(
        grid, medium, mesh, "ps", stream_hi_base("ps"), per_freq,
        dict(ps_pos=_t(ps_pos, grid), photons=_t(ps_photons, grid)), seed,
        nlanes)


def sharded_hpbg_run(grid, medium, hpbg_photons, per_freq, seed, mesh,
                     nlanes=1 << 14):
    """The Healpix sky over the mesh: hpbg_photons [NFREQ, NPIX] photons a
    packet of each pixel (pixels drawn uniformly)."""
    return _sharded_transport(grid, medium, mesh, "hpbg",
                              stream_hi_base("hpbg"), per_freq,
                              dict(hpbg=_t(hpbg_photons, grid)), seed,
                              nlanes)


def sharded_cell_emission_run(grid, medium, emitted, per_cell, seed, mesh,
                              iteration=0, nlanes=1 << 14):
    """The dust's re-emission over the mesh (SimRAM_CL): emitted [CELLS,
    NFREQ] photons/Hz/H, a packet's weight EMIT / per_cell, per_cell *
    CELLS packets a channel."""
    emit = np.asarray(emitted, np.float32) / np.float32(per_cell)
    return _sharded_transport(
        grid, medium, mesh, "cell", stream_hi_base("cell", iteration),
        per_cell * grid.cells, dict(emit=_t(emit, grid), per_cell=per_cell),
        seed, nlanes)


def sharded_solve_temperature(grid, table, emit_total, gl_cm, mesh,
                              cr_heating=0.0):
    """The equilibrium temperature [CELLS] with the cells split over the
    whole mesh (product.solve_temperature), on emit_total's device."""
    return product.solve_temperature(
        mesh, grid, table, torch.as_tensor(emit_total, device=grid.device),
        gl_cm, cr_heating=cr_heating)


def sharded_emission(freq, abs_gl, temperature, gl_cm, mesh):
    """Thermal emission [CELLS, NFREQ] with the cells split over the mesh
    (product.emission)."""
    return product.emission(mesh, freq, abs_gl, temperature, gl_cm)


def sharded_render_ortho(grid, emit_map, ext_gl, odir, ra, de, centre,
                         map_dx, npix, pm):
    """Orthographic map with the pixel rows split over the mesh's dp axis
    and the frequency channels over its freq axis: shard (dp, fq) renders
    rows [dp*NY/n_dp, (dp+1)*NY/n_dp) of channels [fq*NF/F, (fq+1)*NF/F)
    on its device. Every ray and channel is computed as in the one-device
    render, so the map equals it bit for bit.

    emit_map [CELLS, NF] and ext_gl [NF] on any device; pm a
    product.ProductMesh with NY % n_dp == 0 and NF % F == 0.
    Returns (photons [NF, NY, NX], tau [NF, NY, NX], colden [NY, NX]) on
    emit_map's device.
    """
    nxp, nyp = npix
    nf = emit_map.shape[1]
    if nyp % pm.n_dp or nf % pm.n_freq:
        raise ValueError("sharded render: NY=%d must divide by dp=%d and "
                         "NF=%d by freq=%d" % (nyp, pm.n_dp, nf, pm.n_freq))
    nrows, nfl = nyp // pm.n_dp, nf // pm.n_freq

    def shard(i, dev):
        dp, fq = divmod(i, pm.n_freq)
        cols = slice(fq * nfl, (fq + 1) * nfl)
        return render_mapping.render_ortho(
            pm.replica(grid, dev), emit_map[:, cols].to(dev).contiguous(),
            ext_gl[cols].to(dev).contiguous(), odir, ra, de, centre, map_dx,
            (nxp, nyp), row0=dp * nrows, nrows=nrows)

    device = emit_map.device
    phot = torch.empty((nf, nyp, nxp), dtype=torch.float32, device=device)
    tau = torch.empty_like(phot)
    colden = torch.empty((nyp, nxp), dtype=torch.float32, device=device)
    for i, (p, t, c) in enumerate(pm.gather_shards(pm.map_shards(shard))):
        dp, fq = divmod(i, pm.n_freq)
        rows = slice(dp * nrows, (dp + 1) * nrows)
        cols = slice(fq * nfl, (fq + 1) * nfl)
        phot[cols, rows] = p.to(device)
        tau[cols, rows] = t.to(device)
        if fq == 0:            # colden does not depend on the channel
            colden[rows] = c.to(device)
    return phot, tau, colden


def sharded_pipeline(grid, medium, freq, bg_photons, per_freq, gl_pc,
                     mesh, iterations=1, per_cell=1, npix=(16, 16),
                     centre=None, obs=(0.0, 0.0), seed=7, nlanes=1 << 12):
    """The simulate -> solve -> re-emit -> map chain over the mesh
    (soc_tpu's sharded_pipeline): the background, the equilibrium solve
    and emission, ``iterations`` rounds of cell re-emission (per_cell
    packets a cell and channel) each solved on the total heating, and the
    orthographic map. Returns dict(tabs, escaped, temperature, emitted,
    map, tau, colden)."""
    gl_cm = gl_pc * PARSEC
    tabs, esc = sharded_background_run(grid, medium, bg_photons, per_freq,
                                       seed, mesh, nlanes=nlanes)
    table = equilibrium.build_temperature_table(freq, medium.abs_gl, gl_pc,
                                                grid.device)
    emit_total = tabs
    temperature = emitted = None
    for iteration in range(max(1, iterations)):
        if per_cell > 0 and emitted is not None:
            tabs_it, _ = sharded_cell_emission_run(
                grid, medium, emitted.cpu().numpy(), per_cell, seed, mesh,
                iteration=iteration, nlanes=nlanes)
            emit_total = tabs_it + tabs
        temperature = sharded_solve_temperature(grid, table, emit_total,
                                                gl_cm, mesh)
        emitted = sharded_emission(freq, medium.abs_gl, temperature, gl_cm,
                                   mesh)
        if per_cell <= 0:
            break
    if centre is None:
        centre = (0.5 * grid.nx, 0.5 * grid.ny, 0.5 * grid.nz)
    kk = render_mapping.map_scale_kk(gl_pc)
    emit_map = (emitted * torch.as_tensor(
        (kk * np.asarray(freq, np.float32)).astype(np.float32),
        device=emitted.device)[None, :]).to(torch.float32)
    ext_gl = medium.abs_gl + medium.sca_gl
    odir, ra, de = render_mapping.observer_basis(*obs)
    phot, tau, colden = sharded_render_ortho(
        grid, emit_map, ext_gl, odir, ra, de,
        np.asarray(centre, np.float32), 1.0, npix,
        mesh.with_nfreq(medium.nfreq))
    return dict(tabs=tabs, escaped=esc, temperature=temperature,
                emitted=emitted, map=phot, tau=tau, colden=colden)
