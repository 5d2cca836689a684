"""Cells' own emission, the reference's march (SOC's SimRAM_CL with ALI):
every cell of the hierarchy whose emission is not zero in a channel
sends packets_per_cell packets of that channel from uniform points of its
box in isotropic directions, each carrying EMIT[cell, f] /
packets_per_cell photons (the emission as the caller gives it, a refined
cell's too: it is born in the box and lands in a leaf under it). The
packets step and scatter as transport.propagate's do (its locate,
exit_distance and deflect), except that a deposit into the cell that
emitted the packet goes to the self-absorption tally (XAB) in place of
the absorbed one: ALI's split, which propagate does not make."""

import math

import numpy as np
import torch

from .transport import (MAX_SCATTERINGS, NUDGE, PHOTON_LIMIT, deflect,
                        exit_distance, inside, locate)


def cell_boxes(cloud):
    """(lo [CELLS, 3], h [CELLS]) of every cell's box in root cells."""
    lo = np.zeros((cloud.cells, 3))
    h = np.ones(cloud.cells)
    r = np.nonzero(cloud.level == 0)[0]
    lo[r, 0] = r % cloud.nx
    lo[r, 1] = (r // cloud.nx) % cloud.ny
    lo[r, 2] = r // (cloud.nx * cloud.ny)
    sid = np.arange(8)
    bits = np.stack([sid % 2, (sid // 2) % 2, sid // 4], -1)
    for lvl in range(cloud.levels - 1):
        par = np.nonzero((cloud.level == lvl) & (cloud.child >= 0))[0]
        kids = cloud.child[par][:, None] + sid[None, :]
        hc = 0.5 * h[par]
        h[kids] = hc[:, None]
        lo[kids] = lo[par][:, None, :] + hc[:, None, None] * bits[None]
    return lo, h


def march(tree, kabs, ksca, csc, pos, dirs, w, f, e_cell, tally, xab, gen,
          wdtype=torch.float64):
    """transport.propagate with the emitting cell e_cell of each packet:
    its deposits there go to xab, the rest to tally (both [CELLS * NF],
    at cell * NF + channel)."""
    nf, bins = csc.shape
    dev = pos.device
    w = w.to(wdtype)
    kabs_w = kabs.to(wdtype)
    tau = -torch.log(torch.rand(len(w), generator=gen, device=dev,
                                dtype=torch.float64))
    nscat = torch.zeros(len(w), dtype=torch.int64, device=dev)
    while len(w):
        g, lo, h = locate(tree, pos)
        dens = tree["dens"][g]
        ds = exit_distance(pos, dirs, lo, h)
        ks = dens * ksca[f]
        dts = ds * ks
        scat = tau < dts
        s = torch.where(scat, tau / torch.clamp_min(ks, 1e-300), ds)
        ta = (s * dens).to(wdtype) * kabs_w[f]
        dep = (w * -torch.expm1(-ta)).to(tally.dtype)
        own = g == e_cell
        idx = g * nf + f
        tally.index_add_(0, idx, torch.where(own, 0.0, dep))
        xab.index_add_(0, idx, torch.where(own, dep, 0.0))
        w = w * torch.exp(-ta)
        pos = pos + torch.where(scat, s, ds + NUDGE)[:, None] * dirs
        u = torch.rand((len(w), 3), generator=gen, device=dev,
                       dtype=torch.float64)
        ib = torch.clamp((u[:, 0] * bins).to(torch.int64), 0, bins - 1)
        turned = deflect(dirs, csc[f, ib], 2.0 * math.pi * u[:, 1])
        dirs = torch.where(scat[:, None], turned, dirs)
        tau = torch.where(scat, -torch.log(u[:, 2]), tau - dts)
        nscat = nscat + scat.to(torch.int64)
        keep = inside(tree, pos) & (nscat <= MAX_SCATTERINGS) \
            & (w.abs() >= PHOTON_LIMIT)
        if not bool(keep.all()):
            pos, dirs, w, f, tau, nscat, e_cell = (x[keep] for x in (
                pos, dirs, w, f, tau, nscat, e_cell))


def cell_tally(tree, cloud, optics, emit, packets_per_cell, seed, device,
               block=1 << 22, wdtype=torch.float64, tdtype=torch.float64):
    """(absorbed, xab), each [CELLS, NF] photons, of the cells' emission
    ``emit`` [CELLS, NF] with packets_per_cell packets a cell and
    channel; ``wdtype`` and ``tdtype`` the precision of the weights and
    of the tallies (the control's)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    emit = np.asarray(emit, np.float64)
    cells, nf = emit.shape
    lo, h = cell_boxes(cloud)
    lo = torch.as_tensor(lo, device=dev)
    h = torch.as_tensor(h, device=dev)
    kabs = torch.as_tensor(optics.abs_gl, device=dev)
    ksca = torch.as_tensor(optics.sca_gl, device=dev)
    csc = torch.as_tensor(optics.csc, device=dev)
    # the (cell, channel) pairs that emit, each packets_per_cell times
    pairs = torch.as_tensor(np.flatnonzero(emit != 0.0), device=dev)
    pairs = pairs.repeat_interleave(int(packets_per_cell))
    wflat = torch.as_tensor(emit.reshape(-1) / packets_per_cell,
                            device=dev)
    tally = torch.zeros(cells * nf, dtype=tdtype, device=dev)
    xab = torch.zeros_like(tally)
    for i0 in range(0, len(pairs), block):
        p = pairs[i0:i0 + block]
        c, f = p // nf, p % nf
        u = torch.rand((len(p), 5), generator=gen, device=dev,
                       dtype=torch.float64)
        pos = lo[c] + u[:, :3] * h[c][:, None]
        ct = 2.0 * u[:, 3] - 1.0
        st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
        phi = 2.0 * math.pi * u[:, 4]
        dirs = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct],
                           1)
        # a refined cell's packet deposits only in the leaves under it:
        # none of its deposits is its emitter's own
        e_cell = torch.where(tree["dens"][c] > 0, c, torch.full_like(c, -1))
        march(tree, kabs, ksca, csc, pos, dirs, wflat[p], f, e_cell, tally,
              xab, gen, wdtype)
    return (tally.reshape(cells, nf).to(torch.float64).cpu().numpy(),
            xab.reshape(cells, nf).to(torch.float64).cpu().numpy())
