"""The sharded orthographic render of the `devices N` path (port of
soc_tpu.parallel.mesh.sharded_render_ortho)."""

import torch

from ..render.mapping import render_ortho


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
        return render_ortho(
            pm.replica(grid, dev), emit_map[:, cols].to(dev).contiguous(),
            ext_gl[cols].to(dev).contiguous(), odir, ra, de, centre, map_dx,
            (nxp, nyp), row0=dp * nrows, nrows=nrows)

    device = emit_map.device
    phot = torch.empty((nf, nyp, nxp), dtype=torch.float32, device=device)
    tau = torch.empty_like(phot)
    colden = torch.empty((nyp, nxp), dtype=torch.float32, device=device)
    for i, (p, t, c) in enumerate(pm.map_shards(shard)):
        dp, fq = divmod(i, pm.n_freq)
        rows = slice(dp * nrows, (dp + 1) * nrows)
        cols = slice(fq * nfl, (fq + 1) * nfl)
        phot[cols, rows] = p.to(device)
        tau[cols, rows] = t.to(device)
        if fq == 0:            # colden does not depend on the channel
            colden[rows] = c.to(device)
    return phot, tau, colden
