"""Packet source generation (port of soc_tpu.transport.sources): the
isotropic background, the Healpix sky, point sources, cells' own
emission (the dust's, and the diffuse field's) and the ROI boundary
source.

A generator maps local packet ids (0..total-1 within one transport run) to
initial packet states. Every packet owns the RNG stream ``(hi, k)``: ``k``
is its index within its frequency channel and ``hi = hi_base + ifreq``
encodes (phase, iteration, frequency), so streams are unique across phases
and frequencies and independent of lane chunking. A mixed-frequency run
over a selection of channels (``sel``) gives the packets of soc_tpu's
per-channel pools the same identities, so it traces the same packets in
one pool.

Background weights follow the reference (SimRAM_PB SOURCE==1): packets are
stratified over the 2(NX NY + NX NZ + NY NZ) boundary elements (element =
k % AREA), enter with cosine-law directions, and carry
photons = I_bg(f) * pi / (PLANCK * f * packets_per_element). Point sources
(SOURCE==0): isotropic from PSPOS, or aimed at the cloud when outside it
(PS_METHOD 1-5). Healpix sky (SimRAM_HP): a pixel's parallel beam enters
through a face chosen by its projected area. Cell emission (SimRAM_CL): a
uniform position inside the emitting cell, an isotropic direction,
photons = EMIT[cell] / packets_per_cell.

RNG counter layout per packet: counters 0 and 1 are burned by the source,
counter 2 word 0 is the birth free path, propagation consumes 3, 4, ...
The host tables of the point-source methods (``analyse_external_point_
sources``, ``illumination_cones``, ``healpix_visibility``) are NumPy,
copies of soc_tpu's.
"""

import math

import numpy as np
import torch

from ..constants import DEPS, PEPS

from ..ops import traverse
from .. import rng as socrng
from ..render import healpix as hp
from .propagate import PacketBatch, _deflect

BIRTH_COUNTER = 3   # first counter slot used by the propagation loop

# stream-id high-word phase tags: hi = (phase << 24) | (iteration << 16)
# + ifreq (the same table as soc_tpu, so streams coincide)
PHASES = {"bg": 1, "hpbg": 2, "ps": 3, "cell": 4, "roi": 5, "diffuse": 6,
          "split": 7, "sca_bg": 9, "sca_ps": 10, "sca_cell": 11,
          "sca_hpbg": 12}


def stream_hi_base(phase, iteration=0):
    """Host-side hi_base for a simulation phase."""
    return int(np.uint32((PHASES[phase] << 24) | ((iteration & 0xFF) << 16)))


def packet_identity(ids_local, params):
    """Map local packet ids (int64 tensor) to (k, ifreq, hi).

    params: 'hi_base' the phase/iteration tag (hi = hi_base + ifreq) and
    'k0' (default 0) the within-frequency index of local id 0; then
    either 'ifreq', one channel for the whole run (k = k0 + id), or a
    mixed-frequency run whose ids count through the channels in turn:
    'per_freq' packets a channel, or 'starts' [NSEL + 1] (int64 tensor)
    the first id of each channel when their budgets differ. With 'sel'
    (int64 tensor [NSEL]) the run covers only those channels, the j-th
    block of ids being channel sel[j]. With k0 a pool runs the slice
    [k0, k0 + per_freq) of every channel's budget, as the dp shards of
    product.run_freqs do; under 'starts' k0 may be an int64 tensor
    [NSEL], each channel's own first index (budgets split unevenly). k
    and hi are 32-bit words held in int64 and masked, as in
    soc_tpu_torch.rng; ids are int64, so a run of any size needs no
    chunking to keep them in 32 bits.
    """
    k0 = params.get("k0", 0)
    if params.get("ifreq") is not None:
        k = (ids_local + int(k0)) & socrng.MASK32
        ifreq = torch.full_like(ids_local, int(params["ifreq"]))
    else:
        if "starts" in params:
            starts = params["starts"]
            j = (torch.searchsorted(starts, ids_local, right=True) - 1
                 ).clamp(0, starts.shape[0] - 2)
            if torch.is_tensor(k0):
                k0 = k0[j]
            k = (ids_local - starts[j] + k0) & socrng.MASK32
        else:
            pf = int(params["per_freq"])
            j = ids_local // pf
            k = (ids_local - j * pf + int(k0)) & socrng.MASK32
        sel = params.get("sel")
        ifreq = j if sel is None else sel[j.clamp(0, sel.shape[0] - 1)]
    hi = (ifreq + int(params["hi_base"])) & socrng.MASK32
    return k, ifreq, hi


def pool_params(params, sel, counts, hi_base, device, k0=None, maps=None):
    """The transport parameters of one mixed pool over the channels
    ``sel``: counts[j] packets of channel sel[j], from within-channel index
    k0[j] (0 by default), added to the source's ``params``. 'per_freq'
    (and a scalar 'k0') when every channel has the same count and start
    and no map, else 'starts' (and 'k0' a channel); EMWEI's ``maps``
    (maps[j] channel sel[j]'s id -> cell map, already cut to the pool's
    slice) end to end as 'cell_of_id'. The one-device driver's source
    passes and the mesh's shards (product.run_freqs) both build their
    pools here."""
    sel = np.asarray(sel, np.int64)
    counts = np.asarray(counts, np.int64)
    k0 = np.zeros(len(sel), np.int64) if k0 is None \
        else np.asarray(k0, np.int64)
    p = dict(params, hi_base=hi_base,
             sel=torch.as_tensor(sel, device=device))
    if maps is not None:
        p["cell_of_id"] = torch.as_tensor(np.concatenate(maps),
                                          device=device)
    if maps is None and (counts == counts[0]).all() and (k0 == k0[0]).all():
        p["per_freq"] = int(counts[0])
        if k0[0]:
            p["k0"] = int(k0[0])
    else:
        p["starts"] = torch.as_tensor(
            np.concatenate([[0], np.cumsum(counts)]), device=device)
        if k0.any():
            p["k0"] = torch.as_tensor(k0, device=device)
    return p


def _unit(d):
    return d / torch.sqrt(d[:, 0:1] * d[:, 0:1] + d[:, 1:2] * d[:, 1:2]
                          + d[:, 2:3] * d[:, 2:3])


def _finish(grid, pos_global, dir, photons, ifreq, stream, hi):
    # the leaf walk records the ancestor stack as it descends, so the
    # refill step needs no PAR gathers
    pos, level, ind, anc = traverse.index_global_stack(grid, pos_global)
    return PacketBatch(
        pos=pos, dir=dir, level=level, ind=ind,
        photons=photons.to(torch.float32), ifreq=ifreq, stream=stream,
        hi=hi, counter=torch.full_like(stream, BIRTH_COUNTER),
        scatterings=torch.zeros_like(ind), e_cell=torch.full_like(ind, -1),
        anc=anc)


def gen_background(grid, ids_local, seed, params):
    """Isotropic-background packets; params: photons [NFREQ] tensor plus
    the packet_identity keys."""
    stream, ifreq, hi = packet_identity(ids_local, params)
    pos, dir = background_entry(grid.nx, grid.ny, grid.nz, stream, hi, seed)
    return _finish(grid, pos, dir, params["photons"][ifreq], ifreq,
                   stream, hi)


def background_entry(nx, ny, nz, stream, hi, seed):
    """Entry (position, direction) of isotropic-background packet
    (stream, hi) on the nx*ny*nz surface."""
    area = 2 * (ny * nz + nx * nz + nx * ny)
    return background_entry_at(nx, ny, nz, torch.remainder(stream, area),
                               stream, hi, seed)


def background_entry_at(nx, ny, nz, elem, stream, hi, seed):
    """Entry (position, direction) on a given surface element."""
    a_yz, a_xz, a_xy = ny * nz, nx * nz, nx * ny
    u1, u2, u3, u4 = socrng.uniform4(seed, stream, torch.zeros_like(stream),
                                     hi)

    # element id -> (axis, upper, tangential coords), kernel enumeration
    # order: [-X, +X, -Y, +Y, -Z, +Z] with YZ / XZ / XY tangential planes
    in_x = elem < 2 * a_yz
    in_y = ~in_x & (elem < 2 * (a_yz + a_xz))
    base = torch.where(in_x, 0, torch.where(in_y, 2 * a_yz,
                                            2 * (a_yz + a_xz)))
    block = torch.where(in_x, a_yz, torch.where(in_y, a_xz, a_xy))
    rel = elem - base
    upper = rel >= block
    r = rel - torch.where(upper, block, 0)
    nmod = torch.where(in_x, ny, nx)
    tang1 = torch.remainder(r, nmod).to(torch.float32) + u1
    tang2 = (r // nmod).to(torch.float32) + u2

    ax0 = in_x
    ax1 = in_y
    ax2 = ~in_x & ~in_y
    size_n = torch.where(ax0, nx, torch.where(ax1, ny, nz)).to(torch.float32)
    nrm = torch.where(upper, size_n - PEPS, torch.full_like(size_n, PEPS))
    px = torch.where(ax0, nrm, tang1)
    py = torch.where(ax1, nrm, torch.where(ax0, tang1, tang2))
    pz = torch.where(ax2, nrm, tang2)
    pos = torch.stack([torch.clamp(px, PEPS, nx - PEPS),
                       torch.clamp(py, PEPS, ny - PEPS),
                       torch.clamp(pz, PEPS, nz - PEPS)], -1)

    # cosine-law direction about the inward normal
    cos_theta = torch.sqrt(u3)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - u3, 0.0))
    phi = 2.0 * math.pi * u4
    v1 = sin_theta * torch.cos(phi)
    v2 = sin_theta * torch.sin(phi)
    s = torch.where(upper, -cos_theta, cos_theta)
    dx = torch.where(ax0, s, v1)
    dy = torch.where(ax1, s, torch.where(ax0, v1, v2))
    dz = torch.where(ax2, s, v2)
    dir = torch.stack([dx, dy, dz], -1)
    dir = torch.where(torch.abs(dir) < 1e-5, 1e-5, dir)
    return pos, _unit(dir)


def _uniforms(seed, stream, hi):
    """The six source uniforms of a packet: counter 0 (four words) and
    counter 1 (two), as soc_tpu draws them."""
    u1, u2, u3, u4 = socrng.uniform4(seed, stream, torch.zeros_like(stream),
                                     hi)
    u5, u6 = socrng.uniform2(seed, stream, torch.ones_like(stream), hi)
    return u1, u2, u3, u4, u5, u6


def _isotropic_dir(u1, u2):
    cos_theta = 2.0 * u1 - 1.0
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * math.pi * u2
    d = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                     cos_theta], -1)
    # the reference's DEPS clamp: an exact-zero component would divide to
    # ds = -inf in boundary_step
    d = torch.where(torch.abs(d) < DEPS, DEPS, d)
    return _unit(d)


def emitting_cell(ids_local, params, cells):
    """(cell, k, ifreq, hi) of gen_cell's packets ``ids_local``: the
    global id of the cell that emits each one (of ``cells``) and its
    packet_identity."""
    stream, ifreq, hi = packet_identity(ids_local, params)
    if "cell_of_id" in params:
        # one channel's map indexed by k, or under 'starts' the channels'
        # maps concatenated, indexed by the local id
        com = params["cell_of_id"]
        at = ids_local if "starts" in params else stream
        cell = com[at.clamp(0, com.shape[0] - 1)].to(torch.int64)
    else:
        cell = stream // int(params["per_cell"])
    return cell.clamp(0, cells - 1), stream, ifreq, hi


def gen_cell(grid, ids_local, seed, params):
    """Re-emission packets (the dust's own, or the diffuse field's);
    params: 'emit' [CELLS] (one channel) or [CELLS, NFREQ] (a mixed pool,
    gathered once at birth), the photon weight of one packet of each
    cell; either 'per_cell' (uniform packets a cell) or 'cell_of_id'
    (EMWEI: the host's map from within-channel id to cell, or under
    'starts' the channels' maps end to end); plus the packet_identity
    keys."""
    cell, stream, ifreq, hi = emitting_cell(ids_local, params, grid.cells)
    u1, u2, u3, u4, u5, _ = _uniforms(seed, stream, hi)
    # (level, level-local index) of the global cell id
    off = grid.off.to(torch.int64)
    lev = torch.zeros_like(cell)
    for lvl in range(1, grid.levels):
        lev = torch.where(cell >= off[lvl], lvl, lev)
    loc = cell - off[lev]

    # level-local birth corner: the root cell's (x, y, z), or below the
    # root the cell's corner in its octet
    rx = torch.remainder(loc, grid.nx)
    ry = torch.remainder(loc // grid.nx, grid.ny)
    rz = loc // (grid.nx * grid.ny)
    if grid.levels > 1:
        sid = torch.remainder(loc, 8)
        root = lev == 0
        rx = torch.where(root, rx, torch.remainder(sid, 2))
        ry = torch.where(root, ry, torch.remainder(sid // 2, 2))
        rz = torch.where(root, rz, sid // 4)
    pos = torch.stack([rx.to(torch.float32) + u1, ry.to(torch.float32) + u2,
                       rz.to(torch.float32) + u3], -1)
    emit = params["emit"]
    photons = emit[cell, ifreq] if emit.ndim == 2 else emit[cell]
    return PacketBatch(
        pos=pos, dir=_isotropic_dir(u4, u5), level=lev, ind=loc,
        photons=photons.to(torch.float32), ifreq=ifreq, stream=stream,
        hi=hi, counter=torch.full_like(stream, BIRTH_COUNTER),
        scatterings=torch.zeros_like(loc), e_cell=cell,
        anc=traverse.stack_from_par(grid, lev, loc))


def _surface_step(grid, pos, dir):
    """Step an outside position to the nearest model boundary along dir
    (Surface(), kernel_ASOC_aux.c:912-945); misses stay outside and die
    at birth."""
    bounds = torch.tensor([grid.nx, grid.ny, grid.nz], dtype=torch.float32,
                          device=pos.device)
    lo_hit = (dir > 0.0) & (pos < 0.0)
    hi_hit = (dir < 0.0) & (pos > bounds)
    dx = torch.where(lo_hit, (PEPS - pos) / dir,
                     torch.where(hi_hit, (bounds - PEPS - pos) / dir,
                                 -1e10))
    step = torch.amax(dx, dim=-1)
    return pos + step[:, None] * dir


def _axis_pick(axis, v0, v1, v2):
    """v0, v1 or v2 per lane by axis 0, 1 or 2."""
    return torch.where(axis == 0, v0, torch.where(axis == 1, v1, v2))


def gen_point_source(grid, ids_local, seed, params):
    """Point-source packets; params: 'ps_pos' [S, 3], 'photons' [S] (one
    channel) or [S, NFREQ] (a mixed pool), plus the packet_identity keys
    and a PS_METHOD's tables. Packets cycle the sources: src = k % S.
    External sources (outside the model volume), by PS_METHOD
    (kernel_ASOC.c:215-433):
      0: isotropic, then stepped to the cloud surface; misses die
      1 ('halfspace'): the direction folded toward the cloud across one
         axis (priority z, x, y), photons * 0.5
      2 ('xps_side', 'xps_area', 'xps_nside'): aimed at a random point
         of a random visible face; photons * cos(theta) S_side
         / (4 pi r^2) / area_weight
      3 ('ps3_pix', 'ps3_p'): a Healpix pixel drawn from the visibility
         bins, the direction jittered within it, photons * (1/NPIX)
         / p(pixel)
      4/5 ('cone_cos', 'cone_side'): directions uniform in the cone that
         covers the cloud, photons * (1 - cos_cone) / 2
    """
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    stream, ifreq, hi = packet_identity(ids_local, params)
    ps_pos = params["ps_pos"]
    isrc = torch.remainder(stream, ps_pos.shape[0])
    u1, u2, u3, u4, u5, _ = _uniforms(seed, stream, hi)
    dir = _isotropic_dir(u1, u2)
    pos = ps_pos[isrc]
    ph = params["photons"]
    photons = ph[isrc, ifreq] if ph.ndim == 2 else ph[isrc]
    bounds = torch.tensor([nx, ny, nz], dtype=torch.float32,
                          device=pos.device)
    external = ((pos < 0.0) | (pos > bounds)).any(-1)
    ext1 = external[:, None]

    if "xps_side" in params:
        xps_nside = params["xps_nside"][isrc]
        k = (u3 * xps_nside.to(torch.float32) * 0.999999).to(
            torch.int64).clamp(0, 2)
        # the face weight divides external sources only (internal ones
        # have area 0), as the reference's PS_METHOD==2 branch does
        photons = torch.where(
            external, photons / torch.clamp_min(
                params["xps_area"][isrc, k], 1e-10), photons)
        side = params["xps_side"][isrc, k]      # 0..5: +X,-X,+Y,-Y,+Z,-Z
        axis = side // 2
        plus_face = torch.remainder(side, 2) == 0
        nrm = torch.where(plus_face, bounds[axis] - PEPS,
                          torch.full_like(u4, PEPS))
        t1 = u4 * torch.where(axis == 0, ny, nx)
        t2 = u5 * torch.where(axis == 2, ny, nz)
        face_pos = torch.stack([torch.where(axis == 0, nrm, t1),
                                _axis_pick(axis, t1, nrm, t2),
                                torch.where(axis == 2, nrm, t2)], -1)
        vec = face_pos - pos
        r = torch.sqrt(vec[:, 0] * vec[:, 0] + vec[:, 1] * vec[:, 1]
                       + vec[:, 2] * vec[:, 2])
        new_dir = vec / torch.clamp_min(r, 1e-10)[:, None]
        # a component of exactly 0 (the face point level with a source on
        # a cell boundary: about one packet in 10^7 for a source on the
        # grid's axis) would step by 0 / 0 = NaN in boundary_step; it
        # takes the isotropic draws' DEPS, every other packet its own
        # direction bit for bit
        flat = new_dir == 0.0
        new_dir = torch.where(flat.any(-1, keepdim=True),
                              _unit(torch.where(flat, DEPS, new_dir)),
                              new_dir)
        cos_t = torch.abs(torch.gather(new_dir, 1, axis[:, None]))[:, 0]
        s_side = _axis_pick(axis, ny * nz, nx * nz, nx * ny).to(
            torch.float32)
        w = cos_t * s_side / (4.0 * math.pi * r * r)
        photons = torch.where(external, photons * w, photons)
        dir = torch.where(ext1, new_dir, dir)
        pos = torch.where(ext1, face_pos, pos)
    elif "cone_cos" in params:
        cone_cos = params["cone_cos"][isrc]
        side = params["cone_side"][isrc]
        ct = 1.0 - u3 * (1.0 - cone_cos)
        st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
        phi = 2.0 * math.pi * u4
        v1 = st * torch.cos(phi)
        v2 = st * torch.sin(phi)
        axis = side // 2
        sgn = torch.where(torch.remainder(side, 2) == 0, -1.0, 1.0)
        cdir = torch.stack([torch.where(axis == 0, sgn * ct, v1),
                            _axis_pick(axis, v1, sgn * ct, v2),
                            torch.where(axis == 2, sgn * ct, v2)], -1)
        cdir = torch.where(torch.abs(cdir) < 1e-5, 1e-5, cdir)
        dir = torch.where(ext1, _unit(cdir), dir)
        photons = torch.where(external, photons * 0.5 * (1.0 - cone_cos),
                              photons)
        pos = torch.where(ext1, _surface_step(grid, pos, dir), pos)
    elif "ps3_pix" in params:
        ps3_pix = params["ps3_pix"]             # [S, NB]
        ps3_p = params["ps3_p"]                 # [S, NPIX]
        nb = ps3_pix.shape[1]
        npix_hp = ps3_p.shape[1]
        nside_hp = int(np.sqrt(npix_hp // 12))
        bin_i = (u3 * nb).to(torch.int64).clamp(0, nb - 1)
        pix = ps3_pix[isrc, bin_i].to(torch.int64)
        photons = torch.where(
            external, photons * (1.0 / npix_hp)
            / torch.clamp_min(ps3_p[isrc, pix], 1e-20), photons)
        theta, phi = hp.pix2ang_ring(nside_hp, pix)
        pdir = torch.stack([torch.sin(theta) * torch.cos(phi),
                            torch.sin(theta) * torch.sin(phi),
                            torch.cos(theta)], -1)
        # jitter within the pixel's solid angle (~2/NPIX in cos theta)
        jig_ct = 1.0 - u4 * (2.0 / npix_hp)
        pdir = _deflect(pdir, jig_ct, 2.0 * math.pi * u5)
        dir = torch.where(ext1, pdir, dir)
        pos = torch.where(ext1, _surface_step(grid, pos, dir), pos)
    else:
        if params.get("halfspace") is not None:
            # fold toward the cloud across exactly one axis, priority z,
            # x, y: the half-space weight 0.5 is exact for one fold only
            below = pos < 0.0
            above = pos > bounds
            out_ax = below | above
            pick_z = out_ax[:, 2]
            pick_x = ~pick_z & out_ax[:, 0]
            pick_y = ~pick_z & ~pick_x & out_ax[:, 1]
            pick = torch.stack([pick_x, pick_y, pick_z], -1)
            flip = pick & ((below & (dir < 0.0)) | (above & (dir > 0.0)))
            dir = torch.where(ext1 & flip, -dir, dir)
            photons = torch.where(external, photons * 0.5, photons)
        pos = torch.where(ext1, _surface_step(grid, pos, dir), pos)
    return _finish(grid, pos, dir, photons, ifreq, stream, hi)


def analyse_external_point_sources(grid, ps_pos):
    """Host-side XPS arrays for PS_METHOD 2 (ASOC_aux.py:1538-1605)."""
    ps_pos = np.asarray(ps_pos, np.float64)
    no_ps = len(ps_pos)
    nside = np.zeros(no_ps, np.int32)
    side = np.zeros((no_ps, 3), np.int32)
    area = np.zeros((no_ps, 3), np.float32)
    bounds = [grid.nx, grid.ny, grid.nz]
    for i, p in enumerate(ps_pos):
        if np.all((p >= 0) & (p <= bounds)):
            continue
        faces = []
        for axis in range(3):
            if p[axis] > bounds[axis]:
                faces.append(2 * axis)          # + face
            if p[axis] < 0.0:
                faces.append(2 * axis + 1)      # - face
        nside[i] = len(faces)
        for k, f in enumerate(faces[:3]):
            side[i, k] = f
            area[i, k] = 1.0 / len(faces)
    return nside, side, area


def illumination_cones(grid, ps_pos):
    """Host-side PS_METHOD 4/5 cones (kernel_ASOC.c:378-433): for every
    external source, the cloud-facing face id (0..5 = +X,-X,+Y,-Y,+Z,-Z)
    and the cone cosine that covers all 8 box corners as seen from the
    source (any containing cone is unbiased since the photon weight uses
    the same cosine)."""
    ps_pos = np.asarray(ps_pos, np.float64)
    bounds = np.asarray([grid.nx, grid.ny, grid.nz], np.float64)
    no_ps = len(ps_pos)
    side = np.zeros(no_ps, np.int32)
    cone = np.zeros(no_ps, np.float32)
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                   indexing="ij"), -1).reshape(-1, 3) * bounds
    for i, p in enumerate(ps_pos):
        over = np.where(p > bounds, p - bounds, 0.0) \
            + np.where(p < 0.0, p, 0.0)
        if not np.any(over != 0.0):
            continue                        # internal source: no cone
        axis = int(np.argmax(np.abs(over)))
        side[i] = 2 * axis + (0 if over[axis] > 0 else 1)
        adir = np.zeros(3)
        adir[axis] = -np.sign(over[axis])   # toward the cloud
        vec = corners - p
        vec /= np.linalg.norm(vec, axis=1, keepdims=True)
        cone[i] = float(np.min(vec @ adir))
    return side, np.clip(cone, -1.0, 0.999999)


def healpix_visibility(grid, ps_pos, nside=16, nbins=4096):
    """Host-side PS_METHOD 3 tables: per source, a Healpix visibility map
    (does the ray from the source toward the pixel centre hit the cloud
    box?) turned into selection probabilities and equidistant cumulative
    bins (ASOC_aux.py:1640+). The pixel centres are float32, as soc_tpu
    forms them, so a grazing pixel is tested as there."""
    ps_pos = np.asarray(ps_pos, np.float64)
    bounds = np.asarray([grid.nx, grid.ny, grid.nz], np.float64)
    npix = 12 * nside * nside
    theta, phi = hp.pix2ang_ring_np(nside, np.arange(npix))
    dirs = np.stack([np.sin(theta) * np.cos(phi),
                     np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    no_ps = len(ps_pos)
    prob = np.zeros((no_ps, npix), np.float32)
    bins = np.zeros((no_ps, nbins), np.int32)
    for i, p in enumerate(ps_pos):
        # slab-method ray/AABB intersection for every pixel direction
        with np.errstate(divide="ignore"):
            t0 = (0.0 - p)[None, :] / dirs
            t1 = (bounds - p)[None, :] / dirs
        tmin = np.minimum(t0, t1).max(axis=1)
        tmax = np.maximum(t0, t1).min(axis=1)
        hit = (tmax > np.maximum(tmin, 0.0))
        w = hit.astype(np.float64) + 1e-12
        p_pix = w / w.sum()
        cdf = np.cumsum(p_pix)
        u = (np.arange(nbins) + 0.5) / nbins
        bins[i] = np.searchsorted(cdf, u).clip(0, npix - 1)
        # the actual selection probability is the realized bin histogram
        # (quantized cdf), which keeps the weight correction exact
        prob[i] = np.bincount(bins[i], minlength=npix) / float(nbins)
    return bins, prob


def gen_hpbg(grid, ids_local, seed, params):
    """Healpix all-sky background packets (SimRAM_HP,
    kernel_ASOC.c:831-1010).

    params: 'hpbg' [NPIX] (one channel) or [NFREQ, NPIX] (a mixed pool)
    photons a packet of each pixel (the host includes WBG / freq and any
    pixel weighting); optionally 'cdf', the cumulative pixel probability
    of weighted pixel selection: [NPIX] float32 for one channel, or with
    the [NFREQ, NPIX] weights a float64 [NFREQ * NPIX] table whose
    channel f holds
    2 f + cdf_f (exact in float64, so one sorted search finds each lane's
    pixel in its own channel's float32 cdf as jnp.searchsorted(side
    'left') does); plus the packet_identity keys. A pixel's parallel beam
    runs along (sin t cos p, sin t sin p, -cos t) and enters through a
    face chosen with probability ~ |DIR_F| * face area (soc_tpu's rule,
    not the reference kernel's fabs(DIR) alone, which on non-cubic grids
    concentrates packets on the small faces; on cubic grids the two
    agree).
    """
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    stream, ifreq, hi = packet_identity(ids_local, params)
    u1, u2, u3, u4 = socrng.uniform4(seed, stream, torch.zeros_like(stream),
                                     hi)
    hpbg = params["hpbg"]
    npix = hpbg.shape[-1]
    nside = int(np.sqrt(npix // 12))
    cdf = params.get("cdf")
    if cdf is None:
        pix = (u1 * npix).to(torch.int64).clamp(0, npix - 1)
    elif hpbg.ndim == 1:
        pix = torch.searchsorted(cdf, u1).clamp(0, npix - 1)
    else:
        at = torch.searchsorted(cdf, u1.double() + 2.0 * ifreq)
        pix = (at - ifreq * npix).clamp(0, npix - 1)
    photons = hpbg[ifreq, pix] if hpbg.ndim == 2 else hpbg[pix]
    theta, phi = hp.pix2ang_ring(nside, pix)
    dir = torch.stack([torch.sin(theta) * torch.cos(phi),
                       torch.sin(theta) * torch.sin(phi),
                       -torch.cos(theta)], -1)
    dir = _unit(torch.where(torch.abs(dir) < 1e-5, 1e-5, dir))

    ax = torch.abs(dir[:, 0]) * (ny * nz)
    ay = torch.abs(dir[:, 1]) * (nx * nz)
    az = torch.abs(dir[:, 2]) * (nx * ny)
    tot = ax + ay + az
    ax, ay = ax / tot, ay / tot
    hit_x = u2 < ax
    hit_y = ~hit_x & (u2 < ax + ay)
    hit_z = ~hit_x & ~hit_y
    px = torch.where(hit_x, torch.where(dir[:, 0] > 0, PEPS, nx - PEPS),
                     u3 * nx)
    py = torch.where(hit_y, torch.where(dir[:, 1] > 0, PEPS, ny - PEPS),
                     torch.where(hit_x, u3 * ny, u4 * ny))
    pz = torch.where(hit_z, torch.where(dir[:, 2] > 0, PEPS, nz - PEPS),
                     u4 * nz)
    pos = torch.stack([torch.clamp(px, PEPS, nx - PEPS),
                       torch.clamp(py, PEPS, ny - PEPS),
                       torch.clamp(pz, PEPS, nz - PEPS)], -1)
    return _finish(grid, pos, dir, photons, ifreq, stream, hi)


def gen_roi(grid, ids_local, seed, params):
    """ROI-load boundary source (SOURCE==3, kernel_ASOC.c:469-505): the
    photons a previous run's `roisave` recorded, re-injected into this
    (sub-)model, which spans the ROI box.

    params: 'roi_load' [NELEM, NPIX] (one channel) or [NFREQ, NELEM,
    NPIX] (a mixed pool) photons per (surface element, sky direction),
    'roi_dim' (rnx, rny, rnz) of the saved discretisation, 'reps' packets
    per (element, pixel) pair (a packet carries load / reps), plus the
    packet_identity keys. The within-channel id k gives elem = k % NELEM
    and pix = (k // NELEM) % NPIX; the position is jittered over the
    element's patch, the direction by +-0.025 rad around the pixel
    centre."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    stream, ifreq, hi = packet_identity(ids_local, params)
    roi_load = params["roi_load"]
    nelem, npx = roi_load.shape[-2:]
    nside = int(np.sqrt(npx // 12))
    rnx, rny, rnz = params["roi_dim"]
    u1, u2, u3, u4, _, _ = _uniforms(seed, stream, hi)

    elem = torch.remainder(stream, nelem)
    pix = torch.remainder(stream // nelem, npx)
    load = roi_load[ifreq, elem, pix] if roi_load.ndim == 3 \
        else roi_load[elem, pix]
    photons = load / float(params["reps"])

    theta, phi = hp.pix2ang_ring(nside, pix)
    theta = theta + (u3 - 0.5) * 0.05
    phi = phi + (u4 - 0.5) * 0.05
    dir = torch.stack([torch.sin(theta) * torch.cos(phi),
                       torch.sin(theta) * torch.sin(phi),
                       torch.cos(theta)], -1)
    dir = _unit(torch.where(torch.abs(dir) < 1e-5, 1e-5, dir))

    # element -> (side, patch coordinates); patch size = model size / dims
    in_x = elem < rny * rnz
    in_y = ~in_x & (elem < rny * rnz + rnx * rnz)
    r = torch.where(in_x, elem, torch.where(in_y, elem - rny * rnz,
                                            elem - rny * rnz - rnx * rnz))
    n1 = torch.where(in_x, rny, rnx)
    t1 = torch.remainder(r, n1).to(torch.float32)
    t2 = (r // n1).to(torch.float32)
    rd1 = torch.where(in_x, ny / rny, nx / rnx)
    rd2 = torch.where(in_x | in_y, nz / rnz, ny / rny)
    c1 = (t1 + 0.5) * rd1 + (u1 - 0.5) * 0.98 * rd1
    c2 = (t2 + 0.5) * rd2 + (u2 - 0.5) * 0.98 * rd2
    # entry face fixed by the direction's sign on the normal axis
    px = torch.where(in_x, torch.where(dir[:, 0] > 0, PEPS, nx - PEPS), c1)
    py = torch.where(in_x, c1, torch.where(
        in_y, torch.where(dir[:, 1] > 0, PEPS, ny - PEPS), c2))
    pz = torch.where(in_x | in_y, c2,
                     torch.where(dir[:, 2] > 0, PEPS, nz - PEPS))
    pos = torch.stack([torch.clamp(px, PEPS, nx - PEPS),
                       torch.clamp(py, PEPS, ny - PEPS),
                       torch.clamp(pz, PEPS, nz - PEPS)], -1)
    return _finish(grid, pos, dir, photons, ifreq, stream, hi)


GENERATORS = {"bg": gen_background, "cell": gen_cell,
              "ps": gen_point_source, "hpbg": gen_hpbg, "roi": gen_roi}
