"""Monte-Carlo transport of the reference: photon packets through the
hierarchy in plain PyTorch, with the semantics of SOC's kernel_ASOC.c as
the benchmark states them, independent of the program's code.

A packet starts on the model's surface (background: a surface element
chosen in proportion to its area, a uniform point on it, a cosine-law
direction into the model). It carries photons of one channel.
Its free path to the next scattering is an exponential draw in scattering
optical depth. Stepping from cell boundary to cell boundary it deposits
photons * (1 - exp(-tau_abs)) in each cell it crosses and is attenuated by
exp(-tau_abs); at a scattering it turns by the channel's tabulated phase
function (the inverse CDF of cos(theta) in the scattering file) about a
uniform azimuth. It ends when it leaves the model, at its 21st
scattering, or below 1e-30 photons. Positions and directions are float64;
the random numbers are torch's own generator, seeded by the caller.
"""

import math

import torch

MAX_SCATTERINGS = 20
PHOTON_LIMIT = 1.0e-30
NUDGE = 1.0e-9          # root cells past a face when crossing it


def locate(tree, pos):
    """(global cell, box corner [N, 3], box size [N]) of the leaf holding
    each position (inside the model)."""
    nx, ny, nz = tree["dims"]
    ip = torch.floor(pos)
    ip = torch.minimum(torch.clamp_min(ip, 0.0), tree["n"] - 1.0)
    ii = ip.to(torch.int64)
    g = ii[:, 0] + nx * (ii[:, 1] + ny * ii[:, 2])
    lo = ip
    h = torch.ones_like(pos[:, 0])
    for _ in range(1, tree["levels"]):
        first = tree["child"][g]
        sub = first >= 0
        hc = 0.5 * h
        bits = torch.clamp(torch.floor((pos - lo) / hc[:, None]), 0.0, 1.0)
        sid = (bits[:, 0] + 2.0 * bits[:, 1] + 4.0 * bits[:, 2]).to(
            torch.int64)
        g = torch.where(sub, first + sid, g)
        lo = torch.where(sub[:, None], lo + bits * hc[:, None], lo)
        h = torch.where(sub, hc, h)
    return g, lo, h


def exit_distance(pos, dirs, lo, h):
    """Distance along dirs to the boundary of the box [lo, lo + h]."""
    hi = lo + h[:, None]
    inf = torch.full_like(pos, math.inf)
    t = torch.where(dirs > 0, (hi - pos) / dirs,
                    torch.where(dirs < 0, (lo - pos) / dirs, inf))
    return torch.clamp_min(t.amin(1), 0.0)


def deflect(dirs, cos_t, phi):
    """Turn unit vectors by theta (cos_t) about a uniform azimuth phi."""
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    helper = torch.zeros_like(dirs)
    use_x = dirs[:, 0].abs() < 0.9
    helper[:, 0] = use_x.to(dirs.dtype)
    helper[:, 1] = (~use_x).to(dirs.dtype)
    t1 = torch.linalg.cross(dirs, helper)
    t1 = t1 / torch.linalg.vector_norm(t1, dim=1, keepdim=True)
    t2 = torch.linalg.cross(dirs, t1)
    new = (cos_t[:, None] * dirs + (sin_t * torch.cos(phi))[:, None] * t1
           + (sin_t * torch.sin(phi))[:, None] * t2)
    return new / torch.linalg.vector_norm(new, dim=1, keepdim=True)


def inside(tree, pos):
    return ((pos >= 0.0) & (pos < tree["n"])).all(1)


def propagate(tree, kabs, ksca, csc, pos, dirs, w, f, tally, gen,
              wdtype=torch.float64):
    """Trace packets (pos, dirs, photons w, channel f) to their end,
    adding each deposit into tally [CELLS * NF] at cell * NF + channel.
    ``wdtype`` is the precision of the
    photon weights and their arithmetic (the control's lower one)."""
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
        tally.index_add_(0, g * nf + f, dep)
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
            pos, dirs, w, f, tau, nscat = (x[keep] for x in (
                pos, dirs, w, f, tau, nscat))


def surface_births(tree, n, gen, dev):
    """n background packets: (pos, dirs) on the model's surface."""
    nx, ny, nz = tree["dims"]
    areas = torch.tensor([ny * nz, ny * nz, nx * nz, nx * nz, nx * ny,
                          nx * ny], dtype=torch.float64, device=dev)
    face = torch.multinomial(areas / areas.sum(), n, replacement=True,
                             generator=gen)
    axis = face // 2
    upper = (face % 2) == 1
    u = torch.rand((n, 4), generator=gen, device=dev, dtype=torch.float64)
    size = tree["n"]
    pos = u[:, :3] * size[None, :]          # the tangential coordinates
    normal = torch.where(upper, size[axis] - NUDGE,
                         torch.full_like(u[:, 0], NUDGE))
    pos[torch.arange(n, device=dev), axis] = normal
    cos_t = torch.sqrt(u[:, 3])             # cosine law about the normal
    v = torch.rand((n, 1), generator=gen, device=dev, dtype=torch.float64)
    phi = 2.0 * math.pi * v[:, 0]
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    t1, t2 = sin_t * torch.cos(phi), sin_t * torch.sin(phi)
    dirs = torch.empty((n, 3), dtype=torch.float64, device=dev)
    inward = torch.where(upper, -cos_t, cos_t)
    for ax in range(3):
        other = [a for a in range(3) if a != ax]
        m = axis == ax
        dirs[m, ax] = inward[m]
        dirs[m, other[0]] = t1[m]
        dirs[m, other[1]] = t2[m]
    return pos, dirs


def background_tally(tree, optics, injected, packets_per_freq, seed, device,
                     block=1 << 22, wdtype=torch.float64,
                     tdtype=torch.float64):
    """[CELLS, NF] photons absorbed a cell from the isotropic background,
    packets_per_freq packets a channel, each carrying injected[f] /
    packets_per_freq photons. ``wdtype`` and ``tdtype``: the precision of
    the weights and of the tally (the control's)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    nf = len(optics.freq)
    cells = int(tree["dens"].shape[0])
    kabs = torch.as_tensor(optics.abs_gl, device=dev)
    ksca = torch.as_tensor(optics.sca_gl, device=dev)
    csc = torch.as_tensor(optics.csc, device=dev)
    w_f = torch.as_tensor(injected / packets_per_freq, device=dev)
    tally = torch.zeros(cells * nf, dtype=tdtype, device=dev)
    total = nf * packets_per_freq
    for i0 in range(0, total, block):
        i1 = min(total, i0 + block)
        f = torch.arange(i0, i1, device=dev) % nf
        pos, dirs = surface_births(tree, i1 - i0, gen, dev)
        propagate(tree, kabs, ksca, csc, pos, dirs, w_f[f], f, tally, gen,
                  wdtype)
    return tally.reshape(cells, nf).to(torch.float64).cpu().numpy()
