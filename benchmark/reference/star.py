"""An external point source, the reference's: packets leave the star
isotropically; a packet whose ray misses the model escapes at once, one
whose ray meets it starts where the ray enters the box, NUDGE inside,
and is traced by transport.propagate. Each packet of channel f carries
L_nu / (h nu (GL PARSEC)^2) / packets photons (SOC's point-source weight,
FACTOR-free like the background's), L_nu the star's file."""

import math

import numpy as np
import torch

from ..frozen.constants import PARSEC, PLANCK
from .transport import NUDGE, propagate


def photons(workdir, ini, freq, gl_pc):
    """[NF] photons the star emits a channel (the `pointsource` line's
    file and scale)."""
    line = ini["pointsource"]
    scale = float(line[4]) if len(line) > 4 else 1.0
    lnu = np.fromfile("%s/%s" % (workdir, line[3]), np.float32,
                      len(freq)).astype(np.float64) * scale
    return lnu / (PLANCK * np.asarray(freq) * (gl_pc * PARSEC) ** 2)


def position(ini):
    return np.asarray([float(v) for v in ini["pointsource"][:3]])


def isotropic(n, gen, dev):
    u = torch.rand((n, 2), generator=gen, device=dev, dtype=torch.float64)
    ct = 2.0 * u[:, 0] - 1.0
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    phi = 2.0 * math.pi * u[:, 1]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], 1)


def entry(tree, star, dirs):
    """(pos [N, 3], hit [N]) of rays from ``star`` along dirs: the point
    NUDGE inside the box where each ray enters it (the slab method)."""
    s = torch.as_tensor(star, dtype=torch.float64, device=dirs.device)
    size = tree["n"]
    safe = torch.where(dirs == 0, torch.full_like(dirs, 1e-300), dirs)
    t0 = (0.0 - s) / safe
    t1 = (size - s) / safe
    near = torch.minimum(t0, t1).amax(1)
    far = torch.maximum(t0, t1).amin(1)
    hit = (far > near) & (far > 0)
    near = torch.clamp_min(near, 0.0)
    pos = s[None, :] + (near + NUDGE)[:, None] * dirs
    return pos, hit & ((pos >= 0.0) & (pos < size)).all(1)


def visible_fraction(tree, star, n=1 << 22, seed=1):
    """The share of the star's isotropic rays that meet the model (a
    Monte Carlo of n rays)."""
    dev = tree["n"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return float(entry(tree, star, isotropic(n, gen, dev))[1].double()
                 .mean())


def star_tally(tree, optics, star, emitted, packets_per_freq, seed, device,
               block=1 << 22, wdtype=torch.float64, tdtype=torch.float64):
    """[CELLS, NF] photons absorbed a cell from the star at ``star`` (root
    cells) emitting ``emitted`` [NF] photons a channel, packets_per_freq
    isotropic packets a channel; ``wdtype`` and ``tdtype`` the precision
    of the weights and of the tally (the control's)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    nf = len(optics.freq)
    cells = int(tree["dens"].shape[0])
    kabs = torch.as_tensor(optics.abs_gl, device=dev)
    ksca = torch.as_tensor(optics.sca_gl, device=dev)
    csc = torch.as_tensor(optics.csc, device=dev)
    w_f = torch.as_tensor(np.asarray(emitted) / packets_per_freq,
                          device=dev)
    tally = torch.zeros(cells * nf, dtype=tdtype, device=dev)
    total = nf * packets_per_freq
    for i0 in range(0, total, block):
        i1 = min(total, i0 + block)
        f = torch.arange(i0, i1, device=dev) % nf
        dirs = isotropic(i1 - i0, gen, dev)
        pos, hit = entry(tree, star, dirs)
        f = f[hit]
        propagate(tree, kabs, ksca, csc, pos[hit], dirs[hit], w_f[f], f,
                  tally, gen, wdtype)
    return tally.reshape(cells, nf).to(torch.float64).cpu().numpy()
