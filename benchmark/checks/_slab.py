"""What the slab's checks share: the cells' groups (level, depth layer
under the lit face, child slot, ring about the star's axis, column of
the face), the deposits' energies, the reference's passes (computed once
a run and kept in ctx) and the gaps of grouped sums. The lit face is the
top (+z) face; a cell's depth is its centre's distance under it, in root
cells, and a layer the leaves of one depth. A ring holds the leaves of
one layer whose centres lie within one root cell's width of a distance
from the star's axis (the vertical through the star); a column the
leaves, at every depth, under one square of COLUMN x COLUMN root cells
of the face."""

import numpy as np

from ..reference import star as rstar
from ..reference.cells import cell_boxes, cell_tally
from ..reference.temperature import trapezoid_weights
from .common import model, stream_seed

COLUMN = 4              # root cells a side of a column (1 pc in the cell)


def geometry(ctx):
    """dict(level, depth, layer, slot, leaf, lo, h, ring, column) of every
    cell (ring and column -1 outside the leaves); cached."""
    if "slab" not in ctx:
        cloud = model(ctx)[0]
        lo, h = cell_boxes(cloud)
        depth = cloud.nz - (lo[:, 2] + 0.5 * h)
        leaf = cloud.dens > 0
        _, layer = np.unique(np.round(depth, 9), return_inverse=True)
        # a cell's slot among its parent's 8 children (root cells: -1)
        slot = np.full(cloud.cells, -1, np.int64)
        first = cloud.child[cloud.child >= 0]
        for k in range(8):
            slot[first + k] = k
        # the leaves' rings about the star's axis, one root cell wide, in
        # each layer, and their columns of the face
        cx, cy = (lo[:, k] + 0.5 * h for k in (0, 1))
        sx, sy = rstar.position(ctx["ini"])[:2]
        r = np.floor(np.hypot(cx - sx, cy - sy)).astype(np.int64)
        ring = np.where(leaf, layer * (int(r.max()) + 1) + r, -1)
        ncx = -(-cloud.nx // COLUMN)
        col = (cx // COLUMN).astype(np.int64) \
            + ncx * (cy // COLUMN).astype(np.int64)
        column = np.where(leaf, col, -1)
        ctx["slab"] = dict(level=cloud.level, depth=depth, layer=layer,
                           slot=slot, leaf=leaf, lo=lo, h=h, ring=ring,
                           column=column)
    return ctx["slab"]


def energy(ctx, per_channel):
    """[CELLS] deposits' energy (photons times the trapezoid weights
    nu dnu / 2 of the channels, the program's TABS) of [CELLS, NF]."""
    tw = trapezoid_weights(model(ctx)[1].freq)
    return np.asarray(per_channel, np.float64) @ tw


def subtree(ctx, values):
    """[CELLS] each cell's value plus its descendants' (bottom up)."""
    cloud = model(ctx)[0]
    out = np.asarray(values, np.float64).copy()
    for lvl in range(cloud.levels - 2, -1, -1):
        par = np.nonzero((cloud.level == lvl) & (cloud.child >= 0))[0]
        kids = cloud.child[par][:, None] + np.arange(8)[None, :]
        out[par] += out[kids].sum(1)
    return out


def group_gap(key, prog, ref, norm):
    """Largest |sum of prog - sum of ref| over the groups of ``key``
    (cells with key < 0 left out), over ``norm``."""
    m = key >= 0
    n = int(key[m].max()) + 1
    gp = np.bincount(key[m], np.asarray(prog, np.float64)[m], n)
    gr = np.bincount(key[m], np.asarray(ref, np.float64)[m], n)
    return float(np.max(np.abs(gp - gr)) / norm)


def level_slot_gap(ctx, prog, ref):
    """Largest gap of the subtree sums of each child slot of each level
    below the root, over that level's reference total."""
    g = geometry(ctx)
    sp, sr = subtree(ctx, prog), subtree(ctx, ref)
    worst = 0.0
    for lvl in range(1, int(g["level"].max()) + 1):
        m = g["level"] == lvl
        tot = sr[m].sum()
        if tot > 0:
            worst = max(worst, group_gap(np.where(m, g["slot"], -1), sp, sr,
                                         tot))
    return worst


def reference_star(ctx, packets=None, **kw):
    """[CELLS, NF] photons absorbed from the star, ``packets`` isotropic
    packets a channel (the cell file's by default)."""
    cloud, optics, tree = model(ctx)
    ini = ctx["ini"]
    gl = float(ini["gridlength"])
    n = int(packets or ctx["cfile"]["reference_ps_packets_per_freq"])
    return rstar.star_tally(tree, optics, rstar.position(ini),
                            rstar.photons(ctx["workdir"], ini, optics.freq,
                                          gl),
                            n, stream_seed(ctx, 11), ctx["device"], **kw)


def reference_cells(ctx, emit, packets=None, **kw):
    """(absorbed, xab) [CELLS, NF] of the cells' emission ``emit``,
    ``packets`` a cell and channel (the cell file's by default)."""
    cloud, optics, tree = model(ctx)
    n = int(packets or ctx["cfile"]["reference_cell_packets"])
    return cell_tally(tree, cloud, optics, emit, n, stream_seed(ctx, 12),
                      ctx["device"], **kw)


def host(x):
    """A program's array (a tensor on any device, or an array) as a
    float64 host array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def cell_pass(ctx):
    """The program's first cell pass: dict(emit, tabs, xab) as float64
    host arrays (the emission it was fed, its absorbed and its self
    absorbed energy a cell)."""
    p = ctx["products"]["cell"][0]
    return {k: host(v) for k, v in p.items()}
