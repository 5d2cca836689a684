"""Octree traversal over lanes: the geometric core of transport and maps.

Port of soc_tpu.ops.traverse. Every function is vectorised over a lane axis
(N packets or rays at once); the loops over hierarchy levels are unrolled
Python loops with masks, so a lane's path depends only on its own state.
Cell coordinates: a cell is (level, ind) with ``ind`` local to the level;
positions are level-local (root: [0,NX]x[0,NY]x[0,NZ]; deeper levels:
octet coordinates in [0,2]^3).

Integer lane fields (level, ind, ancestor stack) are int64 here so they can
index tensors directly. Every gather clamps its index into range first, as
JAX's gathers do implicitly. ``jnp.mod`` is a floored modulo: it is
``torch.remainder`` here, never ``torch.fmod``. The ulp-scaled epsilons stay
float32 arithmetic so boundary decisions match soc_tpu.
"""

import torch

from soc_tpu.constants import PEPS

from ..grid import decode_link

INVALID = -1
_EPS_SCALE = 2.0 ** -21


def _decode_link(dens_val):
    """Negated bit-cast float32 link -> int64 first-child (level-local)."""
    return decode_link(dens_val).to(torch.int64)


def _suboct(pos):
    """Octet sub-cell id 0..7 from octet coordinates in [0,2]^3."""
    i = torch.floor(pos).to(torch.int64).clamp(0, 1)
    return 4 * i[..., 2] + 2 * i[..., 1] + i[..., 0]


def _root_index(pos, nx, ny, nz):
    i = torch.floor(pos).to(torch.int64)
    return i[..., 2] * (nx * ny) + i[..., 1] * nx + i[..., 0]


def _outside_root(pos, nx, ny, nz):
    return ((pos[..., 0] <= 0.0) | (pos[..., 0] >= nx)
            | (pos[..., 1] <= 0.0) | (pos[..., 1] >= ny)
            | (pos[..., 2] <= 0.0) | (pos[..., 2] >= nz))


def _gidx(grid, level, ind):
    """Clamped global cell index of (level, ind)."""
    off = grid.off.to(torch.int64)[level.clamp(0, grid.levels - 1)]
    return (off + ind).clamp(0, grid.cells - 1)


def _anc_read(anc, level):
    """anc[lane, level] via a one-hot contraction (levels is tiny)."""
    k = anc.shape[-1]
    ar = torch.arange(k, device=anc.device)
    onehot = ar[None, :] == level[..., None]
    return torch.where(onehot, anc, 0).sum(-1)


def _anc_write(anc, level, value, mask):
    k = anc.shape[-1]
    ar = torch.arange(k, device=anc.device)
    sel = (ar[None, :] == level[..., None]) & mask[..., None]
    return torch.where(sel, value[..., None], anc)


def _descend_stack(grid, pos, level, ind, anc, active):
    """Walk from a (possibly refined) cell to its leaf, recording the path:
    returns (pos, level, ind, anc). Unrolled (levels-1) times."""
    for _ in range(grid.levels - 1):
        dval = grid.dens[_gidx(grid, level, ind)]
        go = active & (ind >= 0) & (dval <= 0.0)
        child = _decode_link(dval)
        new_pos = 2.0 * torch.remainder(pos, 1.0)
        new_ind = child + _suboct(new_pos)
        anc = _anc_write(anc, level, ind, go)
        pos = torch.where(go[..., None], new_pos, pos)
        ind = torch.where(go, new_ind, ind)
        level = torch.where(go, level + 1, level)
    return pos, level, ind, anc


def index_global_stack(grid, pos):
    """Global root-grid position -> (pos_local, level, ind, anc): the leaf
    holding each position and its ancestor stack. IndexG analog."""
    outside = _outside_root(pos, grid.nx, grid.ny, grid.nz)
    ind = torch.where(outside, INVALID,
                      _root_index(pos, grid.nx, grid.ny, grid.nz))
    level = torch.zeros_like(ind)
    anc = torch.zeros(pos.shape[:-1] + (max(grid.levels - 1, 1),),
                      dtype=torch.int64, device=pos.device)
    return _descend_stack(grid, pos, level, ind, anc, ~outside)


def index_update_stack(grid, pos, level, ind, anc, active, descend=True):
    """Neighbour lookup after a boundary step, with the up-walk driven by
    the ancestor stack (no PAR reads). (level, ind) is the cell the ray was
    in; pos has just crossed its boundary, in that level's coordinates.
    Returns (pos, level, ind, anc) with ind == -1 for rays that left.

    descend=False leaves lanes on a refined (link) cell; the caller then
    descends one level per step itself (see transport.propagate)."""
    if grid.levels == 1:
        outside = _outside_root(pos, grid.nx, grid.ny, grid.nz)
        new_ind = torch.where(outside, INVALID,
                              _root_index(pos, grid.nx, grid.ny, grid.nz))
        return pos, level, torch.where(active, new_ind, ind), anc

    at_root = active & (level == 0)
    outside0 = _outside_root(pos, grid.nx, grid.ny, grid.nz)
    root_ind = _root_index(pos, grid.nx, grid.ny, grid.nz)
    ind = torch.where(at_root, torch.where(outside0, INVALID, root_ind), ind)

    dims = torch.tensor([grid.nx, grid.ny, grid.nz], dtype=pos.dtype,
                        device=pos.device)
    up = active & (level > 0)
    for _ in range(grid.levels - 1):
        plevel = level - 1
        parent = _anc_read(anc, plevel.clamp_min(0))
        rootcase = plevel == 0
        sid = torch.remainder(parent, 8)
        px = torch.where(rootcase, torch.remainder(parent, grid.nx),
                         torch.remainder(sid, 2))
        py = torch.where(rootcase,
                         torch.remainder(parent // grid.nx, grid.ny),
                         torch.remainder(sid // 2, 2))
        pz = torch.where(rootcase, parent // (grid.nx * grid.ny), sid // 4)
        coords = torch.stack([px, py, pz], -1).to(pos.dtype)
        npos = 0.5 * pos + coords
        hi = torch.where(rootcase[..., None], dims[None, :],
                         torch.full_like(dims, 2.0)[None, :])
        # the root test is exclusive (outside at == 0 / == n), the octet
        # test inclusive: bit-exact with the two original tests
        ge = torch.where(rootcase[..., None], npos > 0.0, npos >= 0.0)
        le = torch.where(rootcase[..., None], npos < hi, npos <= hi)
        inside = torch.all(ge & le, dim=-1)
        nind = torch.where(
            rootcase,
            torch.where(inside, _root_index(npos, grid.nx, grid.ny, grid.nz),
                        INVALID),
            torch.where(inside, parent - sid + _suboct(npos), parent))
        pos = torch.where(up[..., None], npos, pos)
        ind = torch.where(up, nind, ind)
        level = torch.where(up, plevel, level)
        nowdone = up & (rootcase | inside)
        up = up & ~nowdone & (level > 0)

    if descend:
        pos, level, ind, anc = _descend_stack(grid, pos, level, ind, anc,
                                              active & (ind >= 0))
    return pos, level, ind, anc


def descend_one(grid, pos, level, ind, anc, dval, is_link):
    """One deferred-descent level for lanes sitting on a link cell (their
    gathered density ``dval`` <= 0)."""
    child = _decode_link(dval)
    dpos = 2.0 * torch.remainder(pos, 1.0)
    dind = child + _suboct(dpos)
    anc = _anc_write(anc, level, ind, is_link)
    pos = torch.where(is_link[..., None], dpos, pos)
    ind = torch.where(is_link, dind, ind)
    level = torch.where(is_link, level + 1, level)
    return pos, level, ind, anc


def boundary_step(pos, dir):
    """Distance (level-local units) to the next cell boundary with the
    PEPS over-step; returns (ds_local, new_pos). The over-step is
    max(PEPS, |coordinate| * 2^-21), in float32 as in soc_tpu."""
    frac = torch.remainder(pos, 1.0)
    eps = torch.clamp_min(torch.abs(pos) * _EPS_SCALE, PEPS)
    step_pos = (1.0 + eps - frac) / dir
    step_neg = (-eps - frac) / dir
    per_axis = torch.where(dir > 0.0, step_pos, step_neg)
    ds = torch.amin(per_axis, dim=-1)
    return ds, pos + ds[..., None] * dir


def failed_step_nudge(npos, dir, failed):
    """Push failed boundary crossings (same cell after the step) forward by
    a distance guaranteed to change the float32 position."""
    s = torch.clamp_min(torch.amax(torch.abs(npos), dim=-1) * _EPS_SCALE,
                        PEPS)
    return torch.where(failed[..., None], npos + s[..., None] * dir, npos)


def get_step_stack(grid, pos, dir, level, ind, anc, active):
    """Advance to the next cell: (ds_gl, pos, level, ind, anc), ds in
    root-grid units."""
    ds_local, new_pos = boundary_step(pos, dir)
    ds_gl = ds_local * torch.exp2(-level.to(ds_local.dtype))
    pos = torch.where(active[..., None], new_pos, pos)
    pos, level, ind, anc = index_update_stack(grid, pos, level, ind, anc,
                                              active)
    return ds_gl, pos, level, ind, anc


def root_pos(grid, pos, level, ind):
    """Level-local positions -> root-grid coordinates (RootPos)."""
    if grid.levels == 1:
        return pos
    par = grid.par.to(torch.int64)
    for _ in range(grid.levels - 1):
        up = level > 0
        parent = par[_gidx(grid, level, ind)]
        plevel = level - 1
        # parent at root: sub-octet [0,2] -> [0,1] + root cell offset
        posA = 0.5 * pos + torch.stack(
            [torch.remainder(parent, grid.nx),
             torch.remainder(parent // grid.nx, grid.ny),
             parent // (grid.nx * grid.ny)], -1).to(pos.dtype)
        # parent inside an octet
        sid = torch.remainder(parent, 8)
        posB = 0.5 * pos + torch.stack(
            [torch.remainder(sid, 2), torch.remainder(sid // 2, 2),
             sid // 4], -1).to(pos.dtype)
        rootcase = up & (plevel == 0)
        octcase = up & (plevel > 0)
        pos = torch.where(rootcase[..., None], posA,
                          torch.where(octcase[..., None], posB, pos))
        ind = torch.where(up, parent, ind)
        level = torch.where(up, plevel, level)
    return pos
