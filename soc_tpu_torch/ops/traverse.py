"""Octree traversal over lanes: the geometric core of transport and maps.

Port of soc_tpu.ops.traverse. Every function is vectorised over a lane axis
(N packets or rays at once); the loops over hierarchy levels are unrolled
Python loops with masks, so a lane's path depends only on its own state.
Cell coordinates: a cell is (level, ind) with ``ind`` local to the level;
positions are level-local (root: [0,NX]x[0,NY]x[0,NZ]; deeper levels:
octet coordinates in [0,2]^3).

Two forms of the walk: the PAR-array form (index_global, index_update,
get_step, march_path_lengths: soc_tpu's library and speed-of-light march)
and the ancestor-stack form (*_stack) that the transport and the maps
run, which carries each lane's ancestors instead of reading PAR.

Integer lane fields (level, ind, ancestor stack) are int64 here so they can
index tensors directly. Every gather clamps its index into range first, as
JAX's gathers do implicitly. ``jnp.mod`` is a floored modulo: it is
``torch.remainder`` here, never ``torch.fmod``. The ulp-scaled epsilons stay
float32 arithmetic so boundary decisions match soc_tpu.
"""

import torch

from ..constants import PEPS

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


def _descend(grid, pos, level, ind, active):
    """Walk from a (possibly refined) cell down to its leaf: a cell whose
    density value is a link takes the lane into the child octet, its
    position rescaled. Unrolled (levels-1) times."""
    for _ in range(grid.levels - 1):
        dval = grid.dens[_gidx(grid, level, ind)]
        go = active & (ind >= 0) & (dval <= 0.0)
        new_pos = 2.0 * torch.remainder(pos, 1.0)
        new_ind = _decode_link(dval) + _suboct(new_pos)
        pos = torch.where(go[..., None], new_pos, pos)
        ind = torch.where(go, new_ind, ind)
        level = torch.where(go, level + 1, level)
    return pos, level, ind


def index_global(grid, pos):
    """Global root-grid position -> (pos_local, level, ind), ind -1
    outside. IndexG analog."""
    outside = _outside_root(pos, grid.nx, grid.ny, grid.nz)
    ind = torch.where(outside, INVALID,
                      _root_index(pos, grid.nx, grid.ny, grid.nz))
    return _descend(grid, pos, torch.zeros_like(ind), ind, ~outside)


def index_update(grid, pos, level, ind, active):
    """Neighbour lookup after a boundary step, the up-walk reading the PAR
    array. Index() analog: (level, ind) is the cell the ray was in, pos
    has just crossed its boundary in that level's coordinates. Walk up
    until pos falls inside the current octet or the root grid, then down
    to the leaf. Returns (pos, level, ind) with ind -1 for rays that left.
    """
    if grid.levels == 1:
        outside = _outside_root(pos, grid.nx, grid.ny, grid.nz)
        new_ind = torch.where(outside, INVALID,
                              _root_index(pos, grid.nx, grid.ny, grid.nz))
        return pos, level, torch.where(active, new_ind, ind)

    at_root = active & (level == 0)
    outside0 = _outside_root(pos, grid.nx, grid.ny, grid.nz)
    root_ind = _root_index(pos, grid.nx, grid.ny, grid.nz)
    ind = torch.where(at_root, torch.where(outside0, INVALID, root_ind), ind)

    par = grid.par.to(torch.int64)
    up = active & (level > 0)
    for _ in range(grid.levels - 1):
        parent = par[_gidx(grid, level, ind)]
        plevel = level - 1
        # the parent at the root: the octet [0,2] -> [0,1] + its root cell
        pos_a = 0.5 * pos + torch.stack(
            [torch.remainder(parent, grid.nx),
             torch.remainder(parent // grid.nx, grid.ny),
             parent // (grid.nx * grid.ny)], -1).to(pos.dtype)
        ind_a = torch.where(_outside_root(pos_a, grid.nx, grid.ny, grid.nz),
                            INVALID,
                            _root_index(pos_a, grid.nx, grid.ny, grid.nz))
        # the parent inside an octet one level up
        sid = torch.remainder(parent, 8)
        pos_b = 0.5 * pos + torch.stack(
            [torch.remainder(sid, 2), torch.remainder(sid // 2, 2),
             sid // 4], -1).to(pos.dtype)
        inside_b = torch.all((pos_b >= 0.0) & (pos_b <= 2.0), dim=-1)
        ind_b = parent - sid + _suboct(pos_b)
        rootcase = up & (plevel == 0)
        octcase = up & (plevel > 0)
        pos = torch.where(rootcase[..., None], pos_a,
                          torch.where(octcase[..., None], pos_b, pos))
        ind = torch.where(rootcase, ind_a,
                          torch.where(octcase,
                                      torch.where(inside_b, ind_b, parent),
                                      ind))
        level = torch.where(up, plevel, level)
        up = up & ~(rootcase | (octcase & inside_b)) & (level > 0)

    return _descend(grid, pos, level, ind, active & (ind >= 0))


def get_step(grid, pos, dir, level, ind, active):
    """Advance to the next cell through index_update: (ds_gl, pos, level,
    ind), ds in root-grid units (ds_local * 2^-level)."""
    ds_local, new_pos = boundary_step(pos, dir)
    ds_gl = ds_local * torch.exp2(-level.to(ds_local.dtype))
    pos = torch.where(active[..., None], new_pos, pos)
    pos, level, ind = index_update(grid, pos, level, ind, active)
    return ds_gl, pos, level, ind


MARCH_BLOCK = 32        # march_path_lengths: steps between readbacks


def march_path_lengths(grid, pos0, dir, max_steps=10000, block=MARCH_BLOCK):
    """March rays from global positions to their exit and return each
    ray's path length in root-grid units: the traversal alone, no physics
    (the speed-of-light bound of packet stepping, and a geometric check).
    soc_tpu's fixed-bound march, run on the rays' device: at most
    max_steps steps, stopping once every ray has left.

    The form a caller gets (march_form names it): blocks of ``block``
    steps, then one readback of whether any ray is left; on a CUDA device
    a block is captured as a CUDA graph and replayed
    (utils.graphs.GraphedBlock: the same kernels in the same order),
    elsewhere it runs eagerly. ``block=1`` is the step-by-step form, a
    readback every step. A ray that has left is masked exactly as in a
    single step, so the steps a block runs past the last ray change
    nothing: every form gives the same lengths bit for bit. A caller that
    marches the same grid again keeps a PathMarch, which captures once."""
    return PathMarch(grid, block)(pos0, dir, max_steps)


def march_form(device, block=MARCH_BLOCK):
    """The name of the march_path_lengths form on ``device``."""
    if block <= 1:
        return "step by step, a readback every step"
    how = "one CUDA graph replayed" if torch.device(device).type == "cuda" \
        else "eager"
    return "blocks of %d steps (%s), a readback a block" % (block, how)


class PathMarch:
    """march_path_lengths on one grid, keeping each shape of rays' graphed
    block across calls (as soc_tpu's bench keeps its jitted march)."""

    def __init__(self, grid, block=MARCH_BLOCK):
        self.grid, self.block = grid, max(1, int(block))
        self.blocks = {}

    def __call__(self, pos0, dir, max_steps=10000):
        grid = self.grid
        block = min(self.block, max_steps)
        pos, level, ind = index_global(grid, pos0)
        total = torch.zeros(pos.shape[:-1], dtype=torch.float32,
                            device=pos.device)
        state = (pos, level, ind, total)
        run = self._block(dir, block) if block > 1 else None
        done = 0
        while done < max_steps and bool((state[2] >= 0).any()):
            k = min(block, max_steps - done)
            if k == block and run is not None:
                state = run(*state, dir)
            else:
                for _ in range(k):
                    state = _march_step(grid, dir, *state)
            done += k
        # a graph's output buffers are reused by its next replay
        return state[3].clone() if run is not None else state[3]

    def _block(self, dir, block):
        from ..utils.graphs import GraphedBlock
        key = (tuple(dir.shape), str(dir.device), block)
        if key not in self.blocks:
            grid = self.grid

            def steps(pos, level, ind, total, dir):
                state = (pos, level, ind, total)
                for _ in range(block):
                    state = _march_step(grid, dir, *state)
                return state
            self.blocks[key] = GraphedBlock(steps, dir.device, kind="path")
        return self.blocks[key]


def _march_step(grid, dir, pos, level, ind, total):
    """One step of march_path_lengths; rays that have left stay as they
    are."""
    active = ind >= 0
    ds, npos, nlevel, nind = get_step(grid, pos, dir, level, ind, active)
    total = total + torch.where(active, ds, 0.0)
    pos = torch.where(active[..., None], npos, pos)
    level = torch.where(active, nlevel, level)
    ind = torch.where(active, nind, ind)
    return pos, level, ind, total


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


def stack_from_par(grid, level, ind):
    """The ancestor stack of (level, ind) cells rebuilt from the PAR array,
    for lanes born inside a cell anywhere in the hierarchy (cell emission):
    surface sources get theirs from the leaf descent instead."""
    anc = torch.zeros((ind.shape[0], max(grid.levels - 1, 1)),
                      dtype=torch.int64, device=ind.device)
    par = grid.par.to(torch.int64)
    for _ in range(grid.levels - 1):
        up = level > 0
        parent = par[_gidx(grid, level, ind)]
        plevel = (level - 1).clamp_min(0)
        anc = _anc_write(anc, plevel, parent, up)
        ind = torch.where(up, parent, ind)
        level = torch.where(up, plevel, level)
    return anc


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

    # filled on the device (a CUDA graph cannot capture a host copy)
    dims = torch.stack([pos.new_full((), float(n))
                        for n in (grid.nx, grid.ny, grid.nz)])
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
