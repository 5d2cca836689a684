"""The A2E stochastic-heating solve: the hand-written CUDA kernels
(``csrc/a2e.cu``) and their plain PyTorch twin.

``solve_all_sizes`` launches ``a2e_all_sizes``, which replaces soc_tpu's
Pallas kernel in ``solve/pallas_a2e.py``. It takes the pre-folded weights
and so cannot apply the exact path's per-entry clamp: it equals the exact
path only when all weights and all absorbed values are non-negative (the
caller checks). ``solve_all_sizes_clamp`` launches ``a2e_clamp``, the exact
path for any signs, from the unfolded weights. ``solve_all_sizes_sharded``
splits the cells over several devices and launches either kernel once per
shard, as soc_tpu's ``solve_all_chunks_sharded`` splits its chunks over a
device mesh.

The wrappers launch their kernel for CUDA tensors, or raise; only for CPU
tensors do they run the plain twin. A shape whose populations (and
ABS) do not fit a block's shared memory at any tile goes to the kernels'
global-memory form (csrc/a2e.cu): the same arithmetic, with the
populations in a scratch the wrapper allocates in device memory, never to
the plain twin. The plain twin ``solve_batch`` is
soc_tpu's exact XLA path written in torch: the heating matrix with each
entry clamped at zero, the fold, the forward substitution with the
overflow rescale, and the emission, in float32 matrix products (no TF32).
"""

import ctypes
import itertools
import math
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

launches = 0           # a2e_all_sizes launches made by solve_all_sizes
align_launches = 0     # launches of either form with the align weights
clamp_launches = 0     # a2e_clamp launches made by solve_all_sizes_clamp
global_launches = 0    # a2e_all_sizes' global-memory form's launches
clamp_global_launches = 0   # a2e_clamp's global-memory form's launches
_count_lock = threading.Lock()   # the counts may be added to from threads


def _count(name):
    with _count_lock:
        globals()[name] += 1


@dataclass(frozen=True)
class A2EStacks:
    """Per-size A2E arrays of the stochastic sizes, stacked on axis 0.

    w_flat : [S, NE*NE, NFREQ] dense heating weights (AF folded in), for
             the plain twin; None in stacks built for the kernels alone
    w_fold : [S, NE, NE, NFP] the same weights with the u-cumsum fold
             pre-applied in float64, for a2e_all_sizes: row j's column l
             holds the frequencies, zero-padded to NFP = 4*ceil(NFREQ/4)
             so that each column is 16-byte aligned, w_fold[s, j, l, f] =
             W'[s, f, j*NE + l] of soc_tpu's prepare_size_arrays_fused
             (fold_rows); None in stacks built for the clamp kernel
    tdown  : [S, NE] cooling rates
    ea     : [S, NFREQ, NE] emission arrays (Ibeg-masked)
    w_unf  : [S, NE, NE, NFP] the unfolded weights column by column, for
             a2e_clamp: column l's row u holds the frequencies, zero-padded
             as in w_fold, w_unf[s, l, u, f] = w_flat[s, u*NE + l, f]
             (unfold_cols), so column l's rows u > l are one contiguous
             run; None unless the clamp path was asked for
    """

    w_flat: Optional[torch.Tensor]
    w_fold: Optional[torch.Tensor]
    tdown: torch.Tensor
    ea: torch.Tensor
    ne: int
    w_unf: Optional[torch.Tensor] = None

    @property
    def nsize(self):
        return self.tdown.shape[0]


def solve_batch(w_flat, tdown, ea, absorbed, ne):
    """Plain twin: steady-state emission of a batch of cells, one size.

    w_flat [NE*NE, NFREQ], tdown [NE], ea [NFREQ, NE], absorbed
    [batch, NFREQ]. Returns EMIT [batch, NFREQ]."""
    batch = absorbed.shape[0]
    # 1. heating matrices, each entry clamped at zero
    a = torch.clamp_min(absorbed @ w_flat.T, 0.0).reshape(batch, ne, ne)
    # 2. fold: reversed cumsum over u, the bottom row excluded for j<NE-1
    s = torch.flip(torch.cumsum(torch.flip(a, [1]), 1), [1])
    b_mat = s - a[:, ne - 1:ne, :]
    b_mat[:, ne - 1, :] = a[:, ne - 1, :]
    # 3. forward substitution with overflow rescale (keep i < j only)
    ar = torch.arange(ne, device=absorbed.device)
    b_mat = b_mat * (ar[None, :] < ar[:, None]).to(b_mat.dtype)[None]
    x = torch.zeros((batch, ne), dtype=torch.float32,
                    device=absorbed.device)
    x[:, 0] = 1.0e-20
    td = tdown + 1.0e-30
    for j in range(1, ne):
        s_j = (b_mat[:, j, :] * x).sum(1)
        # clamp below float32 inf so the rescale can always recover
        x_j = torch.clamp(s_j / td[j], 0.0, 3.0e37)
        scale = torch.where(x_j > 1.0e20, 1.0e-20, 1.0)
        x = x * scale[:, None]
        x[:, j] = x_j * scale
    # 4. normalise + emission (a fully underflowed population gives 0)
    x = x / torch.clamp_min(x.sum(1, keepdim=True), 1e-35)
    return x @ ea.T


def solve_all_sizes_plain(stacks, absorbed, align=None, batch=16384):
    """Plain twin of the kernel over all sizes: (tot, ptot) with
    tot = sum_s EMIT_s and ptot = sum_s EMIT_s * align[s] (or None)."""
    if stacks.w_flat is None:
        raise ValueError("A2E plain twin: these stacks carry no w_flat "
                         "(build them with plain=True)")
    cells = absorbed.shape[0]
    tot = torch.zeros_like(absorbed)
    ptot = torch.zeros_like(absorbed) if align is not None else None
    for s in range(stacks.nsize):
        for i0 in range(0, cells, batch):
            i1 = min(i0 + batch, cells)
            em = solve_batch(stacks.w_flat[s], stacks.tdown[s],
                             stacks.ea[s], absorbed[i0:i1], stacks.ne)
            tot[i0:i1] += em
            if ptot is not None:
                ptot[i0:i1] += em * align[s, i0:i1, None]
    return tot, ptot


_SMEM_CAP = {}
_CONFIG = {}
MIN_WARPS = 8           # resident warps per SM: a2e_all_sizes' aim, and
                        # the least either kernel keeps at the pipeline's
                        # shape (chip_smoke.py phases 3 and 6)
CLAMP_WARPS = 12        # a2e_clamp's aim: it runs faster with 12 than 8


def _lib():
    from .. import _build
    lib = _build.library("a2e")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.a2e_all_sizes.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.a2e_clamp.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.a2e_all_sizes.restype = lib.a2e_clamp.restype = i
        for name in ("a2e_all_sizes_global", "a2e_clamp_global"):
            fn = getattr(lib, name)
            fn.argtypes = [p] * 8 + [i] * 4 + [ctypes.c_longlong, i, i, p]
            fn.restype = i
        for kernel in ("fold", "clamp"):
            smem = getattr(lib, "a2e_%s_smem_bytes" % kernel)
            blocks = getattr(lib, "a2e_%s_blocks_per_sm" % kernel)
            smem.argtypes = blocks.argtypes = [i, i, i, i]
            smem.restype, blocks.restype = ctypes.c_size_t, i
            gsmem = getattr(lib, "a2e_%s_global_smem_bytes" % kernel)
            gblocks = getattr(lib, "a2e_%s_global_blocks_per_sm" % kernel)
            gsmem.argtypes, gblocks.argtypes = [i, i], [i, i, i, i]
            gsmem.restype, gblocks.restype = ctypes.c_size_t, i
        lib.a2e_max_smem.argtypes = [i]
        lib.a2e_max_smem.restype = i
        lib.a2e_error_string.argtypes = [i]
        lib.a2e_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _smem_cap(lib, device_index):
    cap = _SMEM_CAP.get(device_index)
    if cap is None:
        cap = _SMEM_CAP[device_index] = lib.a2e_max_smem(device_index)
    return cap


class Config(tuple):
    """(tile, run, resident warps per SM) of an A2E launch, with ``form``:
    "shared" (the populations, and ABS beyond one register chunk, in a
    block's shared memory) or "global" (both in device memory, shared
    memory holding the staged runs alone; run 0 reads the weights
    unstaged). Compares equal to the plain triple."""

    def __new__(cls, tile, run, warps, form="shared"):
        self = super().__new__(cls, (tile, run, warps))
        self.form = form
        return self

    @property
    def tile(self):
        return self[0]

    @property
    def run(self):
        return self[1]


GLOBAL_TILE = 128       # cells a block of the global form


def _query(name, blocks, lib):
    if blocks < 0:
        raise RuntimeError("A2E kernel %s: occupancy query failed: %s"
                           % (name, lib.a2e_error_string(-blocks).decode()))
    return blocks


def _pick_config(lib, kernel, nfreq, ne, device_index, whole, aim):
    """Config of ``kernel`` ("fold" or "clamp"): the first (tile, run),
    tiles from 128 down and staged runs from ``whole`` down through 64,
    32, 16 and 8, that keeps ``aim`` warps on an SM; else the one that
    keeps the most. Where no (tile, run) fits the block's shared memory,
    the global form at GLOBAL_TILE cells a block with the longest run of
    those whose two staging buffers fit, or run 0 (unstaged) where none
    does. Cached per device and shape: the choice depends on the shape and
    the device alone."""
    key = (kernel, device_index, nfreq, ne)
    if key in _CONFIG:
        return _CONFIG[key]
    name = "a2e_all_sizes" if kernel == "fold" else "a2e_clamp"
    smem_bytes = getattr(lib, "a2e_%s_smem_bytes" % kernel)
    blocks_per_sm = getattr(lib, "a2e_%s_blocks_per_sm" % kernel)
    cap = _smem_cap(lib, device_index)
    runs = [whole] + [n for n in (64, 32, 16, 8) if n < whole]
    best = (0, 0, 0)
    for tile, run in itertools.product((128, 64, 32), runs):
        if smem_bytes(nfreq, ne, tile, run) > cap:
            continue
        blocks = _query(name, blocks_per_sm(nfreq, ne, tile, run), lib)
        if blocks * tile // 32 > best[2]:
            best = (tile, run, blocks * tile // 32)
        if best[2] >= aim:
            break
    if best[2] > 0:
        config = Config(*best)
    else:
        gsmem = getattr(lib, "a2e_%s_global_smem_bytes" % kernel)
        run = next((r for r in runs if gsmem(nfreq, r) <= cap), 0)
        blocks = _query(name, getattr(
            lib, "a2e_%s_global_blocks_per_sm" % kernel)(
                nfreq, ne, GLOBAL_TILE, run), lib)
        config = Config(GLOBAL_TILE, run, blocks * GLOBAL_TILE // 32,
                        "global")
    _CONFIG[key] = config
    return config


def pick_fold_config(lib, nfreq, ne, device_index):
    """a2e_all_sizes: Config (tile, lc, resident warps per SM). lc is the
    number of a row's columns staged at a time: the whole row (NE - 2) where
    shared memory allows, else 64, 32, 16 or 8. A larger tile reads W' from
    L2 fewer times; a larger lc needs fewer barriers. The choice depends
    on the shape and the device alone, never on the cell count: lc sets
    the order of the sums, and a shard must add up as one launch does."""
    return _pick_config(lib, "fold", nfreq, ne, device_index,
                        max(ne - 2, 1), MIN_WARPS)


def pick_clamp_config(lib, nfreq, ne, device_index):
    """a2e_clamp: Config (tile, lr, resident warps per SM). lr is the number of
    a column's rows staged at a time: the longest column's NE - 1, else
    64, 32, 16 or 8, the first that keeps CLAMP_WARPS warps on an SM;
    chosen, as for pick_fold_config, from the shape and the device
    alone."""
    return _pick_config(lib, "clamp", nfreq, ne, device_index, ne - 1,
                        CLAMP_WARPS)


def shape_ceiling(lib, kernel, device_index, nfreq=None, ne=None):
    """The largest NE at ``nfreq`` (or, given ``ne``, the largest NFREQ)
    that ``kernel``'s shared form ("fold": a2e_all_sizes, "clamp":
    a2e_clamp) takes on the device, by doubling and then bisection over the
    picker itself: its shared memory grows with both, so the shapes it
    takes end at one edge. One step beyond, the picker turns to the global
    form."""
    pick = pick_fold_config if kernel == "fold" else pick_clamp_config
    if (nfreq is None) == (ne is None):
        raise ValueError("shape_ceiling: give nfreq or ne, not both")

    def admits(x):
        return pick(lib, nfreq or x, ne or x, device_index).form == "shared"
    lo = 2 if ne is None else 1           # NE >= 2, NFREQ >= 1
    if not admits(lo):
        raise ValueError("A2E kernel %s: NE=%d with NFREQ=%d needs more "
                         "shared memory than a block may use (%d bytes)"
                         % ("a2e_all_sizes" if kernel == "fold"
                            else "a2e_clamp", ne or lo, nfreq or lo,
                            _smem_cap(lib, device_index)))
    hi = 2 * lo
    while admits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if admits(mid) else (lo, mid)
    return lo


def _check_cuda(name, t, device, shape):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != torch.float32:
        raise TypeError("%s must be float32, got %s" % (name, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _launch(kernel, weights_name, stacks, absorbed, align):
    """Checks the inputs and launches csrc/a2e.cu's ``kernel`` on CUDA
    tensors; returns (tot, ptot or None)."""
    if absorbed.device.type != "cuda":
        raise ValueError("A2E solve: unsupported device %s" % absorbed.device)
    device = absorbed.device
    cells, nfreq = absorbed.shape
    ne, nsize = stacks.ne, stacks.nsize
    if ne < 2 or cells == 0:
        raise ValueError("A2E kernel: needs NE >= 2 and cells > 0 "
                         "(NE=%d, cells=%d)" % (ne, cells))
    weights = getattr(stacks, weights_name)
    if weights is None:
        raise ValueError("A2E kernel %s: these stacks carry no %s"
                         % (kernel, weights_name))
    _check_cuda("absorbed", absorbed, device, (cells, nfreq))
    _check_cuda(weights_name, weights, device,
                (nsize, ne, ne, padded_nfreq(nfreq)))
    _check_cuda("tdown", stacks.tdown, device, (nsize, ne))
    _check_cuda("ea", stacks.ea, device, (nsize, nfreq, ne))
    if align is not None:
        _check_cuda("align", align, device, (nsize, cells))
    lib = _lib()
    index = device.index or 0
    tot = torch.empty((cells, nfreq), dtype=torch.float32, device=device)
    ptot = torch.empty_like(tot) if align is not None else None
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        pick = pick_fold_config if kernel == "a2e_all_sizes" \
            else pick_clamp_config
        config = pick(lib, nfreq, ne, index)
        args = (weights.data_ptr(), stacks.tdown.data_ptr(),
                stacks.ea.data_ptr())
        tail = (align.data_ptr() if align is not None else None,
                tot.data_ptr(), ptot.data_ptr() if ptot is not None else None)
        if config.form == "shared":
            err = getattr(lib, kernel)(
                *args, absorbed.data_ptr(), *tail, nsize, nfreq, ne, cells,
                config.tile, config.run, stream)
        else:
            abs_t, scratch = _global_buffers(kernel, absorbed, ne,
                                             config.tile)
            err = getattr(lib, kernel + "_global")(
                *args, abs_t.data_ptr(), *tail, scratch.data_ptr(), nsize,
                nfreq, ne, cells, scratch.shape[1], config.tile, config.run,
                stream)
    if err != 0:
        raise RuntimeError("A2E kernel %s launch failed: %s"
                           % (kernel, lib.a2e_error_string(err).decode()))
    return (tot, ptot), config.form


def _global_buffers(kernel, absorbed, ne, tile):
    """The global form's device buffers: ABS transposed and zero-padded
    [NFP, CP] and the populations' scratch [NE, CP], CP the cells rounded
    up to whole blocks of ``tile``. Raises torch.cuda.OutOfMemoryError
    naming the scratch size when the card cannot hold them."""
    cells, nfreq = absorbed.shape
    cp = -(-cells // tile) * tile
    nbytes = 4 * cp * (ne + padded_nfreq(nfreq))
    try:
        abs_t = torch.zeros((padded_nfreq(nfreq), cp), dtype=torch.float32,
                            device=absorbed.device)
        abs_t[:nfreq, :cells] = absorbed.T
        scratch = torch.empty((ne, cp), dtype=torch.float32,
                              device=absorbed.device)
    except torch.cuda.OutOfMemoryError as err:
        raise torch.cuda.OutOfMemoryError(
            "A2E kernel %s (global form): NE=%d, NFREQ=%d over %d cells "
            "needs %d bytes of scratch in device memory (the populations "
            "[NE, %d] and ABS [NFP, %d]): %s"
            % (kernel, ne, nfreq, cells, nbytes, cp, cp, err)) from None
    return abs_t, scratch


def solve_all_sizes(stacks, absorbed, align=None):
    """EMIT summed over all stochastic sizes for [cells, NFREQ] absorbed
    photons, and the align-weighted sum when align [S, cells] is given.
    Returns (tot, ptot or None).

    CUDA tensors: the pre-folded kernel a2e_all_sizes (exact only for
    non-negative weights and absorbed values), in its global-memory form
    where the shape does not fit shared memory. CPU tensors: the plain
    twin."""
    if absorbed.device.type == "cpu":
        return solve_all_sizes_plain(stacks, absorbed, align)
    out, form = _launch("a2e_all_sizes", "w_fold", stacks, absorbed, align)
    _count("launches" if form == "shared" else "global_launches")
    if align is not None:
        _count("align_launches")
    return out


def solve_all_sizes_clamp(stacks, absorbed, align=None):
    """As solve_all_sizes, for weights and absorbed values of any sign:
    CUDA tensors launch a2e_clamp (stacks built with clamp=True), CPU
    tensors run the plain twin."""
    if absorbed.device.type == "cpu":
        return solve_all_sizes_plain(stacks, absorbed, align)
    out, form = _launch("a2e_clamp", "w_unf", stacks, absorbed, align)
    _count("clamp_launches" if form == "shared" else "clamp_global_launches")
    return out


def shard_ranges(cells, nshards):
    """Contiguous [c0, c1) cell ranges, one per shard, the first
    cells % nshards of them one cell longer."""
    q, r = divmod(cells, nshards)
    starts = [i * q + min(i, r) for i in range(nshards + 1)]
    return list(zip(starts[:-1], starts[1:]))


def solve_all_sizes_sharded(stacks_by_device, absorbed, align, devices,
                            clamp):
    """solve_all_sizes (or, with ``clamp``, solve_all_sizes_clamp) with
    the cells split into contiguous ranges over ``devices``, one launch per
    shard on its device's current stream; the counterpart of soc_tpu's
    solve_all_chunks_sharded. A device may repeat: its shards then run one
    after the other on that device.

    stacks_by_device : {torch.device: A2EStacks on that device}
    absorbed [cells, NFREQ] and align [S, cells] (or None) on any device;
    the results come back to absorbed's device in cell order. The kernels
    give each cell one thread and sum in a fixed order, so the result
    equals one launch over all cells bit for bit. Shards with no cells
    (more devices than cells) are skipped. Returns (tot, ptot or None)."""
    solve = solve_all_sizes_clamp if clamp else solve_all_sizes
    cells = absorbed.shape[0]
    # every shard's inputs are copied before any kernel is queued: a copy
    # between cards runs on the source card's stream, so a copy queued
    # after a launch there would wait for that kernel
    inputs = []
    for dev, (c0, c1) in zip(devices, shard_ranges(cells, len(devices))):
        if c1 == c0:
            continue
        dev = torch.device(dev)
        al = None if align is None \
            else align[:, c0:c1].to(dev).contiguous()
        inputs.append((dev, absorbed[c0:c1].to(dev), al))
    parts = [solve(stacks_by_device[dev], ab, al) for dev, ab, al in inputs]
    tot = torch.cat([t.to(absorbed.device) for t, _ in parts])
    if align is None:
        return tot, None
    return tot, torch.cat([p.to(absorbed.device) for _, p in parts])


def padded_nfreq(nfreq):
    """NFP, the frequency axis of w_fold: NFREQ rounded up to a multiple
    of 4."""
    return -(-nfreq // 4) * 4


def fold_rows(w_fold):
    """soc_tpu's folded weights [S, NFREQ, NE*NE] (prepare_size_arrays_fused
    stacked), a tensor, as a2e_all_sizes reads them: [S, NE, NE, NFP],
    frequencies last, zero-padded; rearranged on w_fold's device."""
    nsize, nfreq, nn = w_fold.shape
    ne = math.isqrt(nn)
    rows = w_fold.reshape(nsize, nfreq, ne, ne).permute(0, 2, 3, 1)
    return torch.nn.functional.pad(
        rows, (0, padded_nfreq(nfreq) - nfreq)).contiguous()


def unfold_cols(w_flat):
    """soc_tpu's dense weights [S, NE*NE, NFREQ] (prepare_size_arrays
    stacked, row u*NE + l), a tensor, as a2e_clamp reads them: [S, NE, NE,
    NFP], column l, then row u, then the frequencies, zero-padded;
    rearranged on w_flat's device."""
    nsize, nn, nfreq = w_flat.shape
    ne = math.isqrt(nn)
    cols = w_flat.reshape(nsize, ne, ne, nfreq).transpose(1, 2)
    return torch.nn.functional.pad(
        cols, (0, padded_nfreq(nfreq) - nfreq)).contiguous()


def stacks_from_numpy(w_flat, w_fold, tdown, ea, device, w_unf=None):
    """A2EStacks from host arrays (see convert.py); w_flat, w_fold and
    w_unf may each be None. w_fold comes in soc_tpu's layout [S, NFREQ,
    NE*NE] and is carried as fold_rows gives it; w_unf, the clamp kernel's
    weights, comes as the dense weights of soc_tpu's prepare_size_arrays
    [S, NE*NE, NFREQ] and is carried as unfold_cols gives it."""
    def t(a):
        return None if a is None else torch.tensor(
            np.ascontiguousarray(a, np.float32), device=device)
    return A2EStacks(w_flat=t(w_flat),
                     w_fold=None if w_fold is None else fold_rows(t(w_fold)),
                     tdown=t(tdown), ea=t(ea), ne=int(np.shape(tdown)[-1]),
                     w_unf=None if w_unf is None else unfold_cols(t(w_unf)))
