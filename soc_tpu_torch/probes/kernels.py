"""The probes' four CUDA kernels and, beside each, its plain PyTorch
version with the same arguments.

  gather      csrc/probe_gather.cu   A1-A5, W1-W4, run_pallas_take
  row_gather  csrc/probe_gather.cu   RG
  scatter     csrc/probe_scatter.cu  S1, S2
  onehot      csrc/probe_onehot.cu   MX (bf16x1, bf16x2, correctness)

Each wrapper launches its kernel for CUDA tensors, or raises; only for
CPU tensors does it run the plain version. ``launches`` counts the
launches of each kernel. ``KERNELS`` and ``PLAIN`` bundle the two sets so
that a probe row can run through either (``ops=...``).

The index rules and layouts (the kernel sources say more):
  rule   ADD         k_i = (ix mod M + i) mod M
         LCG_BEFORE  j = lcg(j, i, M), then gather t[j]
         LCG_AFTER   gather t[j], then j = lcg(j, i, M)
  layout FLAT  t is one table of M entries
         ROW   t [rows, M], ix [rows, row_lanes]: each lane reads its row
         COL   t [M, ncols], ix [..., ncols]: each lane reads its column
M is read off the table's shape.
"""

import ctypes
from typing import Callable, NamedTuple

import torch

from .common import lcg

ADD, LCG_BEFORE, LCG_AFTER = 0, 1, 2
FLAT, ROW, COL = 0, 1, 2
ONEHOT_SIDE = 512           # the MX deposit's THI = TLO

launches = {"probe_gather": 0, "probe_row_gather": 0, "probe_scatter": 0,
            "probe_onehot": 0}

_SMEM_CAP = {}


def _smem_cap(lib, index):
    """Shared memory a block may use on card ``index`` (bytes), queried
    once."""
    if index not in _SMEM_CAP:
        _SMEM_CAP[index] = lib.probe_max_smem(index)
    return _SMEM_CAP[index]


def _lib(name):
    from .. import _build
    lib = _build.library(name)
    if getattr(lib, "_argtypes_set", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "probe_gather":
        lib.probe_gather.argtypes = [p, p, p] + [i] * 9 + [p]
        lib.probe_row_gather.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.probe_max_smem.argtypes = [i]
        lib.probe_gather_unroll.argtypes = [i]
        lib.probe_gather.restype = lib.probe_row_gather.restype = i
        lib.probe_max_smem.restype = lib.probe_gather_unroll.restype = i
        errs = lib.probe_error_string
    elif name == "probe_scatter":
        lib.probe_scatter.argtypes = [p, p, p, p] + [i] * 7 + [p]
        lib.probe_max_smem = lib.probe_scatter_max_smem
        lib.probe_max_smem.argtypes = [i]
        lib.probe_scatter.restype = lib.probe_max_smem.restype = i
        errs = lib.probe_scatter_error_string
    else:
        lib.probe_onehot.argtypes = [p, p, p, i, i, i, i, p]
        lib.probe_onehot.restype = i
        errs = lib.probe_onehot_error_string
    errs.argtypes = [i]
    errs.restype = ctypes.c_char_p
    lib.error_string = errs
    lib._argtypes_set = True
    return lib


def _check(name, x, device, dtype):
    if x.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, x.device, device))
    if x.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, x.dtype))
    if not x.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError("%s launch failed: %s"
                           % (what, lib.error_string(err).decode()))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _cuda_device(x, what):
    if x.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, x.device))
    return x.device


# ---------------------------------------------------------------- gather

def _gather_geometry(t, ix, layout):
    """(M, rows, row_lanes, ncols) of a gather; raises on shapes the
    layout cannot take."""
    if layout == FLAT:
        return t.numel(), 1, ix.numel(), 1
    if layout == ROW:
        if t.dim() != 2 or ix.dim() != 2 or ix.shape[0] != t.shape[0]:
            raise ValueError("ROW gather: t [rows, M] and ix [rows, lanes] "
                             "expected, got %s and %s"
                             % (tuple(t.shape), tuple(ix.shape)))
        return t.shape[1], t.shape[0], ix.shape[1], 1
    if layout == COL:
        if t.dim() != 2 or ix.dim() < 1 or ix.shape[-1] != t.shape[1]:
            raise ValueError("COL gather: t [M, ncols] and ix [..., ncols] "
                             "expected, got %s and %s"
                             % (tuple(t.shape), tuple(ix.shape)))
        return t.shape[0], 1, ix.numel(), t.shape[1]
    raise ValueError("unknown gather layout %r" % (layout,))


def gather(t, ix, rule, layout, reps):
    """acc[n] = sum_{i < reps} t[base(n) + k_i(n) * stride], added in step
    order; float32 of ix's shape. CUDA tensors: the gather kernel."""
    if t.device.type == "cpu":
        return gather_plain(t, ix, rule, layout, reps)
    device = _cuda_device(t, "gather")
    _check("t", t, device, torch.float32)
    _check("ix", ix, device, torch.int32)
    mod, rows, row_lanes, ncols = _gather_geometry(t, ix, layout)
    if rule not in (ADD, LCG_BEFORE, LCG_AFTER):
        raise ValueError("unknown gather rule %r" % (rule,))
    if rows > 65535:
        raise ValueError("ROW gather: at most 65535 rows, got %d" % rows)
    lib = _lib("probe_gather")
    stage = int(staged(layout, mod, _smem_cap(lib, device.index or 0)))
    out = torch.empty(ix.shape, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.probe_gather(t.data_ptr(), ix.data_ptr(), out.data_ptr(),
                               rule, layout, stage, ix.numel(), mod, reps,
                               rows, row_lanes, ncols, _stream(device))
    _raise_on(lib, err, "gather kernel")
    launches["probe_gather"] += 1
    return out


def staged(layout, mod, cap):
    """Whether the gather kernel copies the table to shared memory first,
    with ``cap`` bytes of it a block: a row (ROW) or a column with the
    others of its slab (COL) of ``mod`` floats that fits; a FLAT table is
    read through L2."""
    return layout != FLAT and 4 * mod <= cap


def _gather_steps(t, ix, rule, layout, reps):
    """The flat indices into t that a gather reads, one int64 tensor of
    ix's shape per step, in step order."""
    mod, rows, _, ncols = _gather_geometry(t, ix, layout)
    if layout == ROW:
        base = torch.arange(rows, device=t.device)[:, None] * mod
    elif layout == COL:
        base = torch.arange(ncols, device=t.device)
    else:
        base = 0
    stride = ncols if layout == COL else 1
    j = torch.remainder(ix, mod) if rule == ADD else ix
    for i in range(reps):
        if rule == ADD:
            k = torch.remainder(j + i, mod)
        elif rule == LCG_BEFORE:
            j = k = lcg(j, i, mod)
        else:
            k = j
        yield base + k.to(torch.int64) * stride
        if rule == LCG_AFTER:
            j = lcg(j, i, mod)


def gather_plain(t, ix, rule, layout, reps):
    """Plain version of ``gather``: the same float32 adds in the same
    order, so the two agree bit for bit."""
    flat = t.reshape(-1)
    acc = torch.zeros(ix.shape, dtype=torch.float32, device=t.device)
    for k in _gather_steps(t, ix, rule, layout, reps):
        acc = acc + flat[k]
    return acc


def gather_library(t, ix, rule, layout, reps):
    """``gather`` as one PyTorch call, its library yardstick: the [lanes,
    reps] matrix of the flat indices each lane reads is built here, once,
    and the returned callable sums each lane's bag with one
    ``embedding_bag`` (in its own order, not step by step)."""
    steps = list(_gather_steps(t, ix, rule, layout, reps))
    bags = torch.stack(steps, -1).reshape(-1, reps)
    weight = t.reshape(-1, 1)
    return lambda: torch.nn.functional.embedding_bag(
        bags, weight, mode="sum").view(ix.shape)


# ------------------------------------------------------------ row gather

def row_gather(t, r, reps, nk):
    """RG: out [1, nk], out[0, k] = sum_i rowsum(t[j_i[0, k]]) with j
    stepped by the LCG mod M before each gather (t [M, ncols], r [R, L],
    only row 0's first nk chains read). CUDA tensors: the kernel."""
    if t.device.type == "cpu":
        return row_gather_plain(t, r, reps, nk)
    device = _cuda_device(t, "row_gather")
    _check("t", t, device, torch.float32)
    _check("r", r, device, torch.int32)
    if t.dim() != 2 or r.dim() != 2 or r.shape[1] < nk:
        raise ValueError("row_gather: t [M, ncols] and r [R, >= nk] "
                         "expected, got %s and %s"
                         % (tuple(t.shape), tuple(r.shape)))
    if t.shape[0] < 1 or nk < 0 or reps < 0:
        raise ValueError("row_gather: needs M >= 1 rows, nk >= 0 and reps "
                         ">= 0, got %d, %d and %d" % (t.shape[0], nk, reps))
    lib = _lib("probe_gather")
    # rows read as float4 where each starts on 16 bytes
    vec = int(t.shape[1] % 4 == 0 and t.data_ptr() % 16 == 0)
    out = torch.empty((1, nk), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.probe_row_gather(t.data_ptr(), r.data_ptr(),
                                   out.data_ptr(), nk, t.shape[1],
                                   t.shape[0], reps, vec, _stream(device))
    _raise_on(lib, err, "row gather kernel")
    launches["probe_row_gather"] += 1
    return out


def row_gather_indices(r, reps, nk, mod):
    """J [nk, reps] (int64): the table row that step i of chain k reads,
    the LCG walked ahead from r[0, :nk] as the kernel walks it."""
    j, steps = r[0, :nk], []
    for i in range(reps):
        j = lcg(j, i, mod)
        steps.append(j.to(torch.int64))
    return torch.stack(steps, 1)


def row_gather_two_calls(t, r, reps, nk):
    """RG as two PyTorch calls, its reference beside the kernel (it has no
    one-call yardstick): J built here, once, then the returned callable
    sums each chain's rows with one ``embedding_bag`` and their columns
    with one ``sum``."""
    bags = row_gather_indices(r, reps, nk, t.shape[0])
    return lambda: torch.nn.functional.embedding_bag(
        bags, t, mode="sum").sum(1)[None, :]


def row_gather_plain(t, r, reps, nk):
    """Plain version of ``row_gather``: the LCG over the nk chains that
    feed the output, as the kernel steps them (the probe steps all of r,
    but the LCG is elementwise and only j[0, :nk] is read), the rows
    summed in torch's order."""
    mod = t.shape[0]
    acc = torch.zeros((1, nk), dtype=torch.float32, device=t.device)
    j = r[0, :nk]
    for i in range(reps):
        j = lcg(j, i, mod)
        rows = t[j.to(torch.int64)]
        acc = acc + rows.sum(1)[None, :]
    return acc


# --------------------------------------------------------------- scatter

def _scatter_geometry(ix, layout, mod):
    if layout == FLAT:
        return (mod,), 1, ix.numel()
    if layout == ROW:
        if ix.dim() != 2:
            raise ValueError("ROW scatter: ix [rows, lanes] expected, got %s"
                             % (tuple(ix.shape),))
        return (ix.shape[0], mod), ix.shape[0], ix.shape[1]
    raise ValueError("unknown scatter layout %r" % (layout,))


def scatter(ix, v, rule, layout, mod, reps):
    """FLAT: out [mod], out[k_i(n)] += v[n] for i < reps; ROW: out
    [rows, mod], out[s, k_i(s, l)] += v[s, l]. CUDA tensors: the kernel;
    FLAT with ADD keeps its tally H [mod] in a scratch tensor."""
    if ix.device.type == "cpu":
        return scatter_plain(ix, v, rule, layout, mod, reps)
    device = _cuda_device(ix, "scatter")
    _check("ix", ix, device, torch.int32)
    _check("v", v, device, torch.float32)
    if v.shape != ix.shape:
        raise ValueError("scatter: v has shape %s, ix %s"
                         % (tuple(v.shape), tuple(ix.shape)))
    if rule not in (ADD, LCG_BEFORE):
        raise ValueError("unknown scatter rule %r" % (rule,))
    if mod < 1 or reps < 0:
        raise ValueError("scatter: needs mod >= 1 and reps >= 0, got %d "
                         "and %d" % (mod, reps))
    shape, rows, row_lanes = _scatter_geometry(ix, layout, mod)
    lib = _lib("probe_scatter")
    cap = _smem_cap(lib, device.index or 0)
    if layout == ROW and 4 * (-(-mod // 4) * 4) > cap:
        raise ValueError("ROW scatter: a row's %d slots do not fit in the "
                         "%d bytes of shared memory a block may use"
                         % (mod, cap))
    flat_add = layout == FLAT and rule == ADD
    out = torch.empty(shape, dtype=torch.float32, device=device)
    h = torch.empty(mod, dtype=torch.float32, device=device) \
        if flat_add else None
    with torch.cuda.device(device):
        err = lib.probe_scatter(ix.data_ptr(), v.data_ptr(), out.data_ptr(),
                                None if h is None else h.data_ptr(), rule,
                                layout, ix.numel(), mod, reps, rows,
                                row_lanes, _stream(device))
    _raise_on(lib, err, "scatter kernel")
    launches["probe_scatter"] += 1
    return out


def scatter_plain(ix, v, rule, layout, mod, reps):
    """Plain version of ``scatter`` (index_add_, in torch's order)."""
    shape, rows, _ = _scatter_geometry(ix, layout, mod)
    out = torch.zeros(shape, dtype=torch.float32, device=ix.device)
    base = torch.arange(rows, device=ix.device)[:, None] * mod \
        if layout == ROW else 0
    j = torch.remainder(ix, mod) if rule == ADD else ix
    for i in range(reps):
        if rule == ADD:
            k = torch.remainder(j + i, mod)
        else:
            j = k = lcg(j, i, mod)
        out.view(-1).index_add_(0, (base + k.to(torch.int64)).reshape(-1),
                                v.reshape(-1))
    return out


# ---------------------------------------------------------------- onehot

def _bf16_parts(v, split):
    d1 = v.to(torch.bfloat16).to(torch.float32)
    if split == 1:
        return d1
    return d1 + (v - d1).to(torch.bfloat16).to(torch.float32)


def onehot(ix, v, split, reps, use_lcg):
    """MX: out [512, 512] += the bf16-rounded v (split 1) or the sum of its
    two bf16 terms (split 2) at cell j = hi * 512 + lo, for reps steps (j
    stepped by the LCG mod 512^2 first when use_lcg). CUDA tensors: the
    kernel, a tally held in the shared memory of groups of 8 blocks."""
    if ix.device.type == "cpu":
        return onehot_plain(ix, v, split, reps, use_lcg)
    device = _cuda_device(ix, "onehot")
    _check("ix", ix, device, torch.int32)
    _check("v", v, device, torch.float32)
    if v.shape != ix.shape or split not in (1, 2):
        raise ValueError("onehot: v %s against ix %s, split %r"
                         % (tuple(v.shape), tuple(ix.shape), split))
    if not use_lcg and ix.numel():
        lo, hi = torch.aminmax(ix)
        if int(lo) < 0 or int(hi) >= ONEHOT_SIDE ** 2:
            raise ValueError("onehot: indices outside [0, 512^2)")
    lib = _lib("probe_onehot")
    out = torch.zeros((ONEHOT_SIDE, ONEHOT_SIDE), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        err = lib.probe_onehot(ix.data_ptr(), v.data_ptr(), out.data_ptr(),
                               ix.numel(), reps, int(bool(use_lcg)), split,
                               _stream(device))
    _raise_on(lib, err, "one-hot kernel")
    launches["probe_onehot"] += 1
    return out


def onehot_plain(ix, v, split, reps, use_lcg):
    """Plain version of ``onehot``: index_add_ of the same bf16-rounded
    values into the flat 512^2 cells."""
    d = _bf16_parts(v.reshape(-1), split)
    out = torch.zeros(ONEHOT_SIDE ** 2, dtype=torch.float32, device=ix.device)
    j = ix.reshape(-1)
    for r in range(reps):
        if use_lcg:
            j = lcg(j, r, ONEHOT_SIDE ** 2)
        out.index_add_(0, j.to(torch.int64), d)
    return out.view(ONEHOT_SIDE, ONEHOT_SIDE)


class Ops(NamedTuple):
    gather: Callable
    row_gather: Callable
    scatter: Callable
    onehot: Callable


KERNELS = Ops(gather, row_gather, scatter, onehot)
PLAIN = Ops(gather_plain, row_gather_plain, scatter_plain, onehot_plain)
