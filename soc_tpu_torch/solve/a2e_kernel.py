"""The A2E stochastic-heating solve: the hand-written CUDA kernels
(``csrc/a2e.cu``) and their plain PyTorch twin.

``solve_all_sizes`` launches ``a2e_all_sizes``, which replaces soc_tpu's
Pallas kernel in ``solve/pallas_a2e.py``. It takes the pre-folded weights
and so cannot apply the exact path's per-entry clamp: it equals the exact
path only when all weights and all absorbed values are non-negative (the
caller checks). ``solve_all_sizes_clamp`` launches ``a2e_clamp``, the exact
path for any signs, from the unfolded weights.

Both wrappers launch their kernel for CUDA tensors, or raise; only for CPU
tensors do they run the plain twin. The plain twin ``solve_batch`` is
soc_tpu's exact XLA path written in torch: the heating matrix with each
entry clamped at zero, the fold, the forward substitution with the
overflow rescale, and the emission, in float32 matrix products (no TF32).
"""

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

launches = 0        # a2e_all_sizes launches made by solve_all_sizes
clamp_launches = 0  # a2e_clamp launches made by solve_all_sizes_clamp


@dataclass(frozen=True)
class A2EStacks:
    """Per-size A2E arrays of the stochastic sizes, stacked on axis 0.

    w_flat : [S, NE*NE, NFREQ] dense heating weights (AF folded in), for
             the plain twin; None in stacks built for the kernels alone
    w_fold : [S, NFREQ, NE*NE] the same weights with the u-cumsum fold
             pre-applied in float64, transposed, for a2e_all_sizes; None
             in stacks built for the clamp kernel
    tdown  : [S, NE] cooling rates
    ea     : [S, NFREQ, NE] emission arrays (Ibeg-masked)
    w_unf  : [S, NFREQ, NE*NE] the unfolded weights, column-major:
             w_unf[s, f, l*NE + u] = w_flat[s, u*NE + l, f], for
             a2e_clamp; None unless the clamp path was asked for
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


def _lib():
    from .. import _build
    lib = _build.library("a2e")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.a2e_all_sizes, lib.a2e_clamp):
            fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
        lib.a2e_smem_bytes.argtypes = [i, i, i]
        lib.a2e_smem_bytes.restype = ctypes.c_size_t
        lib.a2e_max_smem.argtypes = [i]
        lib.a2e_max_smem.restype = ctypes.c_int
        lib.a2e_error_string.argtypes = [i]
        lib.a2e_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def pick_tile(lib, nfreq, ne, device_index):
    """Largest tile (cells per block) whose shared memory fits; raises for
    a shape the kernel cannot take."""
    cap = _SMEM_CAP.get(device_index)
    if cap is None:
        cap = _SMEM_CAP[device_index] = lib.a2e_max_smem(device_index)
    for tile in (128, 64, 32):
        if lib.a2e_smem_bytes(nfreq, ne, tile) <= cap:
            return tile
    raise ValueError("A2E kernel: NE=%d with NFREQ=%d needs more shared "
                     "memory than a block may use (%d bytes)"
                     % (ne, nfreq, cap))


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
    _check_cuda(weights_name, weights, device, (nsize, nfreq, ne * ne))
    _check_cuda("tdown", stacks.tdown, device, (nsize, ne))
    _check_cuda("ea", stacks.ea, device, (nsize, nfreq, ne))
    if align is not None:
        _check_cuda("align", align, device, (nsize, cells))
    lib = _lib()
    tile = pick_tile(lib, nfreq, ne, device.index or 0)
    tot = torch.empty((cells, nfreq), dtype=torch.float32, device=device)
    ptot = torch.empty_like(tot) if align is not None else None
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, kernel)(
            weights.data_ptr(), stacks.tdown.data_ptr(),
            stacks.ea.data_ptr(), absorbed.data_ptr(),
            align.data_ptr() if align is not None else None,
            tot.data_ptr(), ptot.data_ptr() if ptot is not None else None,
            nsize, nfreq, ne, cells, tile, stream)
    if err != 0:
        raise RuntimeError("A2E kernel %s launch failed: %s"
                           % (kernel, lib.a2e_error_string(err).decode()))
    return tot, ptot


def solve_all_sizes(stacks, absorbed, align=None):
    """EMIT summed over all stochastic sizes for [cells, NFREQ] absorbed
    photons, and the align-weighted sum when align [S, cells] is given.
    Returns (tot, ptot or None).

    CUDA tensors: the pre-folded kernel a2e_all_sizes (exact only for
    non-negative weights and absorbed values). CPU tensors: the plain
    twin."""
    global launches
    if absorbed.device.type == "cpu":
        return solve_all_sizes_plain(stacks, absorbed, align)
    out = _launch("a2e_all_sizes", "w_fold", stacks, absorbed, align)
    launches += 1
    return out


def solve_all_sizes_clamp(stacks, absorbed, align=None):
    """As solve_all_sizes, for weights and absorbed values of any sign:
    CUDA tensors launch a2e_clamp (stacks built with clamp=True), CPU
    tensors run the plain twin."""
    global clamp_launches
    if absorbed.device.type == "cpu":
        return solve_all_sizes_plain(stacks, absorbed, align)
    out = _launch("a2e_clamp", "w_unf", stacks, absorbed, align)
    clamp_launches += 1
    return out


def stacks_from_numpy(w_flat, w_fold, tdown, ea, device, w_unf=None):
    """A2EStacks from host arrays (see convert.py); w_flat, w_fold and
    w_unf may each be None."""
    def t(a):
        return None if a is None else torch.tensor(
            np.ascontiguousarray(a, np.float32), device=device)
    return A2EStacks(w_flat=t(w_flat), w_fold=t(w_fold), tdown=t(tdown),
                     ea=t(ea), ne=int(np.shape(tdown)[-1]), w_unf=t(w_unf))
