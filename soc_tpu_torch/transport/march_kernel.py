"""The transport's march block as one CUDA kernel (``csrc/march.cu``).

``run_block`` launches ``march_block``: a service and ``period`` march
steps, ``services`` times, for every lane of a pool on a root grid, the
lane state in registers from the first step to the last (see the source
for the design). It replaces no TPU kernel: on the card the eager block
(``PoolRun._marches``' StepKit.service and StepKit.march) issued about
1,300 PyTorch kernels a block. The eager block stays the plain version:
the CPU runs it, and so does every configuration the kernel does not
cover (``StepKit.fuses_on``). The wrapper launches the kernel for CUDA
tensors or raises.

The kernel reads the pool's state and writes what the block changes into
new tensors (the lanes' ``ifreq``, ``stream``, ``hi``, ``e_cell``,
``level`` and ancestors stay the pool's), so a state tensor that two
fields of a pool share is never written through; the tallies (tabs, intf,
xab) are added to in place, absd is replaced by its sum. A launch
allocates its outputs with ``torch.empty`` and does not synchronise, so a
CUDA graph captures it (PoolRun's GraphedBlock).
"""

import ctypes
from dataclasses import replace

import torch

from .. import rng as socrng

# march_block launches that ran: run_block's own (not the one a CUDA
# graph's capture records) and every replay of a PoolRun's graph that
# holds the kernel (count_replay)
launches = 0


def _lib():
    from .. import _build
    lib = _build.library("march")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.march_block.argtypes = ([p] * 33 + [ll, ll] + [i] * 9
                                    + [ctypes.c_uint, p])
        lib.march_block.restype = i
        lib.march_error_string.argtypes = [i]
        lib.march_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def run_block(kit, st, services, period):
    """One march block of the pool ``st`` (a PoolState on a CUDA device)
    for the StepKit ``kit`` (``kit.fused``): ``services`` times a service
    and then ``period`` march steps. Replaces st's lane state by the
    block's and adds its deposits to the tallies."""
    global launches
    grid, b = kit.grid, st.b
    device = grid.device
    if device.type != "cuda" or not kit.fused:
        raise ValueError("march kernel: a root-grid pool on a CUDA device "
                         "(StepKit.fuses_on), got %s" % device)
    n = b.lanes
    f32, i64 = torch.float32, torch.int64
    for name, t, dtype, shape in (
            ("pos", b.pos, f32, (n, 3)), ("dir", b.dir, f32, (n, 3)),
            ("ind", b.ind, i64, (n,)), ("photons", b.photons, f32, (n,)),
            ("ifreq", b.ifreq, i64, (n,)), ("stream", b.stream, i64, (n,)),
            ("hi", b.hi, i64, (n,)), ("counter", b.counter, i64, (n,)),
            ("scatterings", b.scatterings, i64, (n,)),
            ("e_cell", b.e_cell, i64, (n,)),
            ("pending", st.pending, torch.bool, (n,)),
            ("free_path", st.free_path, f32, (n,)),
            ("tau", st.tau, f32, (n,)),
            ("esc_pending", st.esc_pending, f32, (n,)),
            ("absd", st.absd, f32, ()),
            ("dens", grid.dens, f32, (grid.cells,)),
            ("tabs", st.tabs, f32, (grid.cells,))):
        _check(name, t, device, dtype, shape)
    phys = kit.physics
    for key in ("kabs", "ksca", "tw"):
        _check(key, phys[key], device, f32, (kit.nfreq,))
    _check("csc", phys["csc"], device, f32, (kit.nfreq, kit.bins))
    intf = xab = None
    if kit.per_freq_tally:
        intf = st.intf
        _check("intf", intf, device, f32, (grid.cells * kit.ncol,))
    if kit.with_ali:
        xab = st.xab
        _check("xab", xab, device, f32, (grid.cells,))
    out = dict(pos=torch.empty_like(b.pos), dir=torch.empty_like(b.dir),
               ind=torch.empty_like(b.ind),
               photons=torch.empty_like(b.photons),
               counter=torch.empty_like(b.counter),
               scatterings=torch.empty_like(b.scatterings))
    pending = torch.empty_like(st.pending)
    free_path = torch.empty_like(st.free_path)
    tau = torch.empty_like(st.tau)
    esc = torch.empty_like(st.esc_pending)
    absd = st.absd.clone()
    lib = _lib()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        err = lib.march_block(
            *(ptr(t) for t in (
                b.pos, b.dir, b.ind, b.photons, b.ifreq, b.stream, b.hi,
                b.counter, b.scatterings, b.e_cell, st.pending, st.free_path,
                st.tau, st.esc_pending, out["pos"], out["dir"], out["ind"],
                out["photons"], out["counter"], out["scatterings"], pending,
                free_path, tau, esc, grid.dens, phys["kabs"], phys["ksca"],
                phys["tw"], phys["csc"], st.tabs, intf, xab, absd)),
            n, grid.cells, grid.nx, grid.ny, grid.nz, kit.bins, kit.ncol,
            kit.col0, int(kit.block), int(services), int(period),
            kit.seed & socrng.MASK32,
            torch.cuda.current_stream(device).cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError("march kernel launch failed: %s"
                           % lib.march_error_string(err).decode())
    if not capturing:
        launches += 1
    st.b = replace(b, **out)
    st.pending, st.free_path, st.tau, st.esc_pending = (pending, free_path,
                                                        tau, esc)
    st.absd = absd


def count_replay():
    """One more launch that ran: a replay of a CUDA graph that holds the
    kernel (PoolRun._replay of a fused kit)."""
    global launches
    launches += 1
