"""Library-accelerated emission: a binned lookup over reference absorptions
(port of soc_tpu.solve.library).

The reference's A2E_LIB bins cells by their log-absorptions at three
reference frequencies into a 3-level tree of emission vectors, then
answers later emission solves with an O(1) lookup a cell. As in soc_tpu,
the binning is a dense [NB, NB, NB, NFREQ] grid with nearest-occupied-bin
hole filling (kernel_tree3's Interpolate / Fill).

build_library, save_library and load_library are host NumPy, copied from
soc_tpu bit for bit, and the `.lib` file is the same pickle of NumPy
arrays, so each package reads the other's. solve_with_library takes a
torch device: by default (None) or on a CUDA device the lookup runs on the
card (a float32 bin transform, then one index_select from the hole-filled
table, cached on the library dict), for any cell count; only with a CPU
device the float64 NumPy form runs, the lookup's plain twin.

Workflow (reference ASOC.py libabs/libmaps + A2E_LIB):
  1. a full A2E solve once -> (absorbed, emitted) training pairs
  2. build_library() bins them
  3. later runs simulate only the reference frequencies (libabs) and call
     solve_with_library() for the full emission spectra.
"""

import pickle

import numpy as np
import torch

from ..constants import um2f


def choose_reference_frequencies(freq, um=(0.55, 2.2, 25.0)):
    """Default reference wavelengths (um) -> nearest frequency indices."""
    return [int(np.argmin(np.abs(freq - um2f(u)))) for u in um]


def build_library(absorbed, emitted, ref_indices, nbins=64, eps=1e-33):
    """Bin cells by log10 absorptions at the reference frequencies.

    absorbed : [CELLS, NFREQ_ABS]; emitted : [CELLS, NFREQ]
    Returns a library dict.
    """
    ref = np.log10(np.maximum(
        np.asarray(absorbed, np.float64)[:, ref_indices], eps))
    lo = ref.min(axis=0)
    hi = ref.max(axis=0)
    span = np.maximum(hi - lo, 1e-10)
    idx = np.clip(((ref - lo) / span * (nbins - 1)).round().astype(np.int64),
                  0, nbins - 1)
    flat = (idx[:, 0] * nbins + idx[:, 1]) * nbins + idx[:, 2]
    nf = emitted.shape[1]
    sums = np.zeros((nbins ** 3, nf), np.float64)
    counts = np.zeros(nbins ** 3, np.int64)
    np.add.at(sums, flat, np.asarray(emitted, np.float64))
    np.add.at(counts, flat, 1)
    occupied = counts > 0
    mean = np.zeros_like(sums)
    mean[occupied] = sums[occupied] / counts[occupied, None]

    # hole filling: assign every empty bin its nearest occupied bin
    # (kernel_tree3 Interpolate/Fill role), via iterative 6-neighbour
    # dilation over the 3-D bin grid
    src = np.arange(nbins ** 3, dtype=np.int64)
    src[~occupied] = -1
    src3 = src.reshape(nbins, nbins, nbins)
    filled = occupied.reshape(nbins, nbins, nbins).copy()
    for _ in range(3 * nbins):
        if filled.all():
            break
        for axis in range(3):
            for shift in (1, -1):
                cand = np.roll(src3, shift, axis=axis)
                edge = [slice(None)] * 3
                edge[axis] = 0 if shift == 1 else nbins - 1
                cand[tuple(edge)] = -1
                take = (~filled) & (cand >= 0)
                src3[take] = cand[take]
                filled |= take
    lookup = src3.reshape(-1)
    lookup[lookup < 0] = np.nonzero(occupied)[0][0] if occupied.any() else 0

    return dict(ref_indices=list(ref_indices), nbins=int(nbins),
                lo=lo, span=span, mean=mean.astype(np.float32),
                lookup=lookup.astype(np.int64),
                occupancy=float(occupied.mean()))


def device_table(lib, device):
    """(table [NB^3, NF], lo [3], span [3]) on ``device``: the emission
    table already gathered through ``lookup`` (so a cell costs one row
    read) and the bin transform in float32. Cached on the dict under
    "_tables" (a "_" key: save_library leaves it out)."""
    device = torch.device(device)
    cache = lib.setdefault("_tables", {})
    key = str(device)
    if key not in cache:
        cache[key] = (
            torch.as_tensor(lib["mean"][lib["lookup"]], device=device),
            torch.as_tensor(np.asarray(lib["lo"], np.float32), device=device),
            torch.as_tensor(np.asarray(lib["span"], np.float32),
                            device=device))
    return cache[key]


def lookup_torch(table, lo, span, absorbed_ref, nbins, eps=1e-33):
    """The lookup on tensors: absorbed_ref [CELLS, 3] float32 -> the table's
    rows [CELLS, NF], as soc_tpu's device path computes it (float32 log10,
    round half to even, clip, one gather)."""
    ref = torch.log10(torch.clamp(absorbed_ref, min=eps))
    idx = torch.clamp(torch.round((ref - lo) / span * (nbins - 1))
                      .to(torch.int64), 0, nbins - 1)
    flat = (idx[:, 0] * nbins + idx[:, 1]) * nbins + idx[:, 2]
    return torch.index_select(table, 0, flat)


def lookup_numpy(lib, absorbed, eps=1e-33):
    """The lookup's plain twin (soc_tpu's host path, float64 bins)."""
    nbins = lib["nbins"]
    ref = np.log10(np.maximum(
        np.asarray(absorbed, np.float64)[:, lib["ref_indices"]], eps))
    idx = np.clip(((ref - lib["lo"]) / lib["span"]
                   * (nbins - 1)).round().astype(np.int64), 0, nbins - 1)
    flat = (idx[:, 0] * nbins + idx[:, 1]) * nbins + idx[:, 2]
    return lib["mean"][lib["lookup"][flat]]


def solve_with_library(lib, absorbed, eps=1e-33, device=None):
    """Emission for [CELLS, NFREQ_ABS] absorptions via the binned lookup;
    a float32 host array [CELLS, NF]. The arguments are soc_tpu's, in its
    order.

    device : the card by default (None: the current CUDA device), or a
    CUDA device: the lookup runs there (one index_select over the cached
    table, for any cell count); only a CPU device runs the float64 NumPy
    twin. Without a card and without a CPU device it raises, as every
    entry point of the port does. The two share the bin transform; the
    card's runs in float32, so a cell within float32 epsilon of a bin
    edge may round to the neighbouring bin (both answers are valid
    emission vectors of the hole-filled table).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return lookup_numpy(lib, absorbed, eps)
    if not torch.cuda.is_available():
        raise RuntimeError("solve_with_library: no CUDA device; pass "
                           "device='cpu' for the NumPy twin")
    table, lo, span = device_table(lib, device)
    aref = torch.as_tensor(np.ascontiguousarray(
        np.asarray(absorbed, np.float32)[:, lib["ref_indices"]]),
        device=table.device)
    return lookup_torch(table, lo, span, aref, lib["nbins"],
                        eps).cpu().numpy()


def save_library(path, lib):
    with open(path, "wb") as fp:
        # "_"-prefixed keys are runtime caches (device tensors)
        pickle.dump({k: v for k, v in lib.items()
                     if not k.startswith("_")}, fp)


def load_library(path):
    with open(path, "rb") as fp:
        return pickle.load(fp)
