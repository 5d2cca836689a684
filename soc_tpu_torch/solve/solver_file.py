"""Solver-file (.solver) codec: the A2E chain's on-disk ABI.

The port's own copy of ``soc_tpu.solve.solver_file``, the same code: the
port imports nothing of soc_tpu.

Format (written by the reference's A2E_pre.py:180-291, read by A2E.py:117-190):
  int32   NFREQ
  float32 FREQ[NFREQ]
  float32 GRAIN_DENSITY
  int32   NSIZE
  float32 SIZE_A[NSIZE]
  float32 S_FRAC[NSIZE]            (sum == 1, excludes GRAIN_DENSITY)
  int32   NE
  float32 SK_ABS[NSIZE, NFREQ]     (pi a^2 Qabs * GRAIN_DENSITY * S_FRAC)
  then per size:
    int32   noIw
    float32 Iw[noIw]               sparse heating integration weights
    int32   L1[NE*NE], L2[NE*NE]   first/last frequency bin per (l,u) pair
    float32 Tdown[NE]              thermal-continuous cooling rates
    float32 EA[NFREQ, NE]          emission per energy bin
    int32   Ibeg[NFREQ]            first energy bin emitting at each freq
"""

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SizeData:
    iw: np.ndarray        # sparse float32 weights, concatenated l-major
    l1: np.ndarray        # [NE, NE] int32 (indexed [l, u])
    l2: np.ndarray        # [NE, NE] int32
    tdown: np.ndarray     # [NE] float32
    ea: np.ndarray        # [NFREQ, NE] float32
    ibeg: np.ndarray      # [NFREQ] int32


@dataclass
class SolverData:
    freq: np.ndarray          # [NFREQ]
    grain_density: float
    size_a: np.ndarray        # [NSIZE]
    s_frac: np.ndarray        # [NSIZE]
    ne: int
    sk_abs: np.ndarray        # [NSIZE, NFREQ]
    sizes: list               # list[SizeData]

    @property
    def nfreq(self):
        return len(self.freq)

    @property
    def nsize(self):
        return len(self.size_a)

    @property
    def k_abs(self):
        return np.sum(self.sk_abs, axis=0)


def read_solver(path):
    with open(path, "rb") as fp:
        nfreq = int(np.fromfile(fp, np.int32, 1)[0])
        freq = np.fromfile(fp, np.float32, nfreq)
        gd = float(np.fromfile(fp, np.float32, 1)[0])
        nsize = int(np.fromfile(fp, np.int32, 1)[0])
        size_a = np.fromfile(fp, np.float32, nsize)
        s_frac = np.clip(np.fromfile(fp, np.float32, nsize), 1e-32, 1e30)
        ne = int(np.fromfile(fp, np.int32, 1)[0])
        sk_abs = np.fromfile(fp, np.float32, nsize * nfreq).reshape(nsize,
                                                                    nfreq)
        sizes = []
        for _ in range(nsize):
            no_iw = int(np.fromfile(fp, np.int32, 1)[0])
            iw = np.fromfile(fp, np.float32, no_iw)
            l1 = np.fromfile(fp, np.int32, ne * ne).reshape(ne, ne)
            l2 = np.fromfile(fp, np.int32, ne * ne).reshape(ne, ne)
            tdown = np.fromfile(fp, np.float32, ne)
            ea = np.fromfile(fp, np.float32, ne * nfreq).reshape(nfreq, ne)
            ibeg = np.fromfile(fp, np.int32, nfreq)
            sizes.append(SizeData(iw, l1, l2, tdown, ea, ibeg))
    return SolverData(freq=freq, grain_density=gd, size_a=size_a,
                      s_frac=s_frac, ne=ne, sk_abs=sk_abs, sizes=sizes)


def write_solver(path, solver):
    with open(path, "wb") as fp:
        np.asarray([solver.nfreq], np.int32).tofile(fp)
        np.asarray(solver.freq, np.float32).tofile(fp)
        np.asarray([solver.grain_density], np.float32).tofile(fp)
        np.asarray([solver.nsize], np.int32).tofile(fp)
        np.asarray(solver.size_a, np.float32).tofile(fp)
        np.asarray(solver.s_frac, np.float32).tofile(fp)
        np.asarray([solver.ne], np.int32).tofile(fp)
        np.asarray(solver.sk_abs, np.float32).tofile(fp)
        for sd in solver.sizes:
            np.asarray([len(sd.iw)], np.int32).tofile(fp)
            np.asarray(sd.iw, np.float32).tofile(fp)
            np.asarray(sd.l1, np.int32).tofile(fp)
            np.asarray(sd.l2, np.int32).tofile(fp)
            np.asarray(sd.tdown, np.float32).tofile(fp)
            np.asarray(sd.ea, np.float32).tofile(fp)
            np.asarray(sd.ibeg, np.int32).tofile(fp)


def densify_weights(sd, ne, nfreq):
    """Sparse (Iw, L1, L2) -> dense W[NE, NE, NFREQ] with W[u, l] rows.

    The sparse stream is l-major then u ascending; each (l, u) pair holds
    weights for frequency bins L1[l,u]..L2[l,u] inclusive (kernel_A2E.c:45-54
    consumes them in exactly this order). Densifying turns the per-cell
    triple loop into one MXU matmul.
    """
    w = np.zeros((ne, ne, nfreq), np.float32)
    idx = 0
    iw = sd.iw
    for l in range(ne - 1):
        for u in range(l + 1, ne):
            a, b = sd.l1[l, u], sd.l2[l, u]
            if b >= a and a >= 0:
                n = b - a + 1
                w[u, l, a:b + 1] = iw[idx:idx + n]
                idx += n
    return w
