# Frozen copy of soc_tpu_torch/solve/solver_file.py at commit 6496b8b (the benchmark's yardstick:
# later changes to the program do not reach it). Imports changed; functions
# the benchmark does not call left out.
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


