"""Stochastically heated grains' emission, the reference's A2E: the
solver data worked out again from the GSET dust (the frozen A2E_pre,
frozen/solver_prep.py), then each cell's steady-state populations of the
NE enthalpy bins by forward substitution in float64, one cell and size at
a time as SOC's kernel_A2E.c states the solve:

  H[u, l] = max(0, sum_f W[u, l, f] AF[f] ABS[f])          (u > l)
  S[j, l] = sum_{u >= j} H[u, l], less H[NE-1, l] below the top bin
  X[0] = 1,  X[j] = sum_{l < j} S[j, l] X[l] / TDOWN[j]
  EMIT[f] = sum_s sum_j X_s[j] / sum(X_s) EA_s[f, j]        (j >= IBEG[f])

with the absorptions' top channel clipped to 0.2 times the one below and
AF the size's share of the absorption cross section.
"""

import numpy as np
import torch

from ..frozen.grain_model import read_gset_dust
from ..frozen.solver_prep import build_solver


def dense_weights(sd, ne, nfreq):
    """The sparse heating weights (Iw, L1, L2; l-major, then u ascending,
    frequencies L1..L2 of each pair) as W[u, l, f]."""
    w = np.zeros((ne, ne, nfreq))
    a, b = sd.l1, sd.l2
    pairs = [(l, u) for l in range(ne - 1) for u in range(l + 1, ne)
             if b[l, u] >= a[l, u] >= 0]
    lens = np.asarray([b[l, u] - a[l, u] + 1 for l, u in pairs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for (l, u), s, n in zip(pairs, starts, lens):
        w[u, l, a[l, u]:a[l, u] + n] = sd.iw[s:s + n]
    return w


class Solver:
    """The solver arrays of every size on ``device``: weights with AF
    folded in [S, NE, NE, NF], TDOWN [S, NE], masked EA [S, NF, NE]."""

    def __init__(self, gset_path, freq, ne, device, dtype=torch.float64):
        dust = read_gset_dust(gset_path)
        sol = build_solver(dust, np.asarray(freq, np.float64), ne=ne)
        sk = np.asarray(sol.sk_abs, np.float64)
        kabs = sk.sum(0)
        nf = len(freq)
        w, td, ea = [], [], []
        for s, sd in enumerate(sol.sizes):
            with np.errstate(divide="ignore", invalid="ignore"):
                af = sk[s] / kabs / (float(sol.s_frac[s])
                                     * sol.grain_density)
            af = np.clip(np.nan_to_num(af, nan=1e-32), 1e-32, 1e100)
            w.append(dense_weights(sd, ne, nf) * af[None, None, :])
            td.append(np.asarray(sd.tdown, np.float64))
            e = np.asarray(sd.ea, np.float64).copy()
            for f in range(nf):
                e[f, :sd.ibeg[f]] = 0.0
            ea.append(e)
        self.ne, self.dtype = ne, dtype
        self.w = torch.as_tensor(np.stack(w), device=device).to(dtype)
        self.tdown = torch.as_tensor(np.stack(td), device=device).to(dtype)
        self.ea = torch.as_tensor(np.stack(ea), device=device).to(dtype)

    def emission(self, absorbed, block=128):
        """EMIT [CELLS, NF] (float64 host array) of absorbed [CELLS, NF]
        (the absorbed.data payload of those cells)."""
        ab = np.asarray(absorbed, np.float64).copy()
        ab[:, -1] = np.clip(ab[:, -1], 0.0, 0.2 * ab[:, -2])
        out = []
        dev = self.w.device
        for i0 in range(0, len(ab), block):
            a = torch.as_tensor(ab[i0:i0 + block], device=dev).to(self.dtype)
            tot = torch.zeros(a.shape, dtype=self.dtype, device=dev)
            for s in range(self.w.shape[0]):
                tot += self._size(s, a)
            out.append(tot.to(torch.float64).cpu().numpy())
        return np.concatenate(out)

    def _size(self, s, a):
        ne = self.ne
        h = torch.clamp_min(torch.einsum("ulf,cf->cul", self.w[s], a), 0.0)
        tri = torch.tril(torch.ones(ne, ne, dtype=torch.bool,
                                    device=a.device), -1)
        h = h * tri                      # only upward jumps u > l
        sfold = torch.flip(torch.cumsum(torch.flip(h, [1]), 1), [1])
        sfold[:, :ne - 1] -= h[:, ne - 1:ne]
        x = torch.zeros((a.shape[0], ne), dtype=self.dtype, device=a.device)
        x[:, 0] = 1.0
        for j in range(1, ne):
            xj = (sfold[:, j, :j] * x[:, :j]).sum(1) / (self.tdown[s, j] + 1e-30)
            x[:, j] = xj
            big = x.amax(1, keepdim=True)
            x = torch.where(big > 1e20, x / big, x)
        p = x / x.sum(1, keepdim=True)
        return p @ self.ea[s].T
