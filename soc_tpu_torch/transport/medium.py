"""Device-resident optical properties of the medium (port of
soc_tpu.transport.medium): the whole frequency axis lives on the device,
and packets carry an ``ifreq`` tag to gather their own cross sections."""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Medium:
    """Single effective dust population (summed over species).

    abs_gl, sca_gl : [NFREQ] optical depth / unit density / GL
    csc            : [NFREQ, BINS] inverse-CDF cos-theta lookup
    dsc            : [NFREQ, BINS] discrete phase function
    tw             : [NFREQ] trapezoid weight FREQ*0.5*dF
    """

    abs_gl: torch.Tensor
    sca_gl: torch.Tensor
    csc: torch.Tensor
    dsc: torch.Tensor
    tw: torch.Tensor
    nfreq: int
    bins: int


def trapezoid_weights(freq):
    """FREQ * half-interval trapezoid weights over the frequency grid."""
    freq = np.asarray(freq, np.float64)
    n = len(freq)
    tw = np.zeros(n)
    if n == 1:
        tw[0] = freq[0]
        return tw.astype(np.float32)
    tw[0] = freq[0] * 0.5 * (freq[1] - freq[0])
    tw[-1] = freq[-1] * 0.5 * (freq[-1] - freq[-2])
    tw[1:-1] = freq[1:-1] * 0.5 * (freq[2:] - freq[:-2])
    return tw.astype(np.float32)


def medium_from_numpy(abs_gl, sca_gl, csc, dsc, tw, device):
    """Medium from host arrays, placed on ``device``."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    csc = np.asarray(csc, np.float32)
    return Medium(abs_gl=t(abs_gl), sca_gl=t(sca_gl), csc=t(csc),
                  dsc=t(dsc), tw=t(tw), nfreq=int(len(abs_gl)),
                  bins=int(csc.shape[-1]))


def medium_from_optics(optics_list, dsc, csc, device, freq=None):
    """Build a Medium by summing cross sections over dust populations
    (the constant-abundance case)."""
    freq = np.asarray(optics_list[0].freq if freq is None else freq)
    abs_gl = np.zeros(len(freq), np.float32)
    sca_gl = np.zeros(len(freq), np.float32)
    for opt in optics_list:
        abs_gl += opt.abs_gl
        sca_gl += opt.sca_gl
    return medium_from_numpy(abs_gl, sca_gl, csc, dsc,
                             trapezoid_weights(freq), device)
