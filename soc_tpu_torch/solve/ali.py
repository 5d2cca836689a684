"""ALI escape-probability refinement: beta averaged over the emission
spectrum as a function of (T, tau).

The port's own copy of ``soc_tpu.solve.ali``, the same code: the port
imports nothing of soc_tpu.

Reimplements the reference's beta-vs-(T, tau) interpolation table
(ASOC_aux.py:1446-1502 calculate_beta_vs_tau_T): the monochromatic escape
probability is the two-exponential fit

    beta(tau) = A exp(-B tau) + (1-A) exp(-C tau),
    [A, B, C] = [0.41960922, 0.11793479, 0.66852746]

and the effective beta is its Planck-weighted average over the dust
emission spectrum, beta_eff(T, tau_ref) = Int[beta(tau_f) k_f B_f(T)] /
Int[k_f B_f(T)], with tau_f = tau_ref * k_f / k_last. The reference builds
a RectBivariateSpline on a 59x91 (T, tau) grid; here the table is a plain
bilinear lookup in (log T, log tau).

The reference constructs the interpolator whenever WITH_ALI is set
(ASOC.py:213-219) but ships the per-cell temperature-update refinement
disabled (`if (0):`, ASOC.py:2063-2072); here the same refinement is an
opt-in (`alibeta` ini keyword).
"""

import numpy as np

from ..constants import planck_intensity

_ABC = (0.41960922, 0.11793479, 0.66852746)


def escape_probability(tau):
    """Two-exponential fit of the escape probability (ASOC_aux.py:1446)."""
    a, b, c = _ABC
    tau = np.asarray(tau, np.float64)
    return a * np.exp(-b * tau) + (1.0 - a) * np.exp(-c * tau)


def beta_table(freq, kabs, nt=59, ntau=91):
    """(T grid, tau grid, BETA[nt, ntau]) -- the reference's table.

    kabs : [NFREQ] absorption cross sections (any normalization; only the
    ratio k_f / k_last enters).
    """
    freq = np.asarray(freq, np.float64)
    kabs = np.asarray(kabs, np.float64)
    tgrid = np.logspace(np.log10(7.0), np.log10(1600.0), nt)
    taugrid = np.logspace(-2, 2.01, ntau) - 0.01
    # tau in every channel when the LAST channel has depth tau_ref
    ratio = kabs / max(kabs[-1], 1e-300)
    tau_f = taugrid[:, None] * ratio[None, :]            # [NTAU, NFREQ]
    beta_f = escape_probability(tau_f)                   # [NTAU, NFREQ]
    bnu = planck_intensity(freq[None, :], tgrid[:, None])  # [NT, NFREQ]
    w = kabs[None, :] * bnu
    num = np.trapezoid(beta_f[None, :, :] * w[:, None, :], freq, axis=2)
    den = np.trapezoid(w, freq, axis=1)
    beta = num / np.maximum(den[:, None], 1e-300)        # [NT, NTAU]
    return tgrid, taugrid, beta.astype(np.float32)


def beta_lookup(table, t, tau):
    """Bilinear interpolation of beta_table output at (t, tau) arrays."""
    tgrid, taugrid, beta = table
    it = np.clip(np.searchsorted(tgrid, t) - 1, 0, len(tgrid) - 2)
    jt = np.clip(np.searchsorted(taugrid, tau) - 1, 0, len(taugrid) - 2)
    wt = np.clip((t - tgrid[it]) / (tgrid[it + 1] - tgrid[it]), 0.0, 1.0)
    wj = np.clip((tau - taugrid[jt]) / (taugrid[jt + 1] - taugrid[jt]),
                 0.0, 1.0)
    return ((1 - wt) * (1 - wj) * beta[it, jt]
            + wt * (1 - wj) * beta[it + 1, jt]
            + (1 - wt) * wj * beta[it, jt + 1]
            + wt * wj * beta[it + 1, jt + 1])


def refine_beta(beta0, t_new, freq, kabs, dens, t_old=None, table=None):
    """Temperature-consistency correction of per-cell escape probabilities.

    Applies the reference's (disabled) update beta *= beta(T_new, tau) /
    beta(T_old, tau) with tau = k_last * n_cell (ASOC.py:2063-2072): after
    a temperature update, hotter cells have lower effective escape
    probability, which feeds back into the next E->T lookup.
    """
    if table is None:
        table = beta_table(freq, kabs)
    if t_old is None:
        t_old = t_new
    tau = np.asarray(kabs)[-1] * np.maximum(np.asarray(dens), 0.0)
    corr = beta_lookup(table, np.asarray(t_new), tau) \
        / np.maximum(beta_lookup(table, np.asarray(t_old), tau), 1e-6)
    return np.clip(np.asarray(beta0) * corr, 1e-2, 1.0).astype(np.float32)
