"""Operation and byte counts of the layers' work, computed from shapes.

a2e_work is a frozen copy of chip_smoke.py's a2e_work at commit 6496b8b.
"""


def a2e_work(cells, nsize, ne, nf, clamp=False, align=False):
    """(float32 operations, bytes) of one A2E solve over all sizes: the
    function's work, counted once (an FMA counts 2, an add 1; the divides
    and the rescale, O(NE) a cell and size, are left out), whatever loops
    a kernel runs. Pre-folded solve, per cell and size: the bottom row
    NF*NE FMAs; substitution rows j = 1 .. NE-2, (NF + 1) FMAs and 1
    subtraction for each l < j; the last row NE-1 FMAs; the emission NF*NE
    FMAs and NE adds. Exact (clamp) solve: (NF + 1) FMAs for each heating
    entry below the diagonal, NE(NE-1)/2 of them, and (NE-2)(NE-1)/2 adds
    of suffix sums, then the same emission. Bytes: each input read once
    and each output written once."""
    tri = (ne - 2) * (ne - 1) // 2
    if clamp:
        fma = (nf + 1) * ne * (ne - 1) // 2 + nf * ne
    else:
        fma = nf * ne + (nf + 1) * tri + (ne - 1) + nf * ne
    flops = cells * nsize * (2 * fma + tri + ne)
    words = (cells * nf + nsize * nf * ne * ne + nsize * ne + nsize * nf * ne
             + cells * nf)
    if align:
        words += nsize * cells + cells * nf
    return flops, 4 * words
