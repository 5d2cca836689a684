"""What the three gather/scatter probes share: the index steps exactly as
JAX computes them, best-of-3 timing with CUDA events, the report line, and
the runner that times every case's kernel beside its plain version and
holds the one against the other.

The LCG. The probes reshuffle indices with
``(j * 1103515245 + 12345 + i) % M`` on int32 values: the product and the
sums wrap at 32 bits, and ``%`` is floored. Here the step is computed in
int64, folded back to the signed 32-bit value the wrap gives, and reduced
with ``torch.remainder`` (floored, never ``fmod``).
"""

import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

LCG_A = 1103515245
LCG_C = 12345

# tolerances of a kernel against its plain version on the card
EXACT = "exact"          # the same sequence of float32 adds: bit for bit
REL = "rel"              # max |k - p| / |p| elementwise, p != 0
REL_OF_MAX = "rel_of_max"  # max |k - p| / max |p|: scatters and atomics
LIMITS = {EXACT: 0.0, REL: 1e-6, REL_OF_MAX: 1e-5}


def wrap32(x):
    """int64 tensor -> the int64 value that int32 two's-complement
    arithmetic would hold."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def lcg(j, i, mod):
    """One index step ((j * A + C + i) mod 2^32 as int32) floored-mod
    ``mod``, for an int32 tensor j and an int step i; returns int32."""
    x = wrap32(j.to(torch.int64) * LCG_A + (LCG_C + int(i)))
    return torch.remainder(x, mod).to(torch.int32)


def require_cuda():
    """The CUDA device the probes measure, its name printed; without one
    they stop, non-zero."""
    if not torch.cuda.is_available():
        sys.exit("the probes need a CUDA device "
                 "(torch.cuda.is_available() is False)")
    device = torch.device("cuda", 0)
    print("# %s" % torch.cuda.get_device_name(device), flush=True)
    return device


def exit_code(results):
    """0 when every row passed its checks; else names the rows, 1."""
    bad = [r.name for r in results if not r.ok]
    if bad:
        print("rows that fail their checks: %s" % ", ".join(bad),
              flush=True)
        return 1
    return 0


def timeit(fn, reps=3):
    """(best seconds of ``reps`` timed calls after one warm-up call, the
    last output), each call timed alone with CUDA events."""
    out = fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / 1e3)
    return best, out


def device_seconds(fn, reps=3):
    """Device time per call of what ``fn`` launches (kernels, fills and
    copies: the union of their intervals under torch.profiler over
    ``reps`` calls), or None when the profiler saw no device activity. A
    call's event-timed seconds also hold the host's launch overhead, which
    outweighs the probes' shortest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from ..profile_transport import busy_seconds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, _ = busy_seconds(prof.events())
    return None if busy is None else busy / reps


def _ms(seconds):
    return "not measured" if seconds is None else "%.4f ms" % (1e3 * seconds)


def report(name, seconds, elems):
    print(f"{name}: {seconds*1e3:.3f} ms -> {elems/seconds/1e6:.1f} Melem/s",
          flush=True)


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def abs_error(got, ref):
    """max |got - ref| over all leaves."""
    return max(float(torch.abs(g.double() - r.double()).max())
               for g, r in zip(_leaves(got), _leaves(ref), strict=True))


def error(got, ref, tol):
    """The error measure of ``tol`` between two outputs (tuples compared
    leaf by leaf, the largest error returned)."""
    worst = 0.0
    for g, r in zip(_leaves(got), _leaves(ref), strict=True):
        if g.shape != r.shape or g.dtype != r.dtype:
            return float("inf")
        if tol == EXACT:
            e = 0.0 if torch.equal(g, r) else float("inf")
        else:
            g, r = g.double(), r.double()
            d = torch.abs(g - r)
            if tol == REL:
                e = float((d / torch.abs(r).clamp_min(1e-30)).max())
            else:
                e = float(d.max() / max(float(torch.abs(r).max()), 1e-30))
        worst = max(worst, e)
    return worst


@dataclass
class Case:
    """One probe row: ``fn(*args, ops=...)`` runs it through the kernels
    (``ops=kernels.KERNELS``) or their plain versions (``ops=kernels.PLAIN``);
    ``kernel`` names the CUDA kernel it launches (a key of
    ``kernels.launches``). A baseline (``kernel=None``, the scripts' XLA
    lines) is plain torch alone, ``fn(*args)``."""
    name: str
    fn: Callable
    args: tuple
    elems: int
    tol: str = EXACT
    kernel: Optional[str] = None


@dataclass
class Result:
    name: str
    kernel: Optional[str]
    seconds: Optional[float]        # the kernel's, None for a baseline
    plain_seconds: float
    err: Optional[float]            # kernel against plain in ``tol``'s
    abs_err: Optional[float]        # measure, and as max |k - p|
    tol: str
    device_seconds: Optional[float] = None      # per call, see
    plain_device_seconds: Optional[float] = None  # device_seconds()
    out: object = None              # the kernel's output (or the plain's)
    checks: list = field(default_factory=list)  # (label, err, limit)

    @property
    def ok(self):
        return ((self.err is None or self.err <= LIMITS[self.tol])
                and all(e <= lim for _, e, lim in self.checks))


def run_cases(cases, kernels, plain):
    """Times each case's kernel and plain version (best of 3 calls each,
    then their device time per call), prints the report lines, and
    returns the Results with the kernel-vs-plain errors. A build or launch
    error propagates."""
    results = []
    for case in cases:
        if case.kernel is None:
            ps, pout = timeit(lambda: case.fn(*case.args))
            report("plain " + case.name, ps, case.elems)
            results.append(Result(case.name, None, None, ps, None, None,
                                  case.tol, out=pout))
            continue
        ps, pout = timeit(lambda: case.fn(*case.args, ops=plain))
        ks, kout = timeit(lambda: case.fn(*case.args, ops=kernels))
        err = error(kout, pout, case.tol)
        kd = device_seconds(lambda: case.fn(*case.args, ops=kernels))
        pd = device_seconds(lambda: case.fn(*case.args, ops=plain))
        report("cuda " + case.name, ks, case.elems)
        report("plain " + case.name, ps, case.elems)
        print(f"  {case.name}: device time per call, kernel {_ms(kd)}, "
              f"plain {_ms(pd)}; kernel against plain, {case.tol} error "
              f"{err:.3e} (limit {LIMITS[case.tol]:.0e})", flush=True)
        results.append(Result(case.name, case.kernel, ks, ps, err,
                              abs_error(kout, pout), case.tol, out=kout,
                              device_seconds=kd, plain_device_seconds=pd))
    return results
