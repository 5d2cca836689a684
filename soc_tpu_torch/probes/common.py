"""What the three gather/scatter probes share: the index steps exactly as
JAX computes them, best-of-3 timing with CUDA events, the report line, and
the runner that times every case's kernel beside its plain version (and,
where one PyTorch call computes the same function, beside that call) and
holds the one against the other, with the least time the card could take
for the case.

The LCG. The probes reshuffle indices with
``(j * 1103515245 + 12345 + i) % M`` on int32 values: the product and the
sums wrap at 32 bits, and ``%`` is floored. Here the step is computed in
int64, folded back to the signed 32-bit value the wrap gives, and reduced
with ``torch.remainder`` (floored, never ``fmod``).
"""

import sys
import time
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

# the published peaks of one H100 SXM (NVIDIA's data sheet, dense): the
# least time of a case is the larger of its bytes over HBM_BYTES_PER_S and
# its float32 operations over FP32_FLOPS (an FMA counts 2, an add 1)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def bound_seconds(nbytes, flops):
    """(least seconds, "bytes" or "operations"): the larger of the two."""
    tb, to = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (tb, "bytes") if tb >= to else (to, "operations")


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


def device_seconds(fn, reps=3, pause=0.02):
    """(best, spread, best call) of the device time of ``reps`` calls of
    ``fn``, or (None, None, None) when the profiler saw fewer intervals
    than calls in each of three tries. The calls run in one torch.profiler
    session, ``pause`` seconds apart; the device intervals (kernels, fills
    and copies) are cut into calls at the reps - 1 widest gaps between
    them, each call's time is the union of its intervals (the gaps between
    them left out; ``span`` puts them in), and only the calls with the
    most intervals count. The best call is its list of profiler events, in
    order of start. A call's event-timed seconds also hold the host's
    launch overhead, which outweighs the probes' shortest kernels; random
    gathers move by up to ~40% from call to call, hence the best of
    several and its spread."""
    from torch.profiler import ProfilerActivity, profile

    from ..profile_transport import busy_seconds
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for r in range(reps):
                if r:
                    time.sleep(pause)
                fn()
                torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type.name == "CUDA"),
                        key=lambda e: e.time_range.start)
        if len(events) >= reps:
            break
    else:
        return None, None, None
    # gap before event i: its start less the latest end before it
    gaps, end = [], events[0].time_range.end
    for i, e in enumerate(events[1:], 1):
        gaps.append((e.time_range.start - end, i))
        end = max(end, e.time_range.end)
    cuts = sorted(i for _, i in sorted(gaps)[len(gaps) - (reps - 1):])
    calls = [events[a:b] for a, b in zip([0] + cuts, cuts + [len(events)])]
    # every call launches the same work: a call with fewer intervals than
    # the fullest lost some to the profiler and is left out
    full = max(len(c) for c in calls)
    timed = sorted(((busy_seconds(c)[0], c) for c in calls
                    if len(c) == full), key=lambda t: t[0])
    return timed[0][0], timed[-1][0] - timed[0][0], timed[0][1]


def span(call):
    """Seconds from a call's first device interval's start to its last
    end (see device_seconds), the gaps between intervals included."""
    return (max(e.time_range.end for e in call)
            - call[0].time_range.start) / 1e6


def intervals(call):
    """[(name, seconds)] of a call's device intervals (see
    device_seconds), each kernel's name without its return type, anonymous
    namespace, template and function arguments."""
    def short(name):
        name = name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].strip()
        return name[5:] if name.startswith("void ") else name or "?"
    return [(short(e.name), (e.time_range.end - e.time_range.start) / 1e6)
            for e in call]


def _ms(seconds, spread=None):
    if seconds is None:
        return "not measured"
    if spread is None:
        return "%.4f ms" % (1e3 * seconds)
    return "%.4f ms (spread %.4f)" % (1e3 * seconds, 1e3 * spread)


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
    lines) is plain torch alone, ``fn(*args)``.

    elems: the adds the row does (its float32 operations for the bound);
    nbytes: the bytes it must move, by default every tensor argument read
    once and the output written once; library: where one PyTorch call
    computes the same function, library(*args) builds what that call takes
    from the arguments (untimed) and returns the call, a callable of no
    arguments; reference: the same for a reference of several PyTorch calls
    (RG's), timed and checked as the library call is but reported under
    ``reference_label``, never as the library call."""
    name: str
    fn: Callable
    args: tuple
    elems: int
    tol: str = EXACT
    kernel: Optional[str] = None
    nbytes: Optional[int] = None
    library: Optional[Callable] = None
    reference: Optional[Callable] = None
    reference_label: str = ""


@dataclass
class Result:
    name: str
    kernel: Optional[str]
    seconds: Optional[float]        # the kernel's, None for a baseline
    plain_seconds: float
    err: Optional[float]            # kernel against plain in ``tol``'s
    abs_err: Optional[float]        # measure, and as max |k - p|
    tol: str
    device_seconds: Optional[float] = None      # best per call, see
    plain_device_seconds: Optional[float] = None  # device_seconds()
    device_spread: Optional[float] = None       # the kernel's, max - min
    out: object = None              # the kernel's output (or the plain's)
    checks: list = field(default_factory=list)  # (label, err, limit)
    bound_seconds: Optional[float] = None   # least time on the card
    bound_by: Optional[str] = None          # "bytes" or "operations"
    library_seconds: Optional[float] = None          # the library call's
    library_device_seconds: Optional[float] = None   # call and device time
    library_device_spread: Optional[float] = None
    elems: Optional[int] = None             # the case's adds (Case.elems)
    reference_device_seconds: Optional[float] = None    # Case.reference's
    reference_device_spread: Optional[float] = None
    device_span: Optional[float] = None     # span() of the best call of
    library_span: Optional[float] = None    # the kernel, the library call
    reference_span: Optional[float] = None  # and Case.reference
    device_intervals: Optional[list] = None  # intervals() of the kernel's

    @property
    def ok(self):
        return ((self.err is None or self.err <= LIMITS[self.tol])
                and all(e <= lim for _, e, lim in self.checks))


def _nbytes(case, out):
    if case.nbytes is not None:
        return case.nbytes
    return sum(a.numel() * a.element_size() for a in case.args
               if torch.is_tensor(a)) \
        + sum(o.numel() * o.element_size() for o in _leaves(out))


def _library(case, ref, build, label):
    """Times a library call or reference of the case (``build`` is
    Case.library or Case.reference; call time, device time) and holds its
    output to the plain version's with the case's tolerance; returns the
    (seconds, device seconds, device spread, span of the best call,
    check)."""
    call = build(*case.args)
    ls, lout = timeit(call)
    ld, lspread, lcall = device_seconds(call)
    err = error(lout, ref, REL_OF_MAX if case.tol == EXACT else case.tol)
    print(f"  {case.name}: {label} {ls * 1e3:.4f} ms, device time "
          f"{_ms(ld, lspread)}; against plain {err:.3e}", flush=True)
    return ls, ld, lspread, None if lcall is None else span(lcall), (
        label + " against plain", err,
        LIMITS[REL_OF_MAX if case.tol == EXACT else case.tol])


def run_cases(cases, kernels, plain):
    """Times each case's kernel and plain version (best of 3 calls each,
    then the best of 3 device times per call), and its library call where
    it has one, prints the report lines, and returns the Results with the
    kernel-vs-plain errors and the case's least time on the card. A build
    or launch error propagates."""
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
        kd, kspread, kcall = device_seconds(lambda: case.fn(*case.args,
                                                             ops=kernels))
        pd, _, _ = device_seconds(lambda: case.fn(*case.args, ops=plain))
        report("cuda " + case.name, ks, case.elems)
        report("plain " + case.name, ps, case.elems)
        bound, by = bound_seconds(_nbytes(case, kout), case.elems)
        print(f"  {case.name}: device time per call (best of 3), kernel "
              f"{_ms(kd, kspread)}, plain {_ms(pd)}, bound {bound * 1e3:.4f} "
              f"ms ({by}); kernel "
              f"against plain, {case.tol} error {err:.3e} (limit "
              f"{LIMITS[case.tol]:.0e})", flush=True)
        res = Result(case.name, case.kernel, ks, ps, err,
                     abs_error(kout, pout), case.tol, out=kout,
                     device_seconds=kd, plain_device_seconds=pd,
                     device_spread=kspread, bound_seconds=bound, bound_by=by,
                     elems=case.elems)
        if kcall is not None:
            res.device_span, res.device_intervals = span(kcall), \
                intervals(kcall)
        if case.library is not None:
            (res.library_seconds, res.library_device_seconds,
             res.library_device_spread, res.library_span,
             check) = _library(
                 case, pout, case.library, "library call")
            res.checks.append(check)
        if case.reference is not None:
            (_, res.reference_device_seconds, res.reference_device_spread,
             res.reference_span, check) = _library(
                 case, pout, case.reference, case.reference_label)
            res.checks.append(check)
        results.append(res)
    return results
