"""The program's tracer: spans and counters kept in memory, on the host
clock that torch.profiler's device events are compared on
(time.time_ns).

    from soc_tpu_torch.utils import trace
    trace.start()
    with trace.span("driver.solve", into=timings, key="solve"):
        ...
    trace.count("dist.collectives")
    records = trace.stop()          # {"spans": [...], "counters": {...}}

A span's record holds its name, start_ns, end_ns, its own id, the id of
the span open around it on the same thread (its parent, or None) and its
attrs; the records come in the order the spans opened. Counters are
summed a name. Tracing is off by default: a span then costs a flag check,
and one with ``into`` its clock pair too, since it writes its seconds into
``into[key]`` on or off (RunResult.timings is filled so). No span or
counter waits on the device or reads a value back from it: a span meant
to hold a stage's kernels ends where the stage already reads its result
back, so a traced run issues the same work as an untraced one.

A whole run (run(): driver.run, pipeline.run) records itself where the
tracer is off and torch.profiler is recording: its spans then lie beside
the profile's device events, and profiled() returns them once the run has
ended. Over several processes (parallel/dist.py) every process records
its run so; each process but 0 posts its `dist.*` spans to the process
group's store as its run ends, a write that waits on no other process,
and profiled() on process 0 adds them under "ranks".
"""

import contextlib
import itertools
import threading
import time


class _State:
    """The tracer's state: one a process."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.profiled = None        # the records of the last followed run
        self.follows = 0            # runs followed so far


_on = False
_state = _State()


class _Off:
    """A span while tracing is off: nothing recorded; with ``into`` its
    seconds are still written into ``into[key]``."""

    __slots__ = ("into", "key", "t0")

    def __init__(self, into=None, key=None):
        self.into, self.key = into, key

    def __enter__(self):
        if self.into is not None:
            self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            self.into[self.key] = (time.time_ns() - self.t0) / 1e9
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        """Attributes known only inside the span (none while off)."""


_OFF = _Off()


class _Span:
    """A recorded span; true, so that ``if sp:`` guards work done only
    for its attributes."""

    __slots__ = ("rec", "into", "key", "stack")

    def __init__(self, name, into, key, attrs):
        self.rec = dict(name=name, start_ns=0, end_ns=0,
                        id=next(_state.ids), parent=None, attrs=attrs)
        self.into, self.key = into, key

    def __enter__(self):
        stack = getattr(_state.local, "stack", None)
        if stack is None:
            stack = _state.local.stack = []
        self.stack = stack
        self.rec["parent"] = stack[-1] if stack else None
        stack.append(self.rec["id"])
        _state.spans.append(self.rec)
        self.rec["start_ns"] = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rec["end_ns"] = end
        self.stack.pop()
        if self.into is not None:
            self.into[self.key] = (end - self.rec["start_ns"]) / 1e9
        return False

    def __bool__(self):
        return True

    def set(self, **attrs):
        """Attributes known only inside the span."""
        self.rec["attrs"].update(attrs)


def span(name, into=None, key=None, **attrs):
    """A context manager: the span ``name`` (``<layer>.<stage>``) with
    ``attrs``; ``into[key]``, where given, receives its seconds whether
    tracing is on or off."""
    if _on:
        return _Span(name, into, key, attrs)
    return _OFF if into is None else _Off(into, key)


def count(name, n=1):
    """Adds ``n`` to the counter ``name``; returns its new total, or None
    while tracing is off."""
    if not _on:
        return None
    total = _state.counters.get(name, 0) + n
    _state.counters[name] = total
    return total


def enabled():
    return _on


def start():
    """Tracing on."""
    global _on
    _on = True


def stop():
    """Tracing off; returns {"spans": [...], "counters": {...}} recorded
    since start() and clears them."""
    global _on
    _on = False
    out = dict(spans=_state.spans, counters=_state.counters)
    _state.spans, _state.counters = [], {}
    return out


def _profiler_recording():
    import torch
    return torch.autograd._profiler_enabled()


@contextlib.contextmanager
def run(name, into=None, key=None, **attrs):
    """span() around a whole run. Where tracing is off and torch.profiler
    is recording, the tracer is on for the run, and its records are kept
    for profiled() (the module's docstring)."""
    follow = not _on and _profiler_recording()
    if follow:
        start()
    try:
        with span(name, into, key, **attrs) as sp:
            yield sp
    finally:
        if follow:
            _keep(stop())


def _store_key(follow, rank):
    return "soc_tpu_torch.trace.%d.%d" % (follow, rank)


def _keep(records):
    from ..parallel import dist
    _state.follows += 1
    records["ranks"] = {}
    if dist.process_count() > 1:
        rank = dist.process_index()
        mine = [r for r in records["spans"]
                if r["name"].startswith("dist.")]
        if rank == 0:
            records["ranks"][0] = mine
        else:
            dist.post(_store_key(_state.follows, rank), mine)
    _state.profiled = records


def profiled():
    """The records of the last run that recorded itself under
    torch.profiler (run()), or None: {"spans", "counters", "ranks"}, where
    "ranks" maps each process of several to its `dist.*` spans (process 0
    fetches the others' from the store, where they have posted them)."""
    rec = _state.profiled
    if rec is None or not rec["ranks"]:
        return rec
    from ..parallel import dist
    for rank in range(1, dist.process_count()):
        if rank not in rec["ranks"]:
            got = dist.fetch(_store_key(_state.follows, rank))
            if got is not None:
                rec["ranks"][rank] = got
    return rec


# ------------------------------------------------ arithmetic on records

def union_s(records, name):
    """Seconds of the union of the spans ``name``."""
    iv = sorted((r["start_ns"], r["end_ns"]) for r in records
                if r["name"] == name)
    total, end = 0, None
    for s, e in iv:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def self_s(records, name, child):
    """Seconds of the spans ``name`` not covered by their children
    ``child``: a layer's self time against one kind of child."""
    total = 0
    for r in records:
        if r["name"] != name:
            continue
        inner = [c for c in records
                 if c["name"] == child and c["parent"] == r["id"]]
        total += (r["end_ns"] - r["start_ns"]) - 1e9 * union_s(inner, child)
    return total / 1e9


def collective_waits(by_rank):
    """Seconds process 0 waited for the others at the collectives:
    ``by_rank`` maps each process to its `dist.*` spans (attrs ``seq``,
    the process's collective count). For each ``seq`` the latest arrival
    (span start) over every process, less process 0's, clipped to
    [0, process 0's span length], summed. The processes share the host's
    real-time clock."""
    arrive = {}
    for spans in by_rank.values():
        for r in spans:
            seq = r["attrs"].get("seq")
            arrive[seq] = max(arrive.get(seq, r["start_ns"]), r["start_ns"])
    total = 0
    for r in by_rank.get(0, []):
        own = r["end_ns"] - r["start_ns"]
        total += min(max(arrive[r["attrs"].get("seq")] - r["start_ns"], 0),
                     own)
    return total / 1e9
