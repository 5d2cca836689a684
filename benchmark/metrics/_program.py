"""The program's own spans of the profiled run, for the readers of the
metrics that soc_tpu_torch's tracer (soc_tpu_torch/utils/trace.py) feeds.

The records are the profile's "program" entry where the harness puts one
there, else the records the tracer kept of the run that recorded itself
under torch.profiler (trace.profiled(): process 0's spans, and under
several processes every process's `dist.*` spans under "ranks"). They are
read only where the run's device was traced: on the CPU the harness's
profile has no device trace to read them beside. A program without the
tracer gives None, and so does every reader."""


def program(view):
    """(the tracer module, the profiled run's records), or None."""
    p = view["profile"]
    if p is None or p["busy_ns"] <= 0:
        return None
    try:
        from soc_tpu_torch.utils import trace
    except ImportError:
        return None
    rec = p.get("program") or trace.profiled()
    if rec is None:
        return None
    return trace, rec


def union_of(view, name):
    """Seconds of the union of process 0's spans ``name`` in the profiled
    run, or None where it has none."""
    got = program(view)
    if got is None:
        return None
    trace, rec = got
    if not any(r["name"] == name for r in rec["spans"]):
        return None
    return trace.union_s(rec["spans"], name)
