"""Host seconds a run in the process group's collectives on process 0:
the union of the harness's spans around parallel/dist.py's barrier,
gather_objects, share, broadcast and move in the profiled run (waits for
the other processes included)."""

from benchmark.harness import union_ns


def read(view):
    p = view["profile"]
    if p is None:
        return None
    spans = p["spans"].of("collective")
    if not spans:
        return None
    return union_ns(spans)[0] / 1e9
