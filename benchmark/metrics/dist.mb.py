"""Megabytes process 0 moved through the collectives of the profiled run:
the ``bytes`` of its `dist.*` spans (the payloads' tensors and arrays),
summed, over 1e6."""

from benchmark.metrics._program import program


def read(view):
    got = program(view)
    if got is None:
        return None
    spans = [r for r in got[1]["spans"] if r["name"].startswith("dist.")]
    if not spans:
        return None
    return sum(r["attrs"].get("bytes", 0) for r in spans) / 1e6
