"""Seconds of the map stage a run (timings["maps"]: the renders, their
readbacks and the map files)."""

from benchmark.metrics._rates import mean_timing


def read(view):
    return mean_timing(view["runs"], ["maps"])
