"""Seconds of CUDA-graph capture in the profiled run on process 0: the
union of its `transport.capture` spans (each pool's march block captured
and instantiated). The reader of transport.capture_s.<kind>, one metric a
kind of cell."""

from benchmark.metrics._program import union_of


def read(view):
    return union_of(view, "transport.capture")
