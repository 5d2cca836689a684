"""Seconds of the file writes in the profiled run on process 0: the union
of its `io.write` spans (absorbed.data, the temperatures, emitted.data,
the map files). The reader of driver.write_s.<kind>, one metric a kind of
cell."""

from benchmark.metrics._program import union_of


def read(view):
    return union_of(view, "io.write")
