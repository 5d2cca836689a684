"""Seconds of the driver's readback in the profiled run on process 0: the
union of its `driver.readback` spans (the absorption tally's copies to
the host and their scaling, in the outputs stage). The reader of
driver.readback_s.<kind>, one metric a kind of cell."""

from benchmark.metrics._program import union_of


def read(view):
    return union_of(view, "driver.readback")
