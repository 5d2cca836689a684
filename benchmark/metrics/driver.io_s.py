"""Seconds a run in pipeline/driver.py's input and output stages: the
model read, the tally's readback and scaling, and the file writes
(timings["input"] and timings["outputs"] of every driver.run the verb
makes). The reader of driver.io_s.<kind>, one metric a kind of cell."""

from benchmark.metrics._rates import mean_timing


def read(view):
    return mean_timing(view["runs"], ["input", "outputs"])
