"""The cell-emission passes' packets a second: the cell passes' packets
over their seconds (phase 2's dust re-emission, one pass an iteration
after the first)."""

from benchmark.metrics._rates import pass_rate


def read(view):
    return pass_rate(view["runs"], "cell_passes")
