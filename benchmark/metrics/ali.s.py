"""Seconds of ALI's updates in the profiled run on process 0: the union
of its `ali.update` spans (the escape probabilities' division on the
host after each cell pass, and `alibeta`'s refinement)."""

from benchmark.metrics._program import union_of


def read(view):
    return union_of(view, "ali.update")
