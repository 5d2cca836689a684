"""Seconds of the point sources' host tables in the profiled run on
process 0: the union of its `sources.ps_tables` spans (the PS_METHOD's
NumPy tables, driver.point_source_tables)."""

from benchmark.metrics._program import union_of


def read(view):
    return union_of(view, "sources.ps_tables")
