"""Seconds process 0 waited for the other processes at the collectives of
the profiled run: for each collective (its `dist.*` spans' ``seq``) the
latest arrival over every process less process 0's, clipped to [0,
process 0's span], summed (trace.collective_waits). Read only where
every process's spans are there."""

from benchmark.metrics._program import program


def read(view):
    got = program(view)
    if got is None:
        return None
    trace, rec = got
    ranks = rec.get("ranks") or {}
    if len(ranks) < max(2, int(view["traffic"].get("processes", 1))):
        return None
    return trace.collective_waits(ranks)
