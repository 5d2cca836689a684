"""Share of the refill bodies on process 0 of the profiled run whose march
block ran as the one CUDA kernel (csrc/march.cu): 100 fused / (fused +
eager), from the counters `transport.blocks_fused` and
`transport.blocks_eager` (transport/propagate.py PoolRun.body). None where
the program counts neither."""

from benchmark.metrics._program import program


def read(view):
    got = program(view)
    if got is None:
        return None
    counters = got[1].get("counters") or {}
    fused = counters.get("transport.blocks_fused", 0)
    eager = counters.get("transport.blocks_eager", 0)
    if fused + eager == 0:
        return None
    return 100.0 * fused / (fused + eager)
