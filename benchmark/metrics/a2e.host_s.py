"""Host seconds of the A2E stage in the profiled run: the `a2e.stage`
span less the part its `a2e.kernel` child covers (the launch up to the
host copy of its result), so the stage's NumPy work, the stacks' builds
and the upload."""

from benchmark.metrics._program import program


def read(view):
    got = program(view)
    if got is None:
        return None
    trace, rec = got
    if not any(r["name"] == "a2e.stage" for r in rec["spans"]):
        return None
    return trace.self_s(rec["spans"], "a2e.stage", "a2e.kernel")
