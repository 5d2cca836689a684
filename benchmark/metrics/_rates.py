"""Arithmetic the per-layer readers share."""


def pass_rate(runs, key, source=None):
    """Packets over seconds of the runs' passes (source passes of one
    source, or cell passes), None when there are none."""
    passes = [p for r in runs for p in r[key]
              if source is None or p.get("source") == source]
    sec = sum(p["seconds"] for p in passes)
    if not passes or sec <= 0:
        return None
    return sum(p["packets"] for p in passes) / sec


def mean_timing(runs, names):
    """The runs' mean of the summed stage timings ``names``."""
    vals = [sum(t.get(n, 0.0) for t in r["timings"] for n in names)
            for r in runs]
    return sum(vals) / len(vals) if vals else None


def background_rate(view):
    """Background packets a second of the transport: the background
    passes' packets over their seconds (each pass ends after the host has
    read its injected totals)."""
    return pass_rate(view["runs"], "source_passes", "bg")
