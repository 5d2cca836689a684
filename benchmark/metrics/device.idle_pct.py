"""The device's idle share of the profiled run: 100 (1 - busy / wall),
busy the union of the device's kernel, copy and set intervals in the
torch.profiler trace of one whole run, wall that run's host-clock span.
The reader of device.idle_pct.<kind>, one metric a kind of cell."""


def read(view):
    p = view["profile"]
    if p is None or p["window_ns"] <= 0 or p["busy_ns"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_ns"] / p["window_ns"])
