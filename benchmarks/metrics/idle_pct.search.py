"""Share of the traced window with no operation running on the device,
from the profiler's trace (the union of device-op intervals)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
