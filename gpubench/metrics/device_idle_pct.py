"""device_idle_pct: the share of the profiled stretches' wall (first
dispatch's start to last dispatch's end, the profiler's clock) in which
no operation ran on the device."""


def read(run):
    r = run.reading
    if r is None or r.window_ns == 0:
        return None
    return 100.0 * (1.0 - r.busy_ns / r.window_ns)
