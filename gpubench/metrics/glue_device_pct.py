"""glue_device_pct: the device time of the operations launched outside
K1's entries (the gathers, copies, scans and concatenations around K1)
over all device time, in the profiled stretches."""


def read(run):
    r = run.reading
    if r is None or r.device_ns == 0:
        return None
    return 100.0 * (r.device_ns - r.k1_ns) / r.device_ns
