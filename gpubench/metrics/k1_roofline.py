"""k1_roofline: the sum of each K1 entry call's bound (`bounds.py`,
from that call's arguments, reckoned in a second pass over the profiled
dispatches) over the device time of everything launched inside those
calls, in the profiled stretches."""


def read(run):
    r = run.reading
    if r is None or r.k1_ns == 0 or not run.bounds:
        return None
    return 100.0 * sum(b.ms for b in run.bounds) * 1e6 / r.k1_ns
