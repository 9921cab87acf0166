"""device_idle_share: the share of the profiled frames' host window (which
ends in a synchronize) in which the card ran no kernel and no copy, in
percent: 100 (1 - the union of the device's intervals / the window)."""

from reference import trace_math


def read(t):
    if not t.profile or not t.profile["device"]:
        return None
    busy = trace_math.union_ns([(a, b) for _, a, b in t.profile["device"]])
    return 100.0 * trace_math.idle_share(busy, t.profile["window_ns"])
