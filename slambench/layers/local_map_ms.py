"""local_map_ms: host milliseconds a window frame in the tracking cascade's
second stage, the program's span `tracking.local_map` (pipeline/tracking.py
`_cascade_refine`: the local point mask, the local-map search and its pose
LM, the keyframe inputs), summed over the window and divided by its
frames."""

try:
    from orb_slam2_aruco_tpu_torch.utils import telemetry
except ImportError:
    telemetry = None

KEY = "span_ns.tracking.local_map"
# a program that keeps no span totals (utils/telemetry.SPAN_NS) has nothing
# to read, and the metric is left out
COUNTERS = ({KEY: (telemetry.__name__, "SPAN_NS", "tracking.local_map")}
            if hasattr(telemetry, "SPAN_NS") else {})


def read(t):
    ns = t.counters.get(KEY)
    return ns / 1e6 / t.frames if ns is not None and t.frames else None
