"""motion_ms: host milliseconds a window frame in the tracking cascade's first
stage, the program's span `tracking.motion` (pipeline/tracking.py
`_cascade_seed`: marker binding, the marker pose candidate and the
motion-model track with its pose LM, through the first branch read), summed
over the window and divided by its frames."""

try:
    from orb_slam2_aruco_tpu_torch.utils import telemetry
except ImportError:
    telemetry = None

KEY = "span_ns.tracking.motion"
# a program that keeps no span totals (utils/telemetry.SPAN_NS) has nothing
# to read, and the metric is left out
COUNTERS = ({KEY: (telemetry.__name__, "SPAN_NS", "tracking.motion")}
            if hasattr(telemetry, "SPAN_NS") else {})


def read(t):
    ns = t.counters.get(KEY)
    return ns / 1e6 / t.frames if ns is not None and t.frames else None
