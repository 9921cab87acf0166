"""orb_ms: host milliseconds a window frame in the frontend's ORB half, the
program's span `frontend.orb` (pipeline/frontend.py `make_frame`: pyramid,
FAST (K1), patches (K2), angles, BRIEF, BoW), summed over the window and
divided by its frames."""

try:
    from orb_slam2_aruco_tpu_torch.utils import telemetry
except ImportError:
    telemetry = None

KEY = "span_ns.frontend.orb"
# a program that keeps no span totals (utils/telemetry.SPAN_NS) has nothing
# to read, and the metric is left out
COUNTERS = ({KEY: (telemetry.__name__, "SPAN_NS", "frontend.orb")}
            if hasattr(telemetry, "SPAN_NS") else {})


def read(t):
    ns = t.counters.get(KEY)
    return ns / 1e6 / t.frames if ns is not None and t.frames else None
