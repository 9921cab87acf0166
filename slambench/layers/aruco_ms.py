"""aruco_ms: host milliseconds a window frame in the frontend's marker half,
the program's span `frontend.aruco` (pipeline/frontend.py `make_frame`: the
detector with K3, corner refinement, undistortion, IPPE), summed over the
window and divided by its frames."""

try:
    from orb_slam2_aruco_tpu_torch.utils import telemetry
except ImportError:
    telemetry = None

KEY = "span_ns.frontend.aruco"
# a program that keeps no span totals (utils/telemetry.SPAN_NS) has nothing
# to read, and the metric is left out
COUNTERS = ({KEY: (telemetry.__name__, "SPAN_NS", "frontend.aruco")}
            if hasattr(telemetry, "SPAN_NS") else {})


def read(t):
    ns = t.counters.get(KEY)
    return ns / 1e6 / t.frames if ns is not None and t.frames else None
