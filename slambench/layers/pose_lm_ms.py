"""pose_lm_ms: host milliseconds a window frame in the pose LM, the
program's span `pose_lm` (every call of optim/pose_opt.optimize_pose, in
whichever stage it runs: two a frame on the common path), summed over the
window and divided by its frames."""

try:
    from orb_slam2_aruco_tpu_torch.utils import telemetry
except ImportError:
    telemetry = None

KEY = "span_ns.pose_lm"
# a program that keeps no span totals (utils/telemetry.SPAN_NS) has nothing
# to read, and the metric is left out
COUNTERS = ({KEY: (telemetry.__name__, "SPAN_NS", "pose_lm")}
            if hasattr(telemetry, "SPAN_NS") else {})


def read(t):
    ns = t.counters.get(KEY)
    return ns / 1e6 / t.frames if ns is not None and t.frames else None
