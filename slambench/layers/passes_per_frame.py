"""passes_per_frame: the tracking cascade's passes a window frame, the calls
of the program's spans `tracking.motion`, `tracking.retry` (the
widened-window track), `tracking.refkf` (the reference-keyframe track) and
`tracking.local_map` (pipeline/tracking.py) summed over the window and
divided by its frames: 2.0 where every frame takes the common path, more
for each fallback taken."""

try:
    from orb_slam2_aruco_tpu_torch.utils import telemetry
except ImportError:
    telemetry = None

STAGES = ("tracking.motion", "tracking.retry", "tracking.refkf",
          "tracking.local_map")
# a program that keeps no span totals (utils/telemetry.SPAN_CALLS) has
# nothing to read, and the metric is left out
COUNTERS = ({"span_calls." + s: (telemetry.__name__, "SPAN_CALLS", s)
             for s in STAGES}
            if hasattr(telemetry, "SPAN_CALLS") else {})


def read(t):
    calls = [t.counters.get("span_calls." + s) for s in STAGES]
    if None in calls or not t.frames:
        return None
    return sum(calls) / t.frames
