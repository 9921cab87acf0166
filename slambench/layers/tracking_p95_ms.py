"""tracking_p95_ms: the 95th percentile of the tracking cascade's
milliseconds (the spans of tracking_ms) over the window's calls."""

import numpy as np

SPANS = [("orb_slam2_aruco_tpu_torch.pipeline.tracking", "track_full",
          "tracking")]


def read(t):
    ms = t.span_ms("tracking")
    return float(np.percentile(np.asarray(ms, np.float64), 95)) if ms else None
