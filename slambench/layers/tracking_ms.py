"""tracking_ms: milliseconds of the tracking cascade `track_full`
(pipeline/tracking.py, with the pose LM of optim/pose_opt.py), CUDA events
around each call, the mean over the calls of the window."""

SPANS = [("orb_slam2_aruco_tpu_torch.pipeline.tracking", "track_full",
          "tracking")]


def read(t):
    ms = t.span_ms("tracking")
    return sum(ms) / len(ms) if ms else None
