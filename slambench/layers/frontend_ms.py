"""frontend_ms: milliseconds of `make_frame` (pipeline/frontend.py: the ORB
pyramid, FAST, patches and descriptors, and the ArUco detector), CUDA
events around each call the facade makes, the mean over the window's
frames."""

SPANS = [("orb_slam2_aruco_tpu_torch.pipeline.system", "make_frame",
          "frontend")]


def read(t):
    ms = t.span_ms("frontend")
    return sum(ms) / len(ms) if ms else None
