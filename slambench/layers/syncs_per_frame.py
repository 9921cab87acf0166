"""syncs_per_frame: the program's deliberate host reads of device values
(`tracking.SYNCS`, counted at each read) over the window, per frame."""

COUNTERS = {"syncs": ("orb_slam2_aruco_tpu_torch.pipeline.tracking",
                      "SYNCS", "count")}


def read(t):
    return t.counters["syncs"] / t.frames if t.frames else None
