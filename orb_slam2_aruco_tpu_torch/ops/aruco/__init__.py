from orb_slam2_aruco_tpu_torch.ops.aruco import dictionary, detector  # noqa: F401
