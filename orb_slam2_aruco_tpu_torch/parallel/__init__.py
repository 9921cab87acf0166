from orb_slam2_aruco_tpu_torch.parallel import dist_ba  # noqa: F401
