from orb_slam2_aruco_tpu_torch.io import synthetic, trajectory  # noqa: F401
