from orb_slam2_aruco_tpu_torch.ops import image, fast, orb, matching  # noqa: F401
