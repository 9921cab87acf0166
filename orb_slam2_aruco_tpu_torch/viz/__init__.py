from orb_slam2_aruco_tpu_torch.viz import framedrawer  # noqa: F401
