from orb_slam2_aruco_tpu_torch.optim import lm, pose_opt, ba, sim3_opt, pose_graph  # noqa: F401,E501
