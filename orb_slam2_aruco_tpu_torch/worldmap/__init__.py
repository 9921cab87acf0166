from orb_slam2_aruco_tpu_torch.worldmap import state, covisibility, retrieval  # noqa: F401,E501
