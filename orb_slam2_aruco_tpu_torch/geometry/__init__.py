from orb_slam2_aruco_tpu_torch.geometry import lie, camera, triangulate, horn, ippe, twoview  # noqa: F401,E501
