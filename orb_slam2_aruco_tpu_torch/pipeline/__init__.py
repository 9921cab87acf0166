from orb_slam2_aruco_tpu_torch.pipeline import (  # noqa: F401
    frontend,
    initializer,
    mapping,
    system,
    tracking,
)
