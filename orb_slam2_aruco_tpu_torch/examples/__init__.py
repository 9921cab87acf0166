"""Runnable examples of the port:
python -m orb_slam2_aruco_tpu_torch.examples.<name>."""
