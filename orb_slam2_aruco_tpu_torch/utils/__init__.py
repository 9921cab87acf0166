from orb_slam2_aruco_tpu_torch.utils.telemetry import FrameTimer, device_trace

__all__ = ["FrameTimer", "device_trace"]
