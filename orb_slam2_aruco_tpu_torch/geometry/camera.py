"""Pinhole camera with radial-tangential distortion.

Port of orb_slam2_aruco_tpu/geometry/camera.py (reference src/Frame.cc:357-416
cv::undistortPoints usage). Intrinsics are 0-d float32 tensors on the
camera's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.config import CameraConfig


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # [5] (k1, k2, p1, p2, k3)
    width: int
    height: int

    @property
    def K(self):
        """[..., 3, 3] intrinsic matrix."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([torch.stack([self.fx, z, self.cx], dim=-1),
                            torch.stack([z, self.fy, self.cy], dim=-1),
                            torch.stack([z, z, o], dim=-1)], dim=-2)


def camera_from_config(cfg: CameraConfig, device="cpu") -> Camera:
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa
    return Camera(f(cfg.fx), f(cfg.fy), f(cfg.cx), f(cfg.cy),
                  torch.tensor(cfg.dist, dtype=torch.float32, device=device),
                  cfg.width, cfg.height)


def camera_from_numpy(fields: dict, device="cpu") -> Camera:
    """A Camera from the JAX Camera's fields as numpy (or Python) values."""
    f = lambda k: torch.as_tensor(np.array(fields[k], np.float32),  # noqa
                                  device=device)
    return Camera(f("fx"), f("fy"), f("cx"), f("cy"), f("dist"),
                  int(fields["width"]), int(fields["height"]))


def undistort_normalized(cam: Camera, xd, iters: int = 8):
    """Invert distortion by fixed-point iteration (cv::undistortPoints)."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x0, y0 = xd[..., 0], xd[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x, y], dim=-1)


def distort_normalized(cam: Camera, xn):
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def project(cam: Camera, xyz_cam, distort: bool = False):
    """Camera-frame points [..., 3] -> pixels [..., 2], undistorted by
    default (the tracking works on undistorted keypoints, like the
    reference after Frame::UndistortKeyPoints)."""
    z = xyz_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xn = xyz_cam[..., :2] / z_safe[..., None]
    if distort:
        xn = distort_normalized(cam, xn)
    return torch.stack([cam.fx * xn[..., 0] + cam.cx,
                        cam.fy * xn[..., 1] + cam.cy], dim=-1)


def pixels_to_normalized(cam: Camera, uv, undistort: bool = False):
    xn = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    if undistort:
        xn = undistort_normalized(cam, xn)
    return xn


def undistort_pixels(cam: Camera, uv):
    """Distorted pixels -> undistorted pixels (Frame::UndistortKeyPoints)."""
    xn = pixels_to_normalized(cam, uv, undistort=True)
    return torch.stack([cam.fx * xn[..., 0] + cam.cx,
                        cam.fy * xn[..., 1] + cam.cy], dim=-1)


def in_image(cam: Camera, uv, margin: float = 0.0):
    return (
        (uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin)
    )
