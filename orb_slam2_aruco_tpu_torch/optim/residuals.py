"""Reprojection residuals + analytic Jacobians for the pose, point and
marker edges.

Port of orb_slam2_aruco_tpu/optim/residuals.py (g2o EdgeSE3ProjectXYZ and
EdgeSE3ProjectXYZOnlyPose, Thirdparty/g2o types_six_dof_expmap.h:104-196,
and the marker corner edges of g2oAddition/EdgeMarker.h:41-54). Pose and
marker updates are left-multiplicative, T = exp(xi) * T0, xi = (upsilon,
omega).
"""

from __future__ import annotations

import torch

from orb_slam2_aruco_tpu_torch.geometry.lie import hat


def project_pinhole(p_cam, fx, fy, cx, cy):
    z = p_cam[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([fx * p_cam[..., 0] / z + cx,
                        fy * p_cam[..., 1] / z + cy], dim=-1)


def reproj_residual(Rcw, tcw, xyz_w, uv_obs, fx, fy, cx, cy):
    """r = obs - proj(Tcw * X) [..., 2], and the camera-frame point."""
    p = xyz_w @ Rcw.transpose(-1, -2) + tcw
    return uv_obs - project_pinhole(p, fx, fy, cx, cy), p


def dproj_dpcam(p_cam, fx, fy, cx, cy):
    """Jacobian of the projection w.r.t. the camera-frame point [..., 2, 3]."""
    x, y = p_cam[..., 0], p_cam[..., 1]
    z = p_cam[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz = 1.0 / z
    iz2 = iz * iz
    zr = torch.zeros_like(x)
    return torch.stack([
        torch.stack([fx * iz, zr, -fx * x * iz2], dim=-1),
        torch.stack([zr, fy * iz, -fy * y * iz2], dim=-1),
    ], dim=-2)


def _i_minus_hat(v):
    """[I | -hat(v)] [..., 3, 6]: d(exp(xi) v)/d xi at xi = 0."""
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(
        v.shape[:-1] + (3, 3))
    return torch.cat([eye, -hat(v)], dim=-1)


def jac_pose(p_cam, fx, fy, cx, cy):
    """d residual / d xi for the left-multiplicative update: [..., 2, 6]."""
    return -(dproj_dpcam(p_cam, fx, fy, cx, cy) @ _i_minus_hat(p_cam))


def jac_point(p_cam, Rcw, fx, fy, cx, cy):
    """d residual / d xyz_world: [..., 2, 3]."""
    return -(dproj_dpcam(p_cam, fx, fy, cx, cy) @ Rcw)


def jac_marker_world(p_cam, Rcw, corner_world, fx, fy, cx, cy):
    """d residual / d xi_marker for the left-multiplicative update of Twm;
    `corner_world` is the corner in the world frame: [..., 2, 6]."""
    return -(dproj_dpcam(p_cam, fx, fy, cx, cy)
             @ (Rcw @ _i_minus_hat(corner_world)))


def marker_corner_points_world(Rwm, twm, side):
    """4 marker corners in the world frame (MapAruco.cc:30-37 order).
    Rwm [..., 3, 3], twm [..., 3], side [...]."""
    h = side / 2.0
    z = torch.zeros_like(h)
    local = torch.stack([
        torch.stack([-h, h, z], dim=-1), torch.stack([h, h, z], dim=-1),
        torch.stack([h, -h, z], dim=-1), torch.stack([-h, -h, z], dim=-1),
    ], dim=-2)                                               # [..., 4, 3]
    return local @ Rwm.transpose(-1, -2) + twm[..., None, :]


def huber_weight(r2, delta):
    """IRLS weight of the Huber kernel from a squared residual norm."""
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    return torch.where(r <= delta, torch.ones_like(r), delta / r)
