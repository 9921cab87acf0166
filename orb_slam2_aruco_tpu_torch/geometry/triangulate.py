"""Batched two-view DLT triangulation.

Port of orb_slam2_aruco_tpu/geometry/triangulate.py (reference
Initializer::Triangulate, src/Initializer.cc:801-820, and the SVD
triangulation of LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:
222-467). The JAX package fixes the homogeneous scale w = 1 and solves the
3x3 normal equations with a closed-form adjugate inverse; so does the port,
with the same regularization, so degenerate rows give the same finite
garbage that every caller's gates reject.
"""

from __future__ import annotations

import torch


def inv3x3_adjugate(M, det_floor: float = 1e-30):
    """(adjugate [..., 3, 3], determinant floored away from 0 [...]) of a
    batch of 3x3 matrices: M^-1 = adj / det."""
    c00 = M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1]
    c01 = M[..., 0, 2] * M[..., 2, 1] - M[..., 0, 1] * M[..., 2, 2]
    c02 = M[..., 0, 1] * M[..., 1, 2] - M[..., 0, 2] * M[..., 1, 1]
    c10 = M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2]
    c11 = M[..., 0, 0] * M[..., 2, 2] - M[..., 0, 2] * M[..., 2, 0]
    c12 = M[..., 0, 2] * M[..., 1, 0] - M[..., 0, 0] * M[..., 1, 2]
    c20 = M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]
    c21 = M[..., 0, 1] * M[..., 2, 0] - M[..., 0, 0] * M[..., 2, 1]
    c22 = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    det = M[..., 0, 0] * c00 + M[..., 0, 1] * c10 + M[..., 0, 2] * c20
    det = torch.where(torch.abs(det) < det_floor,
                      torch.full_like(det, det_floor), det)
    adj = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                       torch.stack([c10, c11, c12], dim=-1),
                       torch.stack([c20, c21, c22], dim=-1)], dim=-2)
    return adj, det


def triangulate_dlt(R1, t1, R2, t2, xn1, xn2):
    """World points [..., 3] from two world->camera poses ([..., 3, 3],
    [..., 3]) and normalized image coordinates [..., 2]."""
    P1 = torch.cat([R1, t1[..., None]], dim=-1)          # [..., 3, 4]
    P2 = torch.cat([R2, t2[..., None]], dim=-1)
    A = torch.cat([
        xn1[..., 0:1, None] * P1[..., 2:3, :] - P1[..., 0:1, :],
        xn1[..., 1:2, None] * P1[..., 2:3, :] - P1[..., 1:2, :],
        xn2[..., 0:1, None] * P2[..., 2:3, :] - P2[..., 0:1, :],
        xn2[..., 1:2, None] * P2[..., 2:3, :] - P2[..., 1:2, :],
    ], dim=-2)                                            # [..., 4, 4]
    A3 = A[..., :, :3]
    b = -A[..., :, 3]
    M = A3.transpose(-1, -2) @ A3                         # [..., 3, 3]
    v = (A3.transpose(-1, -2) @ b[..., None])[..., 0]
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    M = M + (1e-12 * tr + 1e-30)[..., None, None] * torch.eye(
        3, dtype=M.dtype, device=M.device)
    adj, det = inv3x3_adjugate(M)
    return (adj @ v[..., None])[..., 0] / det[..., None]


def depth_in_cam(R, t, xyz_world):
    """z-coordinate of world points in a camera (cheirality test input)."""
    return torch.sum(R[..., 2, :] * xyz_world, dim=-1) + t[..., 2]


def parallax_cos(c1, c2, xyz):
    """Cosine of the ray angle at xyz between camera centers c1 and c2."""
    r1 = xyz - c1
    r2 = xyz - c2
    denom = torch.clamp(torch.linalg.norm(r1, dim=-1)
                        * torch.linalg.norm(r2, dim=-1), min=1e-12)
    return torch.sum(r1 * r2, dim=-1) / denom
