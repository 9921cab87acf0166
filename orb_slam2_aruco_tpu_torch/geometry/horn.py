"""Horn's closed-form absolute orientation: a Sim3 from 3D-3D pairs.

Port of orb_slam2_aruco_tpu/geometry/horn.py (Sim3Solver::ComputeSim3,
reference src/Sim3Solver.cc, Horn 1987 quaternion method), batched over
leading dims so every RANSAC triple of the classic loop path is solved at
once. The quaternion is the eigenvector of the largest eigenvalue of
Horn's 4x4 matrix; q and -q give the same rotation, so results are held
to the JAX package's by rotation, not by quaternion.
"""

from __future__ import annotations

import torch

from orb_slam2_aruco_tpu_torch.geometry.lie import quat_to_rot


def horn_sim3(p1, p2, w=None, fix_scale: bool = False):
    """(s [...], R [..., 3, 3], t [..., 3]) minimizing
    sum_i w_i |p2_i - (s R p1_i + t)|^2 over [..., N, 3] point sets;
    `w` [..., N] >= 0 defaults to ones; `fix_scale` gives s = 1."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    c1 = torch.sum(wn[..., None] * p1, dim=-2)
    c2 = torch.sum(wn[..., None] * p2, dim=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = (wn[..., None] * q1).transpose(-1, -2) @ q2        # [..., 3, 3]
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    # ascending eigenvalues: the last eigenvector is the rotation
    _, evecs = torch.linalg.eigh(N)
    R = quat_to_rot(evecs[..., :, 3])
    Rq1 = q1 @ R.transpose(-1, -2)
    num = torch.sum(wn * torch.sum(q2 * Rq1, dim=-1), dim=-1)
    den = torch.clamp(torch.sum(wn * torch.sum(q1 * q1, dim=-1), dim=-1),
                      min=1e-12)
    s = torch.ones_like(num) if fix_scale else num / den
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return s, R, t
