"""Pose-only optimization with point + fixed-marker corner edges.

Port of orb_slam2_aruco_tpu/optim/pose_opt.py (reference
Optimizer::PoseOptimization, src/Optimizer.cc:308-520, and
PoseOptimizationByAruco, :522-770): 4 rounds x up to 10 LM iterations, chi2
reclassification (5.991) after each round, Huber kernel for the first two
rounds, marker corners as fixed edges with information w = 25.

The JAX loop stops a round after two stalled iterations (a `while_loop`).
Here every round runs its full iteration budget with the updates masked off
once the round has stalled: the same poses, and no host sync per iteration.
Point and marker-corner edges share one edge array; the residuals at the
current pose are carried from the iteration that accepted it. Every call
is the span pose_lm (utils/telemetry.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.lie import (
    orthonormalize,
    se3_compose,
    se3_exp,
)
from orb_slam2_aruco_tpu_torch.optim import residuals as res
from orb_slam2_aruco_tpu_torch.optim.lm import solve_damped
from orb_slam2_aruco_tpu_torch.utils.telemetry import annotate


class PoseOptResult(NamedTuple):
    Rcw: torch.Tensor
    tcw: torch.Tensor
    inliers: torch.Tensor     # [N] bool point-edge inliers
    n_inliers: torch.Tensor   # [] int64
    chi2: torch.Tensor        # [] final total chi2


@annotate("pose_lm")
def optimize_pose(Rcw0, tcw0, cam: Camera, pts_w, uv, mask, inv_sigma2,
                  marker_corners_w=None, marker_uv=None, marker_mask=None,
                  marker_weight: float = 25.0, chi2_th: float = 5.991,
                  huber_delta: float = 2.4477, rounds: int = 4,
                  iters_per_round: int = 10,
                  lam0: float = 1e-3) -> PoseOptResult:
    dev = pts_w.device
    mask = mask.to(torch.float32)
    n_pts = pts_w.shape[0]
    if marker_corners_w is not None:
        m_corners = marker_corners_w.reshape(-1, 3)
        m_uv = marker_uv.reshape(-1, 2)
        m_w = (marker_mask.to(torch.float32).repeat_interleave(4)
               * marker_weight)
    else:
        m_corners = pts_w.new_zeros((4, 3))
        m_uv = uv.new_zeros((4, 2))
        m_w = pts_w.new_zeros((4,))
    X = torch.cat([pts_w, m_corners])                 # [E, 3] all edges
    Z = torch.cat([uv, m_uv])
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy

    def residual(R, t):
        r, p = res.reproj_residual(R, t, X, Z, fx, fy, cx, cy)
        return r, p, torch.sum(r * r, dim=-1)        # [E, 2], [E, 3], [E]

    def edge_weights(inlier_w):
        return torch.cat([mask * inlier_w * inv_sigma2, m_w])

    R, t = Rcw0, tcw0
    r, p, r2 = residual(R, t)
    inlier_w = torch.ones((n_pts,), dtype=torch.float32, device=dev)
    for rd in range(rounds):
        w = edge_weights(inlier_w)
        chi2_cur = torch.sum(r2 * w)
        lam = torch.full((), lam0, dtype=torch.float32, device=dev)
        stall = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(iters_per_round):
            active = stall < 2
            chi2_e = r2 * w
            wt = w * res.huber_weight(chi2_e, huber_delta) if rd < 2 else w
            wt = torch.where(p[:, 2] <= 0.05, 0.0, wt)
            J = res.jac_pose(p, fx, fy, cx, cy).reshape(-1, 6)   # [2E, 6]
            Jw = J * wt.repeat_interleave(2)[:, None]
            H = Jw.T @ J
            b = -(Jw.T @ r.reshape(-1))
            dx = solve_damped(H, b, lam)
            dR, dt = se3_exp(dx)
            Rn, tn = se3_compose(dR, dt, R, t)
            rn, pn, r2n = residual(Rn, tn)
            chi2_new = torch.sum(r2n * w)
            accept = active & (chi2_new < chi2_cur)
            improved = chi2_new < chi2_cur * (1.0 - 1e-5)
            R = torch.where(accept, Rn, R)
            t = torch.where(accept, tn, t)
            r = torch.where(accept, rn, r)
            p = torch.where(accept, pn, p)
            r2 = torch.where(accept, r2n, r2)
            lam = torch.where(active, torch.clamp(
                torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6), lam)
            chi2_cur = torch.where(accept, chi2_new, chi2_cur)
            stall = torch.where(active, torch.where(improved, 0, stall + 1),
                                stall)
        inlier_w = (r2[:n_pts] * inv_sigma2 < chi2_th).to(torch.float32)
    chi2_final = torch.sum(r2 * edge_weights(inlier_w))
    inl = (inlier_w > 0) & (mask > 0)
    return PoseOptResult(Rcw=orthonormalize(R), tcw=t, inliers=inl,
                         n_inliers=inl.sum(), chi2=chi2_final)
