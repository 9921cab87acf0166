"""Trajectory evaluation (numpy).

Port of the ATE part of orb_slam2_aruco_tpu/io/trajectory.py: camera centres
and the absolute trajectory error after an SE3 or Sim3 alignment (the TUM
protocol; the JAX package aligns with geometry/horn.py, here the closed-form
Umeyama solution in float64).
"""

from __future__ import annotations

import numpy as np


def camera_centers(Rcw_list, tcw_list) -> np.ndarray:
    return np.stack([-np.asarray(R).T @ np.asarray(t)
                     for R, t in zip(Rcw_list, tcw_list)])


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool):
    """(s, R, t) minimizing sum |s R src_i + t - dst_i|^2."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = (np.trace(np.diag(D) @ S) / (xs ** 2).sum(1).mean()
         if with_scale else 1.0)
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_centers, gt_centers, align: bool = True,
             with_scale: bool = True) -> float:
    est = np.asarray(est_centers, dtype=np.float64)
    gt = np.asarray(gt_centers, dtype=np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"shape mismatch {est.shape} vs {gt.shape}")
    if align:
        s, R, t = align_umeyama(est, gt, with_scale)
        est = s * (R @ est.T).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))
