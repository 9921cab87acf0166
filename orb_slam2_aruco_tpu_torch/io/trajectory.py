"""Trajectory export and evaluation (numpy).

Port of orb_slam2_aruco_tpu/io/trajectory.py: the TUM writer and reader
(System::SaveKeyFrameTrajectoryTUM, reference src/System.cc:287-321, and
the examples' writer, mono_cvcam.cc:236-266), the KITTI writer
(System::SaveTrajectoryKITTI, :323-376), camera centres and the absolute
trajectory error after an SE3 or Sim3 alignment (the TUM protocol; the JAX
package aligns with geometry/horn.py, here the closed-form Umeyama
solution in float64). The writers' output is byte-equal to the JAX
package's for the same poses.
"""

from __future__ import annotations

import numpy as np


def _fma32(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _quat_wxyz(R) -> np.ndarray:
    """The unit quaternion (w, x, y, z), w >= 0, of a rotation, in float32
    as the JAX package's geometry.lie.rot_to_quat computes it on the CPU
    (Shepperd's largest pivot; XLA sums the squares of the norm with fused
    multiply-adds), so the TUM lines are byte-equal to its writer's."""
    f = np.float32
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = np.asarray(R, f)
    pivots = [max(f(0), f(1) + m00 + m11 + m22),
              max(f(0), f(1) + m00 - m11 - m22),
              max(f(0), f(1) - m00 + m11 - m22),
              max(f(0), f(1) - m00 - m11 + m22)]
    cands = np.array([[pivots[0], m21 - m12, m02 - m20, m10 - m01],
                      [m21 - m12, pivots[1], m01 + m10, m02 + m20],
                      [m02 - m20, m01 + m10, pivots[2], m12 + m21],
                      [m10 - m01, m02 + m20, m12 + m21, pivots[3]]], f)
    q = cands[int(np.argmax(pivots))]
    sq = _fma32(q[3], q[3], _fma32(q[2], q[2], _fma32(q[1], q[1],
                                                      q[0] * q[0])))
    q = q / max(np.sqrt(sq), f(1e-8))
    return q * (f(-1) if q[0] < 0 else f(1))


def save_tum(path: str, timestamps, Rcw_list, tcw_list):
    """TUM format: `t tx ty tz qx qy qz qw` of the camera-to-world pose."""
    lines = []
    for ts, Rcw, tcw in zip(timestamps, Rcw_list, tcw_list):
        Rwc = np.asarray(Rcw).T
        c = -Rwc @ np.asarray(tcw)
        q = _quat_wxyz(Rwc)
        lines.append(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                     f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_tum(path: str):
    """(timestamps [n], centres [n, 3], quaternions [n, 4] (x, y, z, w))."""
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def save_kitti(path: str, Rcw_list, tcw_list):
    """KITTI format: one 3x4 camera-to-world matrix per line, row-major."""
    lines = []
    for Rcw, tcw in zip(Rcw_list, tcw_list):
        Rwc = np.asarray(Rcw).T
        c = -Rwc @ np.asarray(tcw)
        P = np.concatenate([Rwc, c[:, None]], axis=1)
        lines.append(" ".join(f"{v:.9e}" for v in P.reshape(-1)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


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
