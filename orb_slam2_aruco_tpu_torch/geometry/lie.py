"""SO3 / SE3 operations, batched over leading dims.

Port of orb_slam2_aruco_tpu/geometry/lie.py. Rotations are 3x3 matrices;
poses are (R, t) pairs; similarities are (s, R, t) triples, x -> s R x + t
(g2o/types/sim3.h). Includes the atan2-stable `so3_log` (finite
everywhere, including at R = I).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """so3 hat: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(M):
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def so3_exp(w):
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R):
    """[..., 3, 3] -> [..., 3]; stable near 0 and pi (angle from
    atan2(|sin|, cos), axis from the symmetric part near pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_vee = vee(R - R.transpose(-1, -2)) * 0.5
    nq = torch.sum(w_vee * w_vee, dim=-1)
    small = nq < 1e-12
    sin_theta = torch.sqrt(torch.where(small, torch.ones_like(nq), nq))
    theta = torch.atan2(torch.where(small, torch.zeros_like(nq), sin_theta),
                        cos_theta)
    near_pi = cos_theta < -0.98
    scale = torch.where(small, 1.0 + nq / 6.0,
                        theta / torch.where(small, torch.ones_like(nq),
                                            sin_theta))
    w_generic = scale[..., None] * w_vee
    one_minus_cos = torch.clamp(1.0 - cos_theta, min=0.5)
    S = 0.5 * (R + R.transpose(-1, -2))
    eye3 = _eye_like(R)
    A = eye3 + (S - eye3) / one_minus_cos[..., None, None]
    diag = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    row = torch.gather(A, -2, k[..., None, None].expand(A.shape[:-2] + (1, 3)))
    row = row[..., 0, :]
    axis = row / torch.clamp(torch.linalg.norm(row, dim=-1, keepdim=True),
                             min=_EPS)
    sgn = torch.where(torch.sum(axis * w_vee, dim=-1, keepdim=True) < 0,
                      -1.0, 1.0)
    w_pi = sgn * axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w):
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(w):
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    half = theta * 0.5
    sin_half = torch.sin(half)
    sin_half_safe = torch.where(torch.abs(sin_half) < 1e-12,
                                torch.ones_like(sin_half), sin_half)
    cot = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                      (1.0 - half * torch.cos(half) / sin_half_safe)
                      / theta2_safe)
    W = hat(w)
    return _eye_like(W) - 0.5 * W + cot[..., None, None] * (W @ W)


def se3_exp(xi):
    """xi [..., 6] = (upsilon, omega) -> (R [..., 3, 3], t [..., 3])."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    return R, (V @ v[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb): x -> Ra(Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    Rinv = R.transpose(-1, -2)
    return Rinv, -(Rinv @ t[..., None])[..., 0]


def se3_apply(R, t, x):
    """[..., 3, 3], [..., 3], [..., 3] -> [..., 3]."""
    return (R @ x[..., None])[..., 0] + t


def rot_to_quat(R):
    """[..., 3, 3] -> quaternion [..., 4] (w, x, y, z), w >= 0 (branch-free
    Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cand_w = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    pivots = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    k = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, k[..., None, None].expand(
        cands.shape[:-2] + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    sign = torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q * sign


def quat_to_rot(q):
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], dim=-1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], dim=-1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def orthonormalize(R):
    """Project near-rotations back onto SO(3) through a unit quaternion."""
    return quat_to_rot(rot_to_quat(R))


# ---------------------------------------------------------------------------
# Sim3 (s, R, t): x -> s R x + t
# ---------------------------------------------------------------------------


def sim3_apply(s, R, t, x):
    return s[..., None] * (R @ x[..., None])[..., 0] + t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) * (sb,Rb,tb)."""
    return sa * sb, Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta


def sim3_inverse(s, R, t):
    sinv = 1.0 / torch.clamp(s, min=_EPS)
    Rinv = R.transpose(-1, -2)
    return sinv, Rinv, -sinv[..., None] * (Rinv @ t[..., None])[..., 0]


def _sim3_V(sigma, w, s):
    """The W matrix of sim3_exp, V = X I + A W + B W^2 (Sophus RxSO3 / Sim3
    closed form, the JAX package's Taylor guards), from (sigma, omega)."""
    theta2 = torch.sum(w * w, dim=-1)
    tiny = theta2 < _EPS
    theta = torch.where(tiny, torch.zeros_like(theta2),
                        torch.sqrt(torch.where(tiny, torch.ones_like(theta2),
                                               theta2)))
    W = hat(w)
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta < 1e-5
    one = torch.ones_like(sigma)
    sigma_safe = torch.where(small_sigma, one, sigma)
    theta_safe = torch.where(small_theta, one, theta)
    X = torch.where(small_sigma, 1.0 + sigma / 2.0, (s - 1.0) / sigma_safe)
    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    c2 = sigma * sigma + theta2
    c2_safe = torch.where(c2 < 1e-12, one, c2)
    zero = torch.zeros_like(theta)
    A = torch.where(small_theta, zero,
                    (a_ * sigma + (1.0 - b_) * theta) / (theta_safe * c2_safe))
    B = torch.where(small_theta, zero,
                    (X - ((b_ - 1.0) * sigma + a_ * theta) / c2_safe)
                    / torch.where(small_theta, one, theta2))
    return (X[..., None, None] * _eye_like(W) + A[..., None, None] * W
            + B[..., None, None] * (W @ W))


def sim3_exp(xi):
    """xi [..., 7] = (upsilon, omega, sigma) -> (s, R, t)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    V = _sim3_V(sigma, w, s)
    return s, so3_exp(w), (V @ v[..., None])[..., 0]


def sim3_log(s, R, t):
    """Inverse of sim3_exp -> [..., 7] (upsilon, omega, sigma), V solved
    numerically as in the JAX package (`solve_ex`: no host check)."""
    sigma = torch.log(torch.clamp(s, min=_EPS))
    w = so3_log(R)
    V = _sim3_V(sigma, w, s)
    v = torch.linalg.solve_ex(V, t[..., None])[0][..., 0]
    return torch.cat([v, w, sigma[..., None]], dim=-1)
