"""IPPE: Infinitesimal Plane-based Pose Estimation (Collins & Bartoli, IJCV'14).

Port of orb_slam2_aruco_tpu/geometry/ippe.py (reference
Thirdparty/aruco/ippe.h:14-22; the err0/err1 < 0.7 gate of src/Frame.cc:170-174
consumes the returned ratio). Batched over leading dims. The small linear
solves use `torch.linalg.solve_ex`, which does not wait for the device to
report singular systems: singular inputs give non-finite values, which
`ippe_planar_pose` sanitizes like the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_aruco_tpu_torch.geometry.lie import hat
from orb_slam2_aruco_tpu_torch.utils.consts import const


class IppeResult(NamedTuple):
    R: torch.Tensor        # [..., 2, 3, 3] two rotation solutions (best first)
    t: torch.Tensor        # [..., 2, 3]
    err: torch.Tensor      # [..., 2] mean squared reprojection error
    ratio: torch.Tensor    # [...] err0 / err1


def square_object_points(side, dtype=torch.float32, device="cpu"):
    """Canonical marker corners on z=0 (MapAruco.cc:30-37 winding)."""
    h = side / 2.0
    return const(("square", float(side), dtype), device, lambda: torch.tensor(
        [[-h, h, 0.0], [h, h, 0.0], [h, -h, 0.0], [-h, -h, 0.0]],
        dtype=dtype))


def _solve(A, b):
    return torch.linalg.solve_ex(A, b)[0]


def homography_4pt(src, dst):
    """Exact homography from 4 correspondences ([..., 4, 2] each) via an 8x8
    linear solve. Returns H [..., 3, 3] with H[2,2] = 1."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    b = torch.cat([u, v], dim=-1)[..., None]
    h = _solve(A, b)[..., 0]
    o1 = torch.ones(h.shape[:-1] + (1,), dtype=h.dtype, device=h.device)
    return torch.cat([h, o1], dim=-1).reshape(h.shape[:-1] + (3, 3))


def _rotate_vec_to_z(v):
    a = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    ez = torch.zeros_like(a)
    ez[..., 2] = 1.0
    k = torch.linalg.cross(a, ez, dim=-1)
    s = torch.linalg.norm(k, dim=-1)
    c = a[..., 2]
    small = s < 1e-9
    k_unit = k / torch.where(small, torch.ones_like(s), s)[..., None]
    K = hat(k_unit)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    theta = torch.atan2(s, c)
    R = (eye + torch.sin(theta)[..., None, None] * K
         + (1.0 - torch.cos(theta))[..., None, None] * (K @ K))
    flip = const(("flip_yz", v.dtype), v.device, lambda: torch.tensor(
        [[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]],
        dtype=v.dtype)).expand(K.shape)
    R_small = torch.where(c[..., None, None] > 0, eye, flip)
    return torch.where(small[..., None, None], R_small, R)


def _translation_lsq(R, xyz_obj, xn):
    a = xyz_obj @ R.transpose(-1, -2)                 # [..., N, 3]
    u, v = xn[..., 0], xn[..., 1]
    o = torch.ones_like(u)
    z = torch.zeros_like(u)
    A = torch.cat([torch.stack([o, z, -u], dim=-1),
                   torch.stack([z, o, -v], dim=-1)], dim=-2)
    b = torch.cat([u * a[..., 2] - a[..., 0],
                   v * a[..., 2] - a[..., 1]], dim=-1)[..., None]
    At = A.transpose(-1, -2)
    return _solve(At @ A, At @ b)[..., 0]


def _reproj_err(R, t, xyz_obj, xn):
    p = xyz_obj @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(torch.abs(p[..., 2]) < 1e-9,
                    torch.full_like(p[..., 2], 1e-9), p[..., 2])
    proj = p[..., :2] / z[..., None]
    return torch.mean(torch.sum((proj - xn) ** 2, dim=-1), dim=-1)


def ippe_planar_pose(xyz_obj, xn) -> IppeResult:
    """Both planar-pose solutions for centred z=0 object points [..., N, 3]
    observed at normalized coords [..., N, 2], sorted by reprojection
    error."""
    H = homography_4pt(xyz_obj[..., :4, :2], xn[..., :4, :])
    p = H[..., 0, 2]
    q = H[..., 1, 2]
    j00 = H[..., 0, 0] - p * H[..., 2, 0]
    j01 = H[..., 0, 1] - p * H[..., 2, 1]
    j10 = H[..., 1, 0] - q * H[..., 2, 0]
    j11 = H[..., 1, 1] - q * H[..., 2, 1]
    v = torch.stack([p, q, torch.ones_like(p)], dim=-1)
    Rv = _rotate_vec_to_z(v)
    b00 = Rv[..., 0, 0] * j00 + Rv[..., 0, 1] * j10
    b01 = Rv[..., 0, 0] * j01 + Rv[..., 0, 1] * j11
    b10 = Rv[..., 1, 0] * j00 + Rv[..., 1, 1] * j10
    b11 = Rv[..., 1, 0] * j01 + Rv[..., 1, 1] * j11
    dtB = b00 * b11 - b01 * b10
    bsq = b00 * b00 + b01 * b01 + b10 * b10 + b11 * b11
    inner = torch.clamp(bsq * bsq - 4.0 * dtB * dtB, min=0.0)
    gamma = torch.sqrt(torch.clamp(0.5 * (bsq + torch.sqrt(inner)), min=1e-12))
    rt00, rt01, rt10, rt11 = b00 / gamma, b01 / gamma, b10 / gamma, b11 / gamma
    c0 = torch.sqrt(torch.clamp(1.0 - rt00 * rt00 - rt10 * rt10, min=0.0))
    c1mag = torch.sqrt(torch.clamp(1.0 - rt01 * rt01 - rt11 * rt11, min=0.0))
    sp = -(rt00 * rt01 + rt10 * rt11)
    c1 = torch.where(sp < 0, -c1mag, c1mag)

    def build_R(s):
        col0 = torch.stack([rt00, rt10, s * c0], dim=-1)
        col1 = torch.stack([rt01, rt11, s * c1], dim=-1)
        col2 = torch.linalg.cross(col0, col1, dim=-1)
        M = torch.stack([col0, col1, col2], dim=-1)
        return Rv.transpose(-1, -2) @ M

    R1, R2 = build_R(1.0), build_R(-1.0)
    t1 = _translation_lsq(R1, xyz_obj, xn)
    t2 = _translation_lsq(R2, xyz_obj, xn)
    e1 = _reproj_err(R1, t1, xyz_obj, xn)
    e2 = _reproj_err(R2, t2, xyz_obj, xn)

    def _san(R, t, e):
        ok = (torch.isfinite(R).all(dim=-1).all(dim=-1)
              & torch.isfinite(t).all(dim=-1) & torch.isfinite(e))
        eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
        return (torch.where(ok[..., None, None], R, eye),
                torch.where(ok[..., None], t, torch.zeros_like(t)),
                torch.where(ok, e, torch.full_like(e, 1e12)))

    R1, t1, e1 = _san(R1, t1, e1)
    R2, t2, e2 = _san(R2, t2, e2)
    swap = e2 < e1
    Ra = torch.where(swap[..., None, None], R2, R1)
    Rb = torch.where(swap[..., None, None], R1, R2)
    ta = torch.where(swap[..., None], t2, t1)
    tb = torch.where(swap[..., None], t1, t2)
    ea = torch.where(swap, e2, e1)
    eb = torch.where(swap, e1, e2)
    return IppeResult(
        R=torch.stack([Ra, Rb], dim=-3),
        t=torch.stack([ta, tb], dim=-2),
        err=torch.stack([ea, eb], dim=-1),
        ratio=ea / torch.clamp(eb, min=1e-12),
    )


def ippe_square(side, xn) -> IppeResult:
    """IPPE for a canonical square marker; xn [..., 4, 2] normalized coords
    in reference corner order."""
    obj = square_object_points(side, dtype=xn.dtype, device=xn.device)
    return ippe_planar_pose(obj.expand(xn.shape[:-2] + (4, 3)), xn)
