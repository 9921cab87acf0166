"""Two-view relative geometry: batched H / F estimation, scoring and
decomposition.

Port of orb_slam2_aruco_tpu/geometry/twoview.py (reference
Initializer::{FindHomography, FindFundamental, ReconstructF, ReconstructH,
CheckRT}, src/Initializer.cc). Every RANSAC hypothesis set is solved and
scored in one batch; RANSAC becomes an argmax. SVD null vectors and
singular vectors have an arbitrary sign (LAPACK, cuSOLVER and XLA may each
pick another one): F, H and E are defined up to scale and sign, and the
candidate (R, t) sets they decompose into are the same. Solves and
inverses use the `_ex` forms: a singular system gives non-finite values, as
in the JAX package, instead of raising (and, on the card, instead of the
host read of the error code).
"""

from __future__ import annotations

import torch

from orb_slam2_aruco_tpu_torch.geometry.triangulate import (
    parallax_cos,
    triangulate_dlt,
)
from orb_slam2_aruco_tpu_torch.utils import consts


def normalize_points(x, mask=None):
    """Hartley normalization: x [..., N, 2] -> (xn, T [..., 3, 3]) with mean
    0 and mean absolute deviation 1 (the reference's Normalize)."""
    if mask is None:
        mask = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    m = mask[..., None]
    cnt = torch.clamp(torch.sum(m, dim=-2, keepdim=True), min=1.0)
    mean = torch.sum(x * m, dim=-2, keepdim=True) / cnt
    d = torch.sum(torch.abs(x - mean) * m, dim=-2, keepdim=True) / cnt
    s = 1.0 / torch.clamp(d, min=1e-9)
    xn = (x - mean) * s
    sx, sy = s[..., 0, 0], s[..., 0, 1]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    T = torch.stack([torch.stack([sx, z, -mx * sx], dim=-1),
                     torch.stack([z, sy, -my * sy], dim=-1),
                     torch.stack([z, z, o], dim=-1)], dim=-2)
    return xn, T


def _null_vector(A):
    """The right singular vector of the smallest singular value of each
    [..., M, 9] matrix, as a [..., 3, 3] matrix."""
    vh = torch.linalg.svd(A, full_matrices=True).Vh
    return vh[..., 8, :].reshape(vh.shape[:-2] + (3, 3))


def fundamental_8pt(x1, x2):
    """Normalized 8-point algorithm with rank-2 enforcement: x1, x2
    [..., M >= 8, 2] -> F [..., 3, 3]."""
    x1n, T1 = normalize_points(x1)
    x2n, T2 = normalize_points(x2)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    f = _null_vector(A)
    uf, sf, vtf = torch.linalg.svd(f)
    sf = torch.cat([sf[..., :2], torch.zeros_like(sf[..., 2:])], dim=-1)
    f2 = uf @ (sf[..., None] * vtf)
    return T2.transpose(-1, -2) @ f2 @ T1


def homography_dlt(x1, x2):
    """DLT homography mapping x1 -> x2 from >= 4 points [..., M, 2]."""
    x1n, T1 = normalize_points(x1)
    x2n, T2 = normalize_points(x2)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    h = _null_vector(torch.cat([r1, r2], dim=-2))
    Hn = torch.linalg.solve_ex(T2, h).result @ T1
    h22 = Hn[..., 2:3, 2:3]
    return Hn / torch.where(torch.abs(h22) < 1e-12,
                            torch.full_like(h22, 1e-12), h22)


def _apply_h(H, x):
    xh = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    y = xh @ H.transpose(-1, -2)
    w = y[..., 2]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return y[..., :2] / w[..., None]


def score_homography(H, x1, x2, mask, sigma: float = 1.0, th: float = 5.991):
    """Symmetric transfer error score (reference CheckHomography):
    (score [...], inlier mask [..., N])."""
    Hinv = torch.linalg.inv_ex(H).inverse
    inv_sigma2 = 1.0 / (sigma * sigma)
    d12 = torch.sum((_apply_h(H, x1) - x2) ** 2, dim=-1) * inv_sigma2
    d21 = torch.sum((_apply_h(Hinv, x2) - x1) ** 2, dim=-1) * inv_sigma2
    in12, in21 = d12 < th, d21 < th
    sc = (torch.where(in12, th - d12, 0.0)
          + torch.where(in21, th - d21, 0.0))
    return torch.sum(sc * mask, dim=-1), in12 & in21 & (mask > 0)


def score_fundamental(F, x1, x2, mask, sigma: float = 1.0):
    """Point-to-epipolar-line chi2 score (reference CheckFundamental): 1-dof
    gate 3.841 per direction, scored against 5.991."""
    th, th_score = 3.841, 5.991
    inv_sigma2 = 1.0 / (sigma * sigma)
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    l2 = x1h @ F.transpose(-1, -2)                    # lines in image 2
    l1 = x2h @ F                                      # lines in image 1
    d2 = torch.sum(l2 * x2h, dim=-1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * x1h, dim=-1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    c2, c1 = d2 * inv_sigma2, d1 * inv_sigma2
    sc = (torch.where(c2 < th, th_score - c2, 0.0)
          + torch.where(c1 < th, th_score - c1, 0.0))
    return torch.sum(sc * mask, dim=-1), (c1 < th) & (c2 < th) & (mask > 0)


def essential_from_fundamental(F, K):
    return K.transpose(-1, -2) @ F @ K


def _w_matrix(E):
    return consts.const(
        ("twoview_W", E.dtype), E.device, lambda: torch.tensor(
            [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
            dtype=E.dtype))


def decompose_E(E):
    """E -> the 4 candidates [(R1, t), (R1, -t), (R2, t), (R2, -t)]:
    R [..., 4, 3, 3], t [..., 4, 3] (unit norm)."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.where(torch.linalg.det(u) < 0, -1.0, 1.0)[..., None, None]
    vt = vt * torch.where(torch.linalg.det(vt) < 0, -1.0,
                          1.0)[..., None, None]
    W = _w_matrix(E)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                        min=1e-12)
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def decompose_H(H, K):
    """Faugeras-Lustman decomposition of a Euclidean homography into 8
    candidate (R, t) (reference ReconstructH): R [..., 8, 3, 3],
    t [..., 8, 3] (unit norm)."""
    A = torch.linalg.solve_ex(K, H).result @ K        # K^-1 H K
    u, s, vt = torch.linalg.svd(A)
    d1, d2, d3 = s[..., 0], s[..., 1], s[..., 2]
    sgn = torch.linalg.det(u) * torch.linalg.det(vt)
    d1s = torch.where(torch.abs(d1 - d3) < 1e-12, d1 + 1e-6, d1)
    x1 = torch.sqrt(torch.clamp((d1s * d1s - d2 * d2)
                                / (d1s * d1s - d3 * d3), min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3)
                                / (d1s * d1s - d3 * d3), min=0.0))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    e1l = (1.0, -1.0, 1.0, -1.0)
    e3l = (1.0, 1.0, -1.0, -1.0)
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)
    outs_R, outs_t = [], []
    # d' = +d2, then d' = -d2
    for plus in (True, False):
        den = torch.clamp(((d1 + d3) if plus else (d1 - d3)) * d2, min=1e-12)
        sin_ = root / den
        cos_ = ((d2 * d2 + d1 * d3) if plus else (d1 * d3 - d2 * d2)) / den
        for e1, e3 in zip(e1l, e3l):
            st = e1 * e3 * sin_
            if plus:
                Rp = torch.stack([
                    torch.stack([cos_, zero, -st], dim=-1),
                    torch.stack([zero, one, zero], dim=-1),
                    torch.stack([st, zero, cos_], dim=-1)], dim=-2)
                tp = torch.stack([e1 * x1, zero, -e3 * x3], dim=-1) * (
                    d1 - d3)[..., None]
            else:
                Rp = torch.stack([
                    torch.stack([cos_, zero, st], dim=-1),
                    torch.stack([zero, -one, zero], dim=-1),
                    torch.stack([st, zero, -cos_], dim=-1)], dim=-2)
                tp = torch.stack([e1 * x1, zero, e3 * x3], dim=-1) * (
                    d1 + d3)[..., None]
            outs_R.append(sgn[..., None, None] * (u @ Rp @ vt))
            outs_t.append((u @ tp[..., None])[..., 0])
    Rs = torch.stack(outs_R, dim=-3)
    ts = torch.stack(outs_t, dim=-2)
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    return Rs, ts


def check_rt(R, t, xn1, xn2, mask, reproj_th: float = 4.0 / 500.0**2,
             min_parallax_cos: float = 0.99998):
    """Triangulated matches passing cheirality, reprojection and parallax
    (reference CheckRT, Initializer.cc:865), in normalized coordinates.
    R, t: pose of camera 2 w.r.t. camera 1, [..., 3, 3] / [..., 3];
    xn1, xn2 [..., N, 2]; mask [..., N]. Returns (n_good [...], good
    [..., N], xyz [..., N, 3], parallax cosines [..., N])."""
    n = xn1.shape[-2]
    batch = R.shape[:-2]
    Rb = R[..., None, :, :].expand(batch + (n, 3, 3))
    tb = t[..., None, :].expand(batch + (n, 3))
    eyeb = torch.eye(3, dtype=R.dtype, device=R.device).expand(Rb.shape)
    xyz = triangulate_dlt(eyeb, torch.zeros_like(tb), Rb, tb, xn1, xn2)
    finite = torch.isfinite(xyz).all(dim=-1)
    z1 = xyz[..., 2]
    p2 = (Rb @ xyz[..., None])[..., 0] + tb
    z2 = p2[..., 2]

    def safe(z):
        return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)

    e1 = torch.sum((xyz[..., :2] / safe(z1)[..., None] - xn1) ** 2, dim=-1)
    e2 = torch.sum((p2[..., :2] / safe(z2)[..., None] - xn2) ** 2, dim=-1)
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    pcos = parallax_cos(torch.zeros_like(c2)[..., None, :], c2[..., None, :],
                        xyz)
    good = (finite & (z1 > 0) & (z2 > 0) & (e1 < reproj_th)
            & (e2 < reproj_th) & (mask > 0))
    n_good = torch.sum(good & (pcos < min_parallax_cos), dim=-1)
    return n_good, good, xyz, pcos
