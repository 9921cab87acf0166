"""Batched RANSAC PnP: a camera pose from 2D-3D matches.

Port of orb_slam2_aruco_tpu/optim/pnp.py (PnPsolver, reference
src/PnPsolver.cc, used by BoW relocalization, Tracking.cc:1788). Every
hypothesis subset is solved at once by two minimal solvers, the 6-point
projection DLT (general scenes) and a homography decomposition (planar
scenes, where the DLT is degenerate), all are scored against all points,
and the best is returned for the pose LM to refine.

The subsets are `jax.random.choice`'s draws, bit for bit
(`utils.threefry.choice_p`). One departure (ROADMAP.md C2): the JAX
package's planar solver builds its plane basis [e1, e2, n] from `eigh`
without fixing its handedness, so some of its planar hypotheses come out
as reflections (det R = -1; 151 of 256 on tests/test_optim.py's scene),
which a planar scene cannot tell from the true pose. Here n = sign * n
gives the basis det +1 and R a rotation; the other hypotheses are the
reference's.

On the card `svd` and `eigh` check their solver's error code on the host
(there is no `_ex` form): `ransac_pnp` makes nine such synchronizing
calls, two for each of its four batched SVDs and one for its eigh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_aruco_tpu_torch.geometry import camera as cam_mod
from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.utils import threefry


class PnPResult(NamedTuple):
    ok: torch.Tensor
    Rcw: torch.Tensor
    tcw: torch.Tensor
    inliers: torch.Tensor     # [N]
    n_inliers: torch.Tensor


def det3(M):
    """Determinant of [..., 3, 3] by the triple product (no solver)."""
    return torch.sum(M[..., :, 0] * torch.linalg.cross(M[..., :, 1],
                                                       M[..., :, 2]), dim=-1)


def _median(x):
    """jnp.median over the last axis: the mean of the two middle values
    for an even count (torch.median takes the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def _null_rows(A, k: int):
    """Row k of V^T of the full SVD of A: the null vector of the system."""
    return torch.linalg.svd(A, full_matrices=True)[2][..., k, :]


def _dlt_pose(xyz, xn):
    """Projection-matrix DLT from >= 6 pairs, batched: world points
    [..., S, 3], normalized image points [..., S, 2] -> (R, t)."""
    X, Y, Z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    o, z = torch.ones_like(X), torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, o, z, z, z, z, -u * X, -u * Y, -u * Z, -u], -1)
    r2 = torch.stack([z, z, z, z, X, Y, Z, o, -v * X, -v * Y, -v * Z, -v], -1)
    P = _null_rows(torch.cat([r1, r2], dim=-2), 11).reshape(
        xyz.shape[:-2] + (3, 4))
    # sign: points in front for the majority
    depth = xyz @ P[..., 2, :3, None] + P[..., 2, 3, None, None]
    sgn = torch.where(_median(depth[..., 0]) < 0, -1.0, 1.0)
    P = P * sgn[..., None, None]
    um, sm, vmt = torch.linalg.svd(P[..., :3])
    R = um @ vmt
    flip = torch.where(det3(R) < 0, -1.0, 1.0)
    R = R * flip[..., None, None]
    t = P[..., 3] / torch.clamp(sm.mean(dim=-1), min=1e-12)[..., None]
    return R, t * flip[..., None]


def _planar_pose(xyz, xn):
    """Homography-decomposition pose from >= 4 near-coplanar world points,
    batched (Zhang): fit the subset's plane, take the plane -> normalized
    image homography by 2D DLT, decompose H ~ [r1 r2 t]."""
    c = xyz.mean(dim=-2, keepdim=True)
    d = xyz - c
    _, evecs = torch.linalg.eigh(d.transpose(-1, -2) @ d)   # ascending
    e1, e2 = evecs[..., :, 2], evecs[..., :, 1]
    # a right-handed basis [e1, e2, n]: R below is then a rotation
    n = evecs[..., :, 0]
    n = n * torch.where(det3(torch.stack([e1, e2, n], -1)) < 0,
                        -1.0, 1.0)[..., None]
    X = (d @ e1[..., None])[..., 0]
    Y = (d @ e2[..., None])[..., 0]
    u, v = xn[..., 0], xn[..., 1]
    o, z = torch.ones_like(X), torch.zeros_like(X)
    r1 = torch.stack([X, Y, o, z, z, z, -u * X, -u * Y, -u], -1)
    r2 = torch.stack([z, z, z, X, Y, o, -v * X, -v * Y, -v], -1)
    H = _null_rows(torch.cat([r1, r2], dim=-2), 8).reshape(
        xyz.shape[:-2] + (3, 3))
    lam = 0.5 * (torch.linalg.norm(H[..., :, 0], dim=-1)
                 + torch.linalg.norm(H[..., :, 1], dim=-1))
    H = H / torch.clamp(lam, min=1e-12)[..., None, None]
    H = H * torch.where(H[..., 2, 2] < 0, -1.0, 1.0)[..., None, None]
    h1, h2, th = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    Q = torch.stack([h1, h2, torch.linalg.cross(h1, h2)], dim=-1)
    uq, _, vqt = torch.linalg.svd(Q)
    Rh = uq @ vqt
    Rh = Rh * torch.where(det3(Rh) < 0, -1.0, 1.0)[..., None, None]
    R = Rh @ torch.stack([e1, e2, n], dim=-1).transpose(-1, -2)
    return R, th - (R @ c[..., 0, :, None])[..., 0]


def hypotheses(xyz, uv, mask, cam: Camera, num_hypotheses: int = 256,
               subset: int = 6, seed: int = 0):
    """(sets [H, subset], R [2H, 3, 3], t [2H, 3]): the drawn subsets and
    their DLT hypotheses, then their planar ones."""
    w = mask.to(torch.float32)
    p = w / torch.clamp(w.sum(), min=1.0)
    sets = threefry.choice_p(threefry.PRNGKey(seed),
                             (num_hypotheses, subset), p)
    xn = cam_mod.pixels_to_normalized(cam, uv)
    R_d, t_d = _dlt_pose(xyz[sets], xn[sets])
    R_p, t_p = _planar_pose(xyz[sets], xn[sets])
    return sets, torch.cat([R_d, R_p]), torch.cat([t_d, t_p])


def score(R, t, xyz, uv, mask, cam: Camera, chi2_th: float = 5.991):
    """[H, N] bool: the points each hypothesis explains (reprojection error
    below chi2_th px^2, in front of the camera)."""
    p_cam = torch.einsum("hij,nj->hni", R, xyz) + t[:, None]
    err2 = torch.sum((cam_mod.project(cam, p_cam) - uv[None]) ** 2, dim=-1)
    return (err2 < chi2_th) & (p_cam[..., 2] > 0.02) & mask[None]


def ransac_pnp(xyz, uv, mask, cam: Camera, num_hypotheses: int = 256,
               subset: int = 6, chi2_th: float = 5.991, min_inliers: int = 10,
               seed: int = 0) -> PnPResult:
    """The best of all hypotheses over world points xyz [N, 3], undistorted
    pixels uv [N, 2] and validity mask [N]; ok if it explains at least
    `min_inliers` points."""
    _, R, t = hypotheses(xyz, uv, mask, cam, num_hypotheses, subset, seed)
    ok_pt = score(R, t, xyz, uv, mask.bool(), cam, chi2_th)
    scores = ok_pt.sum(dim=-1)
    # the best as a 1-element index: a 0-d device index reads on the host
    best = torch.argmax(scores).reshape(1)
    n = scores.index_select(0, best)[0]
    return PnPResult(ok=n >= min_inliers, Rcw=R.index_select(0, best)[0],
                     tcw=t.index_select(0, best)[0],
                     inliers=ok_pt.index_select(0, best)[0], n_inliers=n)
