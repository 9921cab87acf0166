"""Relative Sim3 optimization between two keyframes (loop closing).

Port of orb_slam2_aruco_tpu/optim/sim3_opt.py (Optimizer::OptimizeSim3,
reference src/Optimizer.cc:1544-1739): one Sim3 vertex with a forward and
an inverse reprojection edge per point match; an LM phase, a prune at
chi2 > 10, a second phase on the survivors. The 7-column Jacobian of the
left-multiplicative update comes from forward-mode autodiff
(`lm.jacobian_fwd`), as the JAX package's `jax.jacfwd`. Both phases run
their fixed iteration count with masked updates, as the JAX `fori_loop`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.lie import (
    sim3_apply,
    sim3_compose,
    sim3_exp,
    sim3_inverse,
)
from orb_slam2_aruco_tpu_torch.optim.lm import jacobian_fwd, solve_damped
from orb_slam2_aruco_tpu_torch.optim.residuals import (
    huber_weight,
    project_pinhole,
)
from orb_slam2_aruco_tpu_torch.utils.consts import const


def _scale_free(device):
    """[7] 1 for the translation and rotation rows, 0 for sigma."""
    return const("sim3_scale_free", device,
                 lambda: np.array([1.0] * 6 + [0.0], np.float32))


class Sim3Result(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _residuals(xi, s0, R0, t0, p1, p2, uv1, uv2, cam: Camera):
    """([N, 4] forward residual (S12 p2 in image 1) beside the inverse one
    (S12^-1 p1 in image 2), [N] both in front), at the update xi [1, 7]
    (the Sim3 keeps that axis: s [1], R [1, 3, 3], t [1, 3])."""
    s, R, t = sim3_compose(*sim3_exp(xi), s0, R0, t0)
    si, Ri, ti = sim3_inverse(s, R, t)
    q1 = sim3_apply(s, R, t, p2)
    q2 = sim3_apply(si, Ri, ti, p1)
    r1 = uv1 - project_pinhole(q1, cam.fx, cam.fy, cam.cx, cam.cy)
    r2 = uv2 - project_pinhole(q2, cam.fx, cam.fy, cam.cx, cam.cy)
    front = (q1[..., 2] > 0.02) & (q2[..., 2] > 0.02)
    return torch.cat([r1, r2], dim=-1), front


def optimize_sim3(s0, R0, t0, p1, p2, uv1, uv2, mask, inv_sigma2_1,
                  inv_sigma2_2, cam: Camera, fix_scale: bool = False,
                  chi2_th: float = 10.0, iters_first: int = 5,
                  iters_second: int = 10,
                  huber_delta: float = 3.1623) -> Sim3Result:
    """S12 from matched points p1 [N, 3] (KF1 camera frame) and p2 (KF2
    camera frame) with their observations uv1 / uv2 [N, 2], validity mask
    [N] and per-observation information; seeded at (s0, R0, t0)."""
    mask = mask.to(torch.float32)
    # the update with a leading axis of 1 (lm.jacobian_fwd)
    zero = torch.zeros((1, 7), dtype=p1.dtype, device=p1.device)

    def edge_chi2(s, R, t):
        r, valid = _residuals(zero, s, R, t, p1, p2, uv1, uv2, cam)
        return (torch.sum(r[..., :2] ** 2, dim=-1) * inv_sigma2_1,
                torch.sum(r[..., 2:] ** 2, dim=-1) * inv_sigma2_2, valid)

    def lm_phase(s, R, t, w_in, iters):
        c1, c2, valid = edge_chi2(s, R, t)
        chi2_cur = torch.sum((c1 + c2) * w_in * mask * valid)
        lam = torch.full((), 1e-3, dtype=torch.float32, device=p1.device)
        for _ in range(iters):
            r, valid = _residuals(zero, s, R, t, p1, p2, uv1, uv2, cam)
            J = jacobian_fwd(lambda xi: _residuals(
                xi, s, R, t, p1, p2, uv1, uv2, cam)[0], zero)    # [N, 4, 7]
            vw = w_in * mask * valid
            c1 = torch.sum(r[..., :2] ** 2, dim=-1) * inv_sigma2_1
            c2 = torch.sum(r[..., 2:] ** 2, dim=-1) * inv_sigma2_2
            w1 = vw * inv_sigma2_1 * huber_weight(c1, huber_delta)
            w2 = vw * inv_sigma2_2 * huber_weight(c2, huber_delta)
            wfull = torch.stack([w1, w1, w2, w2], dim=1)           # [N, 4]
            Jw = J * wfull[..., None]
            H = torch.einsum("nei,nej->ij", Jw, J)
            b = -torch.einsum("nei,ne->i", Jw, r)
            if fix_scale:
                # the sigma row and column out; a unit diagonal keeps the
                # system solvable (masks, not element writes: writing a
                # Python number into a device tensor synchronizes)
                m = _scale_free(H.device)
                H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
                b = b * m
            ds_, dR_, dt_ = sim3_exp(solve_damped(H, b, lam))
            sn, Rn, tn = sim3_compose(ds_, dR_, dt_, s, R, t)
            c1n, c2n, _ = edge_chi2(sn, Rn, tn)
            chi2_new = torch.sum((c1n + c2n) * vw)
            accept = chi2_new < chi2_cur
            s = torch.where(accept, sn, s)
            R = torch.where(accept, Rn, R)
            t = torch.where(accept, tn, t)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0),
                              1e-9, 1e6)
            chi2_cur = torch.where(accept, chi2_new, chi2_cur)
        return s, R, t

    s, R, t = lm_phase(s0, R0, t0, torch.ones_like(mask), iters_first)
    c1, c2, valid = edge_chi2(s, R, t)
    w = ((c1 < chi2_th) & (c2 < chi2_th) & valid).to(torch.float32)
    s, R, t = lm_phase(s, R, t, w, iters_second)
    c1, c2, valid = edge_chi2(s, R, t)
    inl = (c1 < chi2_th) & (c2 < chi2_th) & valid & (mask > 0)
    return Sim3Result(s=s, R=R, t=t, inliers=inl, n_inliers=inl.sum())
