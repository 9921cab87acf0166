"""Sim3 pose-graph (essential graph) optimization for loop correction.

Port of orb_slam2_aruco_tpu/optim/pose_graph.py
(Optimizer::OptimizeEssentialGraph, reference src/Optimizer.cc:1245-1542):
one Sim3 vertex per keyframe, edges with measured relative Sim3s,
Gauss-Newton with a tiny damping for a fixed iteration count, fixed
vertices held by unit rows. The edge residual is
r = log(S_m exp(xi_i) S_iw (exp(xi_j) S_jw)^-1); its [7, 7] Jacobians come
from forward-mode autodiff over all edges at once (`lm.jacobian_fwd`, the
JAX package's `jax.vmap` of `jax.jacfwd`). The dense normal system over 7K
variables is Cholesky-solved (`cholesky_ex`: a failed factor is a zero
step, as the JAX package's non-finite guard makes it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_aruco_tpu_torch.geometry.lie import (
    sim3_compose,
    sim3_exp,
    sim3_inverse,
    sim3_log,
)
from orb_slam2_aruco_tpu_torch.optim.lm import jacobian_fwd
from orb_slam2_aruco_tpu_torch.optim.sim3_opt import _scale_free


class PoseGraphResult(NamedTuple):
    s: torch.Tensor   # [K]
    R: torch.Tensor   # [K, 3, 3]
    t: torch.Tensor   # [K, 3]
    chi2: torch.Tensor


def _edge_residual(xis, s_i, R_i, t_i, s_j, R_j, t_j, sm, Rm, tm):
    """r = log(S_m (exp(xi_i) S_iw) (exp(xi_j) S_jw)^-1) [E, 7], with the
    updates xis [E, 14] = (xi_i, xi_j)."""
    si, Ri, ti = sim3_compose(*sim3_exp(xis[:, :7]), s_i, R_i, t_i)
    sj, Rj, tj = sim3_compose(*sim3_exp(xis[:, 7:]), s_j, R_j, t_j)
    se, Re, te = sim3_compose(si, Ri, ti, *sim3_inverse(sj, Rj, tj))
    return sim3_log(*sim3_compose(sm, Rm, tm, se, Re, te))


def _seg_sum(ids, n: int, vals):
    return vals.new_zeros((n,) + vals.shape[1:]).index_add_(0, ids, vals)


def optimize_pose_graph(s, R, t, e_i, e_j, e_meas_s, e_meas_R, e_meas_t,
                        e_mask, free, iters: int = 20, lam: float = 1e-16,
                        fix_scale: bool = False) -> PoseGraphResult:
    """Vertices (s [K], R [K, 3, 3], t [K, 3]) as S_iw (world -> keyframe);
    edges (e_i, e_j) [E] with measurements S_m = S_jw S_wi at the solution
    (g2o EdgeSim3 with vertices (i, j)) and weights e_mask [E]; free [K] 1
    for free vertices, 0 for fixed ones. `fix_scale` holds every sigma at
    0 (bFixScale for marker maps)."""
    K = s.shape[0]
    dev, f32 = t.device, t.dtype
    zero2 = torch.zeros((e_i.shape[0], 14), dtype=f32, device=dev)
    free_vec = free.repeat_interleave(7)
    if fix_scale:
        free_vec = free_vec * _scale_free(dev).repeat(K)
    ii = torch.arange(K, device=dev)
    w = e_mask

    def args(s, R, t):
        return (s[e_i], R[e_i], t[e_i], s[e_j], R[e_j], t[e_j],
                e_meas_s, e_meas_R, e_meas_t)

    for _ in range(iters):
        a = args(s, R, t)
        r = _edge_residual(zero2, *a)                         # [E, 7]
        J = jacobian_fwd(lambda x: _edge_residual(x, *a), zero2)  # [E, 7, 14]
        Ji = J[..., :7] * free[e_i][:, None, None]
        Jj = J[..., 7:] * free[e_j][:, None, None]
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        H = torch.zeros((K, K, 7, 7), dtype=f32, device=dev)
        H[ii, ii] += (_seg_sum(e_i, K, Jiw.transpose(1, 2) @ Ji)
                      + _seg_sum(e_j, K, Jjw.transpose(1, 2) @ Jj))
        Hij = _seg_sum(e_i * K + e_j, K * K,
                       Jiw.transpose(1, 2) @ Jj).reshape(K, K, 7, 7)
        H = H + Hij + Hij.transpose(0, 1).transpose(-1, -2)
        b = -(_seg_sum(e_i, K, (Jiw.transpose(1, 2) @ r[..., None])[..., 0])
              + _seg_sum(e_j, K, (Jjw.transpose(1, 2) @ r[..., None])[..., 0]))
        Hd = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        Hd = Hd * free_vec[:, None] * free_vec[None, :]
        d = torch.clamp(torch.diagonal(Hd), min=1e-12)
        Hd = Hd + torch.diag(lam * d + 1e-8 + (1.0 - free_vec))
        Lc, info = torch.linalg.cholesky_ex(Hd)
        dx = torch.cholesky_solve((b.reshape(-1) * free_vec)[:, None],
                                  Lc)[:, 0]
        dx = torch.where((info == 0) & torch.isfinite(dx), dx, 0.0)
        s, R, t = sim3_compose(*sim3_exp(dx.reshape(K, 7)), s, R, t)
    r = _edge_residual(zero2, *args(s, R, t))
    chi2 = torch.sum(torch.sum(r * r, dim=-1) * e_mask)
    return PoseGraphResult(s=s, R=R, t=t, chi2=chi2)
