"""Pose-only optimization with point + fixed-marker corner edges.

Port of orb_slam2_aruco_tpu/optim/pose_opt.py (reference
Optimizer::PoseOptimization, src/Optimizer.cc:308-520, and
PoseOptimizationByAruco, :522-770): 4 rounds x up to 10 LM iterations, chi2
reclassification (5.991) after each round, Huber kernel for the first two
rounds, marker corners as fixed edges with information w = 25.

`optimize_pose` runs the whole LM as one launch of the hand-written CUDA
kernel K5 (kernels/csrc/pose_lm.cu) on CUDA tensors, and the plain PyTorch
version `optimize_pose_torch` on CPU tensors; a build or launch failure
raises. `LM_CALLS` counts the calls by route. Every call is the span
pose_lm (utils/telemetry.py).

The JAX loop stops a round after two stalled iterations (a `while_loop`),
as the kernel does. The plain version runs every round's full iteration
budget with the updates masked off once the round has stalled: the same
poses, and no host sync per iteration. Its point and marker-corner edges
share one edge array; the residuals at the current pose are carried from
the iteration that accepted it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.lie import (
    orthonormalize,
    se3_compose,
    se3_exp,
)
from orb_slam2_aruco_tpu_torch.optim import residuals as res
from orb_slam2_aruco_tpu_torch.optim.lm import solve_damped
from orb_slam2_aruco_tpu_torch.utils.telemetry import annotate

# calls of optimize_pose by route since the process started: the kernel
# (CUDA tensors) and the plain version (CPU tensors); readers take
# differences
LM_CALLS = {"kernel": 0, "plain": 0}


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
    """The pose LM of one problem: kernel K5 on CUDA tensors, the plain
    version on CPU tensors."""
    args = (Rcw0, tcw0, cam, pts_w, uv, mask, inv_sigma2, marker_corners_w,
            marker_uv, marker_mask, marker_weight, chi2_th, huber_delta,
            rounds, iters_per_round, lam0)
    if pts_w.device.type == "cuda":
        out = optimize_pose_cuda(*args)
        LM_CALLS["kernel"] += 1
        return out
    LM_CALLS["plain"] += 1
    return optimize_pose_torch(*args)


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"optimize_pose_cuda: {name} must be a tensor")
    if t.dtype != dtype:
        raise ValueError(f"optimize_pose_cuda: {name} is {t.dtype}, not "
                         f"{dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"optimize_pose_cuda: {name} has shape "
                         f"{tuple(t.shape)}, not {shape}")
    if not t.is_contiguous():
        raise ValueError(f"optimize_pose_cuda: {name} is not contiguous")
    if t.device != device:
        raise ValueError(f"optimize_pose_cuda: {name} is on {t.device}, not "
                         f"{device}")


def optimize_pose_cuda(Rcw0, tcw0, cam: Camera, pts_w, uv, mask, inv_sigma2,
                       marker_corners_w=None, marker_uv=None,
                       marker_mask=None, marker_weight: float = 25.0,
                       chi2_th: float = 5.991, huber_delta: float = 2.4477,
                       rounds: int = 4, iters_per_round: int = 10,
                       lam0: float = 1e-3) -> PoseOptResult:
    """Launch kernel K5 (kernels/csrc/pose_lm.cu): the whole LM of
    optimize_pose_torch in one launch on the current stream, no host sync.
    Takes contiguous CUDA tensors on one device, float32 and the masks
    bool, and raises on anything else."""
    f32, masks = torch.float32, torch.bool
    n = pts_w.shape[0] if pts_w.dim() == 2 else -1
    dev = pts_w.device
    _check("pts_w", pts_w, f32, (n, 3), dev)
    _check("Rcw0", Rcw0, f32, (3, 3), dev)
    _check("tcw0", tcw0, f32, (3,), dev)
    _check("uv", uv, f32, (n, 2), dev)
    _check("mask", mask, masks, (n,), dev)
    _check("inv_sigma2", inv_sigma2, f32, (n,), dev)
    for name in ("fx", "fy", "cx", "cy"):
        _check(f"cam.{name}", getattr(cam, name), f32, (), dev)
    marker = (marker_corners_w, marker_uv, marker_mask)
    if any(m is None for m in marker) and not all(m is None for m in marker):
        raise ValueError("optimize_pose_cuda: give marker_corners_w, "
                         "marker_uv and marker_mask together, or none")
    n_mk = 0
    if marker_corners_w is not None:
        n_mk = (marker_corners_w.shape[0]
                if marker_corners_w.dim() == 3 else -1)
        _check("marker_corners_w", marker_corners_w, f32, (n_mk, 4, 3), dev)
        _check("marker_uv", marker_uv, f32, (n_mk, 4, 2), dev)
        _check("marker_mask", marker_mask, masks, (n_mk,), dev)
    if dev.type != "cuda":
        raise ValueError("optimize_pose_cuda takes CUDA tensors")
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((3,), dtype=torch.float32, device=dev)
    inliers = torch.empty((n,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int64, device=dev)
    chi2 = torch.empty((), dtype=torch.float32, device=dev)
    ptr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    err = kernels.build.launcher("pose_lm")(
        Rcw0.data_ptr(), tcw0.data_ptr(), cam.fx.data_ptr(),
        cam.fy.data_ptr(), cam.cx.data_ptr(), cam.cy.data_ptr(),
        pts_w.data_ptr(), uv.data_ptr(), mask.data_ptr(),
        inv_sigma2.data_ptr(), n, ptr(marker_corners_w), ptr(marker_uv),
        ptr(marker_mask), n_mk, float(marker_weight),
        float(chi2_th), float(huber_delta), float(lam0), int(rounds),
        int(iters_per_round), R.data_ptr(), t.data_ptr(),
        inliers.data_ptr(), n_inliers.data_ptr(), chi2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch("pose_lm", err)
    return PoseOptResult(Rcw=R, tcw=t, inliers=inliers, n_inliers=n_inliers,
                         chi2=chi2)


def optimize_pose_torch(Rcw0, tcw0, cam: Camera, pts_w, uv, mask,
                        inv_sigma2, marker_corners_w=None, marker_uv=None,
                        marker_mask=None, marker_weight: float = 25.0,
                        chi2_th: float = 5.991, huber_delta: float = 2.4477,
                        rounds: int = 4, iters_per_round: int = 10,
                        lam0: float = 1e-3) -> PoseOptResult:
    """Plain PyTorch version of optimize_pose (the CPU route)."""
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
