"""Bundle adjustment via Schur-complement Levenberg–Marquardt.

Port of orb_slam2_aruco_tpu/optim/ba.py (g2o BlockSolver_6_3 as used by
Optimizer::{LocalBundleAdjustment, GlobalBundleAdjustemnt}, reference
src/Optimizer.cc:50-307, 772-1242, with the MapAruco SE3 vertices and their
4 corner edges at weight 25, Optimizer.cc:168-234). Observations are flat
padded edge lists; points are marginalized per 3x3 block; cameras and
markers form the reduced system. Two solvers, as in the JAX package: the
dense branch assembles it and Cholesky-solves it (local BA windows); the
CG branch never forms it and runs a block-Jacobi preconditioned CG whose
Schur matvec is two segment sums over the edges (whole-map BA, K > 32).

Departures from the JAX package, outputs unchanged:
  * segment sums are `index_add_` (the JAX package sorts once and replays
    cumsum differences); the sums are the same up to float32 summation
    order;
  * the LM loop runs its full iteration budget with the updates masked off
    once it has stalled twice (the JAX `while_loop` stops there): the same
    states, and no host read per iteration;
  * a failed Cholesky (`cholesky_ex` info != 0) gives a zero step, as the
    JAX package's NaN factor does through its isfinite guard;
  * the CG `while_loop` (at most cg_iters steps, stopping once the
    preconditioned residual falls below its tolerance) runs cg_iters steps
    with the updates masked off once it has converged: the same iterates,
    and no host read per step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.lie import se3_compose, se3_exp
from orb_slam2_aruco_tpu_torch.geometry.triangulate import inv3x3_adjugate
from orb_slam2_aruco_tpu_torch.optim import residuals as res
from orb_slam2_aruco_tpu_torch.optim.lm import diag_embed

# the largest camera count "auto" gives the dense branch (ba.py:247)
DENSE_MAX_CAMS = 32


class BAProblem(NamedTuple):
    """K cameras, L points, M markers, E point edges, F marker corner edges
    (4 per camera-marker observation)."""

    Rcw: torch.Tensor           # [K, 3, 3]
    tcw: torch.Tensor           # [K, 3]
    points: torch.Tensor        # [L, 3]
    Rwm: torch.Tensor           # [M, 3, 3]
    twm: torch.Tensor           # [M, 3]
    marker_side: torch.Tensor   # [M]
    e_kf: torch.Tensor          # [E] camera index
    e_pt: torch.Tensor          # [E] point index
    e_uv: torch.Tensor          # [E, 2]
    e_info: torch.Tensor        # [E] 1 / sigma^2
    e_mask: torch.Tensor        # [E] float validity
    m_kf: torch.Tensor          # [F]
    m_marker: torch.Tensor      # [F]
    m_corner: torch.Tensor      # [F] 0..3
    m_uv: torch.Tensor          # [F, 2]
    m_info: torch.Tensor        # [F]
    m_mask: torch.Tensor        # [F]
    cam_free: torch.Tensor      # [K] 1 free / 0 fixed
    pt_free: torch.Tensor       # [L]
    marker_free: torch.Tensor   # [M]


class BAResult(NamedTuple):
    Rcw: torch.Tensor
    tcw: torch.Tensor
    points: torch.Tensor
    Rwm: torch.Tensor
    twm: torch.Tensor
    chi2: torch.Tensor
    edge_chi2: torch.Tensor     # [E] final chi2 per point edge
    medge_chi2: torch.Tensor    # [F]


def _corner_local(side, corner):
    """Marker-frame corners [F, 3] (MapAruco.cc:30-37 order)."""
    h = side / 2.0
    sx = torch.where((corner == 1) | (corner == 2), 1.0, -1.0)
    sy = torch.where(corner <= 1, 1.0, -1.0)
    return torch.stack([sx * h, sy * h, torch.zeros_like(h)], dim=-1)


def _marker_corners_world(p: BAProblem):
    cl = _corner_local(p.marker_side[p.m_marker], p.m_corner)
    return ((p.Rwm[p.m_marker] @ cl[..., None])[..., 0]
            + p.twm[p.m_marker])


def _reproj(Rcw, tcw, X, uv, cam: Camera):
    """Per-edge residual uv - proj(R X + t) [E, 2] and camera-frame point
    [E, 3] (one pose per edge)."""
    pc = (Rcw @ X[..., None])[..., 0] + tcw
    return uv - res.project_pinhole(pc, cam.fx, cam.fy, cam.cx, cam.cy), pc


def _point_edge_terms(p: BAProblem, cam: Camera, huber_delta,
                      use_huber=True):
    Rcw = p.Rcw[p.e_kf]
    r, pc = _reproj(Rcw, p.tcw[p.e_kf], p.points[p.e_pt], p.e_uv, cam)
    Jc = res.jac_pose(pc, cam.fx, cam.fy, cam.cx, cam.cy)
    Jp = res.jac_point(pc, Rcw, cam.fx, cam.fy, cam.cx, cam.cy)
    chi2 = torch.sum(r * r, dim=-1) * p.e_info
    hw = (res.huber_weight(chi2, huber_delta) if use_huber
          else torch.ones_like(chi2))
    w = p.e_mask * p.e_info * hw
    w = torch.where(pc[..., 2] <= 0.02, 0.0, w)
    Jc = Jc * p.cam_free[p.e_kf][:, None, None]
    Jp = Jp * p.pt_free[p.e_pt][:, None, None]
    return r, Jc, Jp, w


def _marker_edge_terms(p: BAProblem, cam: Camera, huber_delta,
                       use_huber=True):
    Rcw = p.Rcw[p.m_kf]
    cw = _marker_corners_world(p)
    r, pc = _reproj(Rcw, p.tcw[p.m_kf], cw, p.m_uv, cam)
    Jc = res.jac_pose(pc, cam.fx, cam.fy, cam.cx, cam.cy)
    Jm = res.jac_marker_world(pc, Rcw, cw, cam.fx, cam.fy, cam.cx, cam.cy)
    chi2 = torch.sum(r * r, dim=-1) * p.m_info
    hw = (res.huber_weight(chi2, huber_delta) if use_huber
          else torch.ones_like(chi2))
    w = p.m_mask * p.m_info * hw
    w = torch.where(pc[..., 2] <= 0.02, 0.0, w)
    Jc = Jc * p.cam_free[p.m_kf][:, None, None]
    Jm = Jm * p.marker_free[p.m_marker][:, None, None]
    return r, Jc, Jm, w


def _total_chi2(p: BAProblem, cam: Camera):
    """(total chi2 over valid edges in front of their camera, per point-edge
    chi2 [E], per marker-edge chi2 [F])."""
    r, pc = _reproj(p.Rcw[p.e_kf], p.tcw[p.e_kf], p.points[p.e_pt], p.e_uv,
                    cam)
    c_e = torch.sum(r * r, dim=-1) * p.e_info
    valid_e = p.e_mask * (pc[..., 2] > 0.02)
    rm, pcm = _reproj(p.Rcw[p.m_kf], p.tcw[p.m_kf], _marker_corners_world(p),
                      p.m_uv, cam)
    c_m = torch.sum(rm * rm, dim=-1) * p.m_info
    valid_m = p.m_mask * (pcm[..., 2] > 0.02)
    return (torch.sum(c_e * valid_e) + torch.sum(c_m * valid_m)), c_e, c_m




# ---------------------------------------------------------------------------
# edge shards: the JAX solve's shard_map over a mesh axis, from one
# controller. Every edge-level term is computed on its shard's device; the
# shards' partial sums are added on the lead device in shard order (JAX's
# psum); the replicated state lives on the lead device and is copied to the
# others once per LM iteration. One shard is the single-device solve.
# ---------------------------------------------------------------------------

REPLICATED = ("Rcw", "tcw", "points", "Rwm", "twm", "marker_side",
              "cam_free", "pt_free", "marker_free")
POINT_EDGES = ("e_kf", "e_pt", "e_uv", "e_info", "e_mask")
MARKER_EDGES = ("m_kf", "m_marker", "m_corner", "m_uv", "m_info", "m_mask")
STATE = ("Rcw", "tcw", "points", "Rwm", "twm")


def shard_problem(p: BAProblem, mesh) -> list:
    """p's edge lists cut into len(mesh) equal contiguous shards (shard_map's
    split of a sharded axis): shard i holds its edges and a copy of the
    replicated fields on mesh[i]. The edge counts must divide by the mesh
    size (parallel.dist_ba.pad_edges_to)."""
    n = len(mesh)
    E, F = p.e_kf.shape[0], p.m_kf.shape[0]
    if E % n or F % n:
        raise ValueError(f"{E} point edges and {F} marker edges do not "
                         f"divide into {n} shards")
    out = []
    for i, dev in enumerate(mesh):
        f = {k: getattr(p, k).to(dev) for k in REPLICATED}
        f.update({k: getattr(p, k)[i * (E // n):(i + 1) * (E // n)].to(dev)
                  for k in POINT_EDGES})
        f.update({k: getattr(p, k)[i * (F // n):(i + 1) * (F // n)].to(dev)
                  for k in MARKER_EDGES})
        out.append(BAProblem(**f))
    return out


def _psum(parts):
    """The shards' partial sums added on the lead device in shard order
    (JAX's psum over the mesh axis); one shard's part is the sum."""
    out = parts[0]
    for x in parts[1:]:
        out = out + x.to(out.device)
    return out


def _on(devs, x):
    """Copies of tensor x on each shard's device (x itself on its own)."""
    return [x.to(d) for d in devs]


def to_device(x, dev):
    """A BAProblem or Camera with its tensors on `dev`."""
    return type(x)(*(f.to(dev) if isinstance(f, torch.Tensor) else f
                     for f in x))


def _seg_sum(ids, num_segments: int, vals):
    """out[s] = sum of vals[e] over ids[e] == s ([S, ...])."""
    out = vals.new_zeros((num_segments,) + vals.shape[1:])
    return out.index_add_(0, ids, vals)


def _quad(Ja, w, Jb):
    """Per-edge Ja^T w Jb: [E, 2, a], [E], [E, 2, b] -> [E, a, b]."""
    return (Ja * w[:, None, None]).transpose(-1, -2) @ Jb


def _grad(J, w, r):
    """Per-edge -J^T w r: [E, 2, a] -> [E, a]."""
    return -((J * w[:, None, None]).transpose(-1, -2) @ r[..., None])[..., 0]


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


class _Terms(NamedTuple):
    """One shard's edge-level terms at the current linearization point."""

    p: BAProblem                # the shard, with its copy of the state
    r_e: torch.Tensor
    Jc_e: torch.Tensor
    Jp_e: torch.Tensor
    w_e: torch.Tensor
    r_m: torch.Tensor
    Jc_m: torch.Tensor
    Jm_m: torch.Tensor
    w_m: torch.Tensor
    Wcp: torch.Tensor           # [E, 6, 3] camera-point coupling


def _dense_solve(lead: BAProblem, shards, lam, Hcc, Hmm, Hpp_inv, bc_red,
                 bm):
    """The reduced camera + marker system assembled densely and
    Cholesky-solved: (dxc [K, 6], dxm [M, 6])."""
    K, L, M = Hcc.shape[0], Hpp_inv.shape[0], Hmm.shape[0]
    D = 6 * (K + M)
    dev, f32 = Hcc.device, Hcc.dtype
    # S_cc = Hcc - sum_l W_kl Hpp_l^-1 W_k'l^T over [K, L] block matrices
    inv = _on([t.p.e_pt.device for t in shards], Hpp_inv)
    Wmat = _psum([_seg_sum(t.p.e_kf * L + t.p.e_pt, K * L, t.Wcp)
                  for t in shards]).reshape(K, L, 6, 3)
    Ymat = _psum([_seg_sum(t.p.e_kf * L + t.p.e_pt, K * L,
                           t.Wcp @ hi[t.p.e_pt])
                  for t, hi in zip(shards, inv)]).reshape(K, L, 6, 3)
    S_cc = -torch.einsum("alik,bljk->abij", Ymat, Wmat)           # [K,K,6,6]
    ar = torch.arange(K, device=dev)
    S_cc[ar, ar] += Hcc

    # dense system over cameras + markers, [K+M, K+M, 6, 6] blocks
    S = torch.zeros((K + M, K + M, 6, 6), dtype=f32, device=dev)
    S[:K, :K] = S_cc
    am = torch.arange(K, K + M, device=dev)
    S[am, am] += Hmm
    Hcm = _psum([_seg_sum(t.p.m_kf * M + t.p.m_marker, K * M,
                          _quad(t.Jc_m, t.w_m, t.Jm_m))
                 for t in shards]).reshape(K, M, 6, 6)
    S[:K, K:] += Hcm
    S[K:, :K] += Hcm.transpose(0, 1).transpose(-1, -2)
    b_all = torch.cat([bc_red, bm], dim=0)                        # [K+M, 6]

    Sd = S.permute(0, 2, 1, 3).reshape(D, D)
    diag = torch.clamp(torch.diagonal(Sd), min=1e-10)
    free = torch.cat([lead.cam_free.repeat_interleave(6),
                      lead.marker_free.repeat_interleave(6)])
    # fixed states: unit rows / columns and zero right-hand side -> dx = 0
    Sd = Sd * free[:, None] * free[None, :]
    Sd = Sd + torch.diag(lam * diag + 1e-8 + (1.0 - free))
    Lc, info = torch.linalg.cholesky_ex(Sd)
    dx = torch.cholesky_solve((b_all.reshape(D) * free)[:, None], Lc)[:, 0]
    dx = torch.where((info == 0) & torch.isfinite(dx), dx, 0.0)
    return dx[:6 * K].reshape(K, 6), dx[6 * K:].reshape(M, 6)


def _cg_solve(lead: BAProblem, shards, lam, Hcc, Hmm, Hpp_inv, bc_red, bm,
              cg_iters: int):
    """The reduced system solved matrix-free: block-Jacobi preconditioned
    CG whose products with the reduced matrix are taken edge by edge. At
    most cg_iters steps; converged steps are masked, not skipped. Returns
    (dxc [K, 6], dxm [M, 6])."""
    K, L, M = Hcc.shape[0], Hpp_inv.shape[0], Hmm.shape[0]
    devs = [t.p.e_pt.device for t in shards]
    free_c = lead.cam_free[:, None]
    free_m = lead.marker_free[:, None]
    diag_c = torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-10)
    diag_m = torch.clamp(torch.diagonal(Hmm, dim1=-2, dim2=-1), min=1e-10)

    def matvec(xc, xm):
        xc = xc * free_c
        xm = xm * free_m
        yc_mk, ym_mk, us = [], [], []
        for t, xci, xmi in zip(shards, _on(devs, xc), _on(devs, xm)):
            p = t.p
            # camera <-> marker coupling through the marker edges
            t_m = _mv(t.Jm_m, xmi[p.m_marker])                   # [F, 2]
            yc_mk.append(_seg_sum(p.m_kf, K, _mv(t.Jc_m.transpose(-1, -2),
                                                 t_m * t.w_m[:, None])))
            t_c = _mv(t.Jc_m, xci[p.m_kf])
            ym_mk.append(_seg_sum(p.m_marker, M, _mv(
                t.Jm_m.transpose(-1, -2), t_c * t.w_m[:, None])))
            # the Schur subtraction W Hpp^-1 W^T xc, two segment sums
            us.append(_seg_sum(p.e_pt, L, _mv(t.Wcp.transpose(-1, -2),
                                              xci[p.e_kf])))
        ss = _on(devs, _mv(Hpp_inv, _psum(us)))
        yc_sch = [_seg_sum(t.p.e_kf, K, _mv(t.Wcp, s[t.p.e_pt]))
                  for t, s in zip(shards, ss)]
        yc = _mv(Hcc, xc) + _psum(yc_mk) - _psum(yc_sch)
        ym = _mv(Hmm, xm) + _psum(ym_mk)
        # LM damping; fixed states act as identity rows
        yc = (yc + lam * diag_c * xc + 1e-8 * xc) * free_c
        ym = (ym + lam * diag_m * xm + 1e-8 * xm) * free_m
        return yc, ym

    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Pc = torch.linalg.inv_ex(Hcc + diag_embed(lam * diag_c) + 1e-7 * eye6)[0]
    Pm = torch.linalg.inv_ex(Hmm + diag_embed(lam * diag_m) + 1e-7 * eye6)[0]

    def precond(rc, rm):
        return _mv(Pc, rc) * free_c, _mv(Pm, rm) * free_m

    def dot(ac, am, bc2, bm2):
        return torch.sum(ac * bc2) + torch.sum(am * bm2)

    b_c = bc_red * free_c
    b_m = bm * free_m
    x_c, x_m = torch.zeros_like(b_c), torch.zeros_like(b_m)
    r_c, r_m = b_c, b_m
    p_c, p_m = precond(r_c, r_m)
    rz = dot(r_c, r_m, p_c, p_m)
    tol2 = 1e-8 * torch.clamp(dot(b_c, b_m, b_c, b_m), min=1e-20)
    for _ in range(cg_iters):
        run = rz > tol2
        Ap_c, Ap_m = matvec(p_c, p_m)
        alpha = rz / torch.clamp(dot(p_c, p_m, Ap_c, Ap_m), min=1e-20)
        x_c2, x_m2 = x_c + alpha * p_c, x_m + alpha * p_m
        r_c2, r_m2 = r_c - alpha * Ap_c, r_m - alpha * Ap_m
        z_c, z_m = precond(r_c2, r_m2)
        rz2 = dot(r_c2, r_m2, z_c, z_m)
        beta = rz2 / torch.clamp(rz, min=1e-20)
        p_c2, p_m2 = z_c + beta * p_c, z_m + beta * p_m
        x_c, x_m, r_c, r_m, p_c, p_m, rz = (
            torch.where(run, n, o) for n, o in zip(
                (x_c2, x_m2, r_c2, r_m2, p_c2, p_m2, rz2),
                (x_c, x_m, r_c, r_m, p_c, p_m, rz)))
    return (torch.where(torch.isfinite(x_c), x_c, 0.0),
            torch.where(torch.isfinite(x_m), x_m, 0.0))


def _step(shards, cams, states, lam, huber_delta, use_huber, use_cg,
          cg_iters):
    """One damped Gauss-Newton step of all free states (Schur complement,
    dense or CG) from the shards' copies of the state; the new state on the
    lead device."""
    lead = shards[0]
    devs = [p.e_pt.device for p in shards]
    terms = []
    for p, cam, st in zip(shards, cams, states):
        pp = p._replace(**dict(zip(STATE, st)))
        r_e, Jc_e, Jp_e, w_e = _point_edge_terms(pp, cam, huber_delta,
                                                 use_huber)
        r_m, Jc_m, Jm_m, w_m = _marker_edge_terms(pp, cam, huber_delta,
                                                  use_huber)
        terms.append(_Terms(pp, r_e, Jc_e, Jp_e, w_e, r_m, Jc_m, Jm_m, w_m,
                            _quad(Jc_e, w_e, Jp_e)))
    Rcw, tcw, points, Rwm, twm = states[0]
    K, L, M = Rcw.shape[0], points.shape[0], Rwm.shape[0]
    eye3 = torch.eye(3, dtype=Rcw.dtype, device=Rcw.device)

    # landmark blocks, damped and inverted per point
    Hpp = _psum([_seg_sum(t.p.e_pt, L, _quad(t.Jp_e, t.w_e, t.Jp_e))
                 for t in terms])
    bp = _psum([_seg_sum(t.p.e_pt, L, _grad(t.Jp_e, t.w_e, t.r_e))
                for t in terms])
    dpp = torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-10)
    adj, det = inv3x3_adjugate(Hpp + lam * diag_embed(dpp) + 1e-9 * eye3)
    Hpp_inv = adj / det[..., None, None]
    Hpp_inv = torch.where(torch.isfinite(Hpp_inv), Hpp_inv, 0.0)

    # camera and marker diagonal blocks
    Hcc = _psum([_seg_sum(t.p.e_kf, K, _quad(t.Jc_e, t.w_e, t.Jc_e))
                 + _seg_sum(t.p.m_kf, K, _quad(t.Jc_m, t.w_m, t.Jc_m))
                 for t in terms])
    bc = _psum([_seg_sum(t.p.e_kf, K, _grad(t.Jc_e, t.w_e, t.r_e))
                + _seg_sum(t.p.m_kf, K, _grad(t.Jc_m, t.w_m, t.r_m))
                for t in terms])
    Hmm = _psum([_seg_sum(t.p.m_marker, M, _quad(t.Jm_m, t.w_m, t.Jm_m))
                 for t in terms])
    bm = _psum([_seg_sum(t.p.m_marker, M, _grad(t.Jm_m, t.w_m, t.r_m))
                for t in terms])

    # reduced right-hand side
    hb = _on(devs, _mv(Hpp_inv, bp))                              # [L, 3]
    bc_red = bc - _psum([_seg_sum(t.p.e_kf, K, _mv(t.Wcp, h[t.p.e_pt]))
                         for t, h in zip(terms, hb)])

    if use_cg:
        dxc, dxm = _cg_solve(lead, terms, lam, Hcc, Hmm, Hpp_inv, bc_red,
                             bm, cg_iters)
    else:
        dxc, dxm = _dense_solve(lead, terms, lam, Hcc, Hmm, Hpp_inv, bc_red,
                                bm)

    # back-substitute the points
    Wt_dxc = _psum([_seg_sum(t.p.e_pt, L, _mv(t.Wcp.transpose(-1, -2),
                                               d[t.p.e_kf]))
                    for t, d in zip(terms, _on(devs, dxc))])
    dp = _mv(Hpp_inv, bp - Wt_dxc) * lead.pt_free[:, None]
    dp = torch.where(torch.isfinite(dp), dp, 0.0)

    dRc, dtc = se3_exp(dxc)
    Rn, tn = se3_compose(dRc, dtc, Rcw, tcw)
    dRm, dtm = se3_exp(dxm)
    Rwm_n, twm_n = se3_compose(dRm, dtm, Rwm, twm)
    return (Rn, tn, points + dp, Rwm_n, twm_n)


def _chi2(shards, cams, states):
    """(total chi2 summed over the shards, each shard's (c_e, c_m))."""
    parts = [_total_chi2(p._replace(**dict(zip(STATE, st))), cam)
             for p, cam, st in zip(shards, cams, states)]
    return _psum([c[0] for c in parts]), [c[1:] for c in parts]


def ba_solve(p: BAProblem, cam: Camera, iters: int = 10,
             huber_delta: float = 2.4477, use_huber: bool = True,
             lam0: float = 1e-4, solver: str = "auto", cg_iters: int = 32,
             mesh=None) -> BAResult:
    """LM with the Schur complement: up to `iters` iterations, each step
    accepted only if it lowers the total chi2; stops (masks its updates)
    after two iterations without a relative improvement of 1e-6. The
    edges are Huber-weighted at huber_delta unless use_huber is False.
    `solver`
    "dense" or "cg" picks the reduced system's solver, "auto" CG when the
    problem has more than DENSE_MAX_CAMS cameras.

    mesh (a list of torch devices, repeats allowed): the edge lists are cut
    into len(mesh) shards (shard_problem) and every sum over edges is taken
    per shard and summed over the shards, as the JAX solve's psum_axis
    does; the result lies on mesh[0]. JAX's edges_by_point, which fuses
    the CG product's sums over the shards to cut interconnect traffic, has
    no counterpart: it changes no result. Without a mesh the problem is
    one shard."""
    if solver not in ("auto", "dense", "cg"):
        raise ValueError(f"solver {solver!r}: auto, dense or cg")
    use_cg = solver == "cg" or (solver == "auto"
                                and p.Rcw.shape[0] > DENSE_MAX_CAMS)
    shards = [p] if mesh is None else shard_problem(p, mesh)
    devs = [s.e_pt.device for s in shards]
    cams = [to_device(cam, d) for d in devs]
    states = [tuple(getattr(s, k) for k in STATE) for s in shards]
    dev = devs[0]
    chi2_cur, _ = _chi2(shards, cams, states)
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    stall = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(iters):
        active = stall < 2
        new = _step(shards, cams, states, lam, huber_delta, use_huber,
                    use_cg, cg_iters)
        # the candidate's copies on the shards: the state's one copy per
        # LM iteration
        news = [new] + [tuple(x.to(d) for x in new) for d in devs[1:]]
        chi2_new, _ = _chi2(shards, cams, news)
        accept = active & (chi2_new < chi2_cur)
        improved = chi2_new < chi2_cur * (1.0 - 1e-6)
        states = [tuple(torch.where(a, n, o) for n, o in zip(nw, st))
                  for a, nw, st in zip(_on(devs, accept), news, states)]
        lam = torch.where(active, torch.clamp(
            torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e5), lam)
        chi2_cur = torch.where(accept, chi2_new, chi2_cur)
        stall = torch.where(active, torch.where(improved, 0, stall + 1),
                            stall)
    chi2, per = _chi2(shards, cams, states)
    c_e = torch.cat([c[0].to(dev) for c in per]) if len(per) > 1 else per[0][0]
    c_m = torch.cat([c[1].to(dev) for c in per]) if len(per) > 1 else per[0][1]
    state = states[0]
    return BAResult(Rcw=state[0], tcw=state[1], points=state[2],
                    Rwm=state[3], twm=state[4], chi2=chi2, edge_chi2=c_e,
                    medge_chi2=c_m)
