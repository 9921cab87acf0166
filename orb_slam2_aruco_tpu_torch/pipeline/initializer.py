"""Monocular bootstrap.

Port of orb_slam2_aruco_tpu/pipeline/initializer.py (reference
Tracking::MonocularInitialization + Initializer, src/Tracking.cc:494-688,
src/Initializer.cc):

  * marker path (primary): the relative pose of the two init frames from
    the best common good marker, T21 = T2m * Tm1, scored by the corner
    reprojection of all common markers (Tracking.cc:549-629); metric scale
    from the known marker side;
  * classic path (H or F RANSAC) for marker-free starts,
    `classic_relative_pose`. Its 128 hypothesis sets are drawn as the JAX
    package draws them (jax.random.choice with the match mask as p, key 0),
    by utils/threefry on the mask's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_aruco_tpu_torch.config import SlamConfig
from orb_slam2_aruco_tpu_torch.geometry import camera as cam_mod
from orb_slam2_aruco_tpu_torch.geometry import twoview
from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.ippe import square_object_points
from orb_slam2_aruco_tpu_torch.geometry.lie import se3_inverse
from orb_slam2_aruco_tpu_torch.ops import matching
from orb_slam2_aruco_tpu_torch.pipeline import tracking
from orb_slam2_aruco_tpu_torch.pipeline.frontend import Frame
from orb_slam2_aruco_tpu_torch.utils import threefry

RANSAC_SETS = 128


class InitCandidate(NamedTuple):
    ok: torch.Tensor         # [] bool
    R21: torch.Tensor        # [3, 3]
    t21: torch.Tensor        # [3]
    err: torch.Tensor        # [] mean corner reprojection error (px)
    baseline: torch.Tensor   # [] ||t21||

    @property
    def ctrl(self):
        """[ok, err, baseline] for one host read."""
        return torch.stack([self.ok.to(torch.float32), self.err,
                            self.baseline])


def marker_relative_pose(f1: Frame, f2: Frame, cam: Camera,
                         cfg: SlamConfig) -> InitCandidate:
    """Best relative pose T21 from the good markers both frames see."""
    eq = ((f1.mk_ids[:, None] == f2.mk_ids[None, :])
          & (f1.mk_ids[:, None] >= 0)
          & (f1.mk_good & f1.mk_valid)[:, None]
          & (f2.mk_good & f2.mk_valid)[None, :])
    p2 = torch.argmax(eq.to(torch.int32), dim=1)        # [A] index into f2
    paired = eq.any(dim=1)
    Rm1, tm1 = se3_inverse(f1.mk_Rcm, f1.mk_tcm)
    R2 = f2.mk_Rcm[p2]
    R21 = R2 @ Rm1
    t21 = (R2 @ tm1[..., None])[..., 0] + f2.mk_tcm[p2]
    corners = square_object_points(cfg.aruco.marker_size,
                                   device=f1.mk_tcm.device)   # [4, 3]
    c1 = (corners @ f1.mk_Rcm.transpose(-1, -2)
          + f1.mk_tcm[:, None, :])                       # [A, 4, 3]
    # every candidate (row a) scores all paired markers' corners (b)
    pc2 = (torch.einsum("aij,bnj->abni", R21, c1)
           + t21[:, None, None, :])                      # [A, A, 4, 3]
    uv = cam_mod.project(cam, pc2)
    err = torch.linalg.norm(uv - f2.mk_corners[p2][None], dim=-1)
    err = torch.where(pc2[..., 2] > 0.02, err, 1e6)      # [A, A, 4]
    w = paired.to(torch.float32)
    errs = (torch.sum(err * w[None, :, None], dim=(1, 2))
            / torch.clamp(w.sum() * 4, min=1.0))
    errs = torch.where(paired, errs, 1e9)
    best = torch.argmin(errs).reshape(1)
    e = tracking.row(errs, best)
    t = tracking.row(t21, best)
    baseline = torch.linalg.norm(t)
    ok = ((e < cfg.tracking.init_marker_reproj_err)
          & (baseline >= cfg.tracking.init_min_marker_baseline))
    return InitCandidate(ok=ok, R21=tracking.row(R21, best), t21=t, err=e,
                         baseline=baseline)


def _intrinsics(cam: Camera):
    z = torch.zeros_like(cam.fx)
    return torch.stack([torch.stack([cam.fx, z, cam.cx]),
                        torch.stack([z, cam.fy, cam.cy]),
                        torch.stack([z, z, torch.ones_like(z)])])


def classic_relative_pose(f1: Frame, f2: Frame, cam: Camera,
                          cfg: SlamConfig) -> InitCandidate:
    """Markerless H or F bootstrap (reference Initializer::Initialize): match
    the two frames, fit H and F on the batched hypothesis sets, pick the
    model by RH > 0.40, decompose it and keep the (R, t) candidate passing
    the most CheckRT gates. The translation has unit scale."""
    dev = f1.kp_uv.device
    d = matching.distance_matrix(f1.desc, f2.desc, f1.kp_valid, f2.kp_valid)
    wm = matching.window_mask(f1.kp_uv, f2.kp_uv, 100.0)
    d = torch.where(wm, d, matching.INF)
    m = matching.nn_match(d, max_dist=float(cfg.matcher.th_low),
                          nn_ratio=0.9, mutual=True)
    uv1 = f1.kp_uv
    uv2 = f2.kp_uv[torch.clamp(m.idx, min=0)]
    mask = m.valid.to(torch.float32)
    xn1 = cam_mod.pixels_to_normalized(cam, uv1)
    xn2 = cam_mod.pixels_to_normalized(cam, uv2)
    n = uv1.shape[0]
    p = mask / torch.clamp(mask.sum(), min=1.0)
    sets = threefry.choice_p(threefry.PRNGKey(0), (RANSAC_SETS, 8), p)
    S = RANSAC_SETS
    X1 = uv1.expand(S, n, 2)
    X2 = uv2.expand(S, n, 2)
    MS = mask.expand(S, n)
    F = twoview.fundamental_8pt(uv1[sets], uv2[sets])
    sf, _ = twoview.score_fundamental(F, X1, X2, MS)
    H = twoview.homography_dlt(uv1[sets[:, :4]], uv2[sets[:, :4]])
    sh, _ = twoview.score_homography(H, X1, X2, MS)
    bestF = tracking.row(F, torch.argmax(sf).reshape(1))
    bestH = tracking.row(H, torch.argmax(sh).reshape(1))
    RH = sh.max() / torch.clamp(sh.max() + sf.max(), min=1e-9)
    K = _intrinsics(cam)
    Re, te = twoview.decompose_E(twoview.essential_from_fundamental(bestF, K))
    Rh, th = twoview.decompose_H(bestH, K)
    Rs = torch.cat([Re, Rh], dim=0)                      # [12, 3, 3]
    ts = torch.cat([te, th], dim=0)
    use_h = RH > 0.40
    cand_mask = torch.cat([(~use_h).expand(4), use_h.expand(8)])
    n_good, _, _, _ = twoview.check_rt(
        Rs, ts, xn1.expand(12, n, 2), xn2.expand(12, n, 2),
        mask.expand(12, n))
    n_good = torch.where(cand_mask, n_good, -1)
    b = torch.argmax(n_good).reshape(1)
    total = mask.sum()
    ok = ((tracking.row(n_good, b) > 0.7 * total)
          & (total >= cfg.tracking.min_init_matches))
    t = tracking.row(ts, b)
    return InitCandidate(ok=ok, R21=tracking.row(Rs, b), t21=t,
                         err=torch.zeros((), dtype=torch.float32, device=dev),
                         baseline=torch.linalg.norm(t))
