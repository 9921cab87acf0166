"""Tracking: per-frame pose estimation with the marker-first cascade.

Port of orb_slam2_aruco_tpu/pipeline/tracking.py, the functions the
localization slice runs (reference Tracking::Track, src/Tracking.cc:192-492):

  * CheckArucoID (Tracking.cc:856-908)          -> bind_markers,
                                                   old_marker_flags
  * IsArucoWellTrack (Tracking.cc:1062-1168)    -> aruco_pose_candidate
  * TrackWithMotionModel (Tracking.cc:995-1060) -> track_frame
  * TrackReferenceKeyFrame (Tracking.cc:910-982)-> track_vs_keyframe
  * TrackLocalMap (Tracking.cc:1242-1293)       -> track_local_map
  * Relocalization (Tracking.cc:1741-1914)      -> reloc_candidates,
                                                   reloc_pnp
  * the whole OK-state cascade                  -> track_full
  * make_frame + the cascade                    -> track_full_img
  * a chunk of localization frames              -> track_batch

Every function runs on the state's device with fixed shapes. The JAX
package's two `lax.cond`s in `_cascade_seed` (widened-window retry and
reference-keyframe fallback) are host branches here: each reads one
scalar (`host_sync`), counted in `SYNCS` so a run can report its host syncs
per frame and the host time they waited. `track_batch`'s extrapolate mode
has none. `track_full`'s stages are the spans tracking.motion,
tracking.retry, tracking.refkf and tracking.local_map (utils/telemetry.py).
Every path here and in pipeline/system.py shares one motion model
(`_motion_seed`, `_motion_advance`) and one control vector (`_Ctrl`).

Between its branch reads the cascade is some 540 small ops of fixed shapes
that read nothing on the host, each a launch when issued one by one. On
the card in localization mode (`final_map`), whose map keeps its tensors
from frame to frame, `track_full` captures its two stages once per
`graph_key` as CUDA graphs (the motion stage up to the retry read, the
local-map stage) and replays them after that; the fallbacks between them
stay eager. SLAM mode is not captured: its keyframe inserts replace the
map's tensors every few frames. `GRAPH` counts the calls by route.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.config import SlamConfig
from orb_slam2_aruco_tpu_torch.geometry import camera as cam_mod
from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.lie import (
    se3_apply,
    se3_compose,
    se3_inverse,
)
from orb_slam2_aruco_tpu_torch.ops import matching
from orb_slam2_aruco_tpu_torch.ops.topk import stable_topk
from orb_slam2_aruco_tpu_torch.optim import pnp, pose_opt
from orb_slam2_aruco_tpu_torch.optim.residuals import (
    marker_corner_points_world,
)
from orb_slam2_aruco_tpu_torch.pipeline.frontend import (
    Frame,
    _capturing,
    make_frame,
    scale_sigma2,
)
from orb_slam2_aruco_tpu_torch.utils.telemetry import annotate
from orb_slam2_aruco_tpu_torch.worldmap import retrieval
from orb_slam2_aruco_tpu_torch.worldmap.covisibility import (
    covisibility_matrix,
)
from orb_slam2_aruco_tpu_torch.worldmap.state import MapState

# deliberate host reads of device values: how many, and the host
# nanoseconds spent blocked in them
SYNCS = {"count": 0, "wait_ns": 0}


def host_sync(x) -> bool:
    """Read a 0-d tensor's truth value on the host (a device sync on
    CUDA), counted and timed in SYNCS."""
    SYNCS["count"] += 1
    t0 = time.perf_counter_ns()
    out = bool(x)
    SYNCS["wait_ns"] += time.perf_counter_ns() - t0
    return out


def host_read(x):
    """A tensor's values as numpy on the host (a device sync on CUDA),
    counted and timed in SYNCS."""
    SYNCS["count"] += 1
    t0 = time.perf_counter_ns()
    out = x.detach().cpu().numpy()
    SYNCS["wait_ns"] += time.perf_counter_ns() - t0
    return out


class HostCopy:
    """A device tensor's values for the host, read later: with `defer` the
    copy into pinned host memory is queued now without waiting, and
    `read()` waits for that copy alone (an event wait), not for work queued
    after it; without `defer` (or for a CPU tensor) `read()` is host_read.
    Counted and timed in SYNCS either way."""

    def __init__(self, x, defer: bool = True):
        self._x, self._done = x.detach(), None
        if defer and x.device.type == "cuda":
            self._x = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._x.copy_(x, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()

    def read(self):
        if self._done is None:
            return host_read(self._x)
        SYNCS["count"] += 1
        t0 = time.perf_counter_ns()
        self._done.synchronize()
        SYNCS["wait_ns"] += time.perf_counter_ns() - t0
        return self._x.numpy()


class TrackResult(NamedTuple):
    Rcw: torch.Tensor
    tcw: torch.Tensor
    obs_point: torch.Tensor   # [N] map-point slot per current feature
    n_inliers: torch.Tensor   # []
    n_matches: torch.Tensor   # [] pre-optimization matches


class FullTrackResult(NamedTuple):
    Rcw: torch.Tensor
    tcw: torch.Tensor
    obs_point: torch.Tensor
    n_inliers: torch.Tensor       # final (local-map) inliers
    n_first_stage: torch.Tensor   # inliers after the first-stage track
    used_aruco: torch.Tensor      # bool
    used_ref_kf: torch.Tensor     # bool
    slots: torch.Tensor           # [A] marker binding
    old_flags: torch.Tensor       # [A]
    any_new_marker: torch.Tensor  # bool
    pt_visible: torch.Tensor
    pt_found: torch.Tensor
    ctrl: torch.Tensor            # [20] float32 in _Ctrl's layout


def _scatter_max(N: int, tgt, src):
    """out[tgt[i]] = max(out, src[i]) over a [N + 1] buffer of -1 (index N
    collects the invalid entries), returned cropped to [N]."""
    buf = torch.full((N + 1,), -1, dtype=torch.int64, device=src.device)
    return buf.scatter_reduce(0, tgt, src, "amax", include_self=True)[:N]


def _matched(N: int, m, src):
    """[N] per b-side feature of the matches m: src of the a-side entry
    matched to it, -1 where none (the match -> obs_point scatter)."""
    return _scatter_max(N, torch.where(m.valid, m.idx, N),
                        torch.where(m.valid, src, -1))


def row(a, k):
    """a[k] for an int or a device scalar k; a tensor index goes through a
    1-element index_select (indexing with a 0-d tensor reads it on the
    host)."""
    if isinstance(k, torch.Tensor):
        return a.index_select(0, k.reshape(1))[0]
    return a[k]


def mark(L: int, idx, val=None):
    """[L] bool: True at idx where val holds (default: idx >= 0); the other
    entries go to a dump slot that is cut off."""
    ok = (idx >= 0) if val is None else val
    buf = torch.zeros((L + 1,), dtype=torch.bool, device=idx.device)
    return buf.index_fill_(0, torch.where(ok, idx, L), True)[:L]


# ---------------------------------------------------------------------------
# markers
# ---------------------------------------------------------------------------


def bind_markers(state: MapState, frame: Frame):
    """[A] map marker slot for each frame marker id (-1 if not in map)."""
    ids = frame.mk_ids
    eq = ((ids[:, None] == state.mk_id[None, :]) & state.mk_valid[None, :]
          & (ids[:, None] >= 0))
    slot = torch.argmax(eq.to(torch.int32), dim=1)
    return torch.where(eq.any(dim=1), slot, -1)


def old_marker_flags(state: MapState, slots, min_gap: int):
    """[A] bool: bound markers whose latest observing keyframe is at least
    `min_gap` keyframes old (mvbOldAruco, Tracking.cc:856-908)."""
    slots_safe = torch.clamp(slots, min=0)
    observes = ((state.kf_mk_slot[:, :, None] == slots_safe[None, None, :])
                & state.kf_mk_valid[:, :, None]
                & state.kf_valid[:, None, None]).any(dim=1)      # [K, A]
    fid = torch.where(state.kf_valid, state.kf_frame_id, -1)
    latest_fid = torch.where(observes, fid[:, None], -1).max(dim=0).values
    rank = ((fid[:, None] > fid[None, :])
            & state.kf_valid[None, :]).sum(dim=1)
    newest_rank = torch.where(state.kf_valid, rank, -1).max()
    latest_rank = torch.where(observes, rank[:, None], -1).max(dim=0).values
    gap = newest_rank - latest_rank
    return (slots >= 0) & (latest_fid >= 0) & (gap >= min_gap)


def marker_observer_kf(state: MapState, slots):
    """Most recent valid keyframe observing any bound marker slot, or -1."""
    eq = ((state.kf_mk_slot[:, :, None] == torch.clamp(slots, min=0)[None, None, :])
          & state.kf_mk_valid[:, :, None]
          & (slots >= 0)[None, None, :]).any(dim=2).any(dim=1)
    observes = eq & state.kf_valid
    fid = torch.where(observes, state.kf_frame_id, -1)
    k = torch.argmax(fid)
    return torch.where(observes.any(), k, -1)


def _marker_obs_arrays(state: MapState, frame: Frame, slots, old=None):
    """Fixed-marker edge inputs: corners_w [A, 4, 3], uv [A, 4, 2] and the
    mask of good, bound, non-old markers (Optimizer.cc:628-676)."""
    slots_safe = torch.clamp(slots, min=0)
    corners_w = marker_corner_points_world(
        state.mk_Rwm[slots_safe], state.mk_twm[slots_safe],
        state.mk_side[slots_safe])
    mask = (slots >= 0) & frame.mk_good & frame.mk_valid
    if old is not None:
        mask = mask & ~old
    return corners_w, frame.mk_corners, mask


def aruco_pose_candidate(state: MapState, frame: Frame, slots, cam: Camera,
                         cfg: SlamConfig, old=None, err_th=None):
    """Best camera pose implied by one bound marker, scored by the mean
    corner reprojection error over all bound markers. Returns (ok, Rcw,
    tcw, mean_err) as tensors."""
    slots_safe = torch.clamp(slots, min=0)
    Rmw, tmw = se3_inverse(state.mk_Rwm[slots_safe], state.mk_twm[slots_safe])
    Rc = frame.mk_Rcm @ Rmw                                     # [A, 3, 3]
    tc = (frame.mk_Rcm @ tmw[..., None])[..., 0] + frame.mk_tcm
    cand_ok = (slots >= 0) & frame.mk_good & frame.mk_valid
    if old is not None:
        cand_ok = cand_ok & ~old
    corners_w, uv_obs, mask = _marker_obs_arrays(state, frame, slots, old)
    cw_flat = corners_w.reshape(-1, 3)                          # [4A, 3]
    uv_flat = uv_obs.reshape(-1, 2)
    m_flat = mask.to(torch.float32).repeat_interleave(4)
    p = cw_flat[None] @ Rc.transpose(-1, -2) + tc[:, None, :]   # [A, 4A, 3]
    uv = cam_mod.project(cam, p)
    err = torch.linalg.norm(uv - uv_flat[None], dim=-1)
    err = torch.where(p[..., 2] > 0.02, err, 1e6)
    wsum = torch.clamp(m_flat.sum(), min=1.0)
    errs = (err * m_flat[None]).sum(dim=-1) / wsum              # [A]
    errs = torch.where(cand_ok, errs, 1e9)
    best = torch.argmin(errs)
    e = row(errs, best)
    th = cfg.aruco.well_tracked_reproj_err if err_th is None else err_th
    return e < th, row(Rc, best), row(tc, best), e


# ---------------------------------------------------------------------------
# point matching + pose refinement
# ---------------------------------------------------------------------------


def _point_world_arrays(state: MapState, obs_point):
    safe = torch.clamp(obs_point, min=0)
    return state.pt_xyz[safe], (obs_point >= 0) & state.pt_valid[safe]


def local_point_mask(state: MapState, obs_point, max_local_kfs: int):
    """([L] bool, best_kf): points observed by the covisibility-local
    keyframes (UpdateLocalKeyFrames <= 80, Tracking.cc:1555-1663) and the
    keyframe sharing the most points with the frame (-1 if none)."""
    K, L = state.K, state.L
    obs_set = mark(L, obs_point)
    inc = state.pt_obs_kf & state.kf_valid[None, :]
    share = (obs_set.to(torch.float32) @ inc.to(torch.float32)).to(torch.int64)
    kth = stable_topk(share, min(max_local_kfs, K))[0][-1]
    local_kf = (share > 0) & (share >= kth) & state.kf_valid
    mask = (inc & local_kf[None, :]).any(dim=1)
    any_local = local_kf.any()
    best_kf = torch.where(any_local, torch.argmax(share), -1)
    return torch.where(any_local, mask, torch.ones_like(mask)), best_kf


def _optimize(state, frame, slots, Rcw0, tcw0, obs_point, cam,
              cfg: SlamConfig, old=None, rounds=None, iters_per_round=None):
    pts, pvalid = _point_world_arrays(state, obs_point)
    inv_s2 = scale_sigma2(cfg.orb.num_levels, cfg.orb.scale_factor,
                          pts.device)[frame.kp_octave]
    corners_w, uv_mk, m_mask = _marker_obs_arrays(state, frame, slots, old)
    r = pose_opt.optimize_pose(
        Rcw0, tcw0, cam, pts, frame.kp_uv, pvalid & frame.kp_valid, inv_s2,
        marker_corners_w=corners_w, marker_uv=uv_mk, marker_mask=m_mask,
        marker_weight=cfg.aruco.edge_weight, chi2_th=cfg.optim.chi2_mono,
        huber_delta=cfg.optim.huber_delta,
        rounds=cfg.optim.pose_rounds if rounds is None else rounds,
        iters_per_round=(cfg.optim.pose_iters_per_round
                         if iters_per_round is None else iters_per_round),
    )
    return r, torch.where(r.inliers, obs_point, -1)


def track_frame(state: MapState, frame: Frame, slots, Rcw0, tcw0,
                last_uv, last_desc, last_obs, last_valid, last_octave,
                last_angle, cam: Camera, cfg: SlamConfig,
                search_radius: float, old=None,
                seed_budget: bool = False) -> TrackResult:
    """Project the last frame's map points with the seed pose, window-match
    with the rotation histogram, optimize (TrackWithMotionModel /
    TrackByAruco body). `seed_budget` trims the LM to seed_rounds x
    seed_iters: the two-stage chunk's first-stage pose is only a seed."""
    pts, pvalid = _point_world_arrays(state, last_obs)
    pvalid = pvalid & last_valid
    p_cam = se3_apply(Rcw0[None], tcw0[None], pts)
    uv_pred = cam_mod.project(cam, p_cam)
    m = matching.match_in_window(
        last_desc, frame.desc, uv_pred, frame.kp_uv, radius=search_radius,
        mask_a=pvalid & (p_cam[..., 2] > 0.05)
        & cam_mod.in_image(cam, uv_pred, margin=1.0),
        mask_b=frame.kp_valid, octave_a=last_octave,
        octave_b=frame.kp_octave, max_octave_diff=1,
        max_dist=float(cfg.matcher.th_high),
        nn_ratio=cfg.matcher.nn_ratio_tracking,
        angles_a=last_angle, angles_b=frame.kp_angle,
        check_rotation=cfg.matcher.check_orientation,
        histo_length=cfg.matcher.histo_length,
    )
    obs_point = _matched(frame.kp_uv.shape[0], m, last_obs)
    res, obs_out = _optimize(
        state, frame, slots, Rcw0, tcw0, obs_point, cam, cfg, old,
        rounds=cfg.tracking.seed_rounds if seed_budget else None,
        iters_per_round=cfg.tracking.seed_iters if seed_budget else None)
    return TrackResult(res.Rcw, res.tcw, obs_out, res.n_inliers,
                       m.valid.sum())


def _match_keyframe(state: MapState, frame: Frame, kf, cfg: SlamConfig,
                    nn_ratio: float, check_rotation: bool = False):
    """(matches, obs_point [N]): mutual descriptor matches of the frame
    against keyframe kf's map points, rotation-checked if asked."""
    kf_obs = row(state.kf_obs_point, kf)
    kf_valid = (row(state.kf_kp_valid, kf) & (kf_obs >= 0)
                & state.pt_valid[torch.clamp(kf_obs, min=0)])
    d = matching.distance_matrix(row(state.kf_desc, kf), frame.desc,
                                 kf_valid, frame.kp_valid)
    m = matching.nn_match(d, max_dist=float(cfg.matcher.th_low),
                          nn_ratio=nn_ratio, mutual=True)
    if check_rotation:
        m = matching.rotation_consistency(row(state.kf_kp_angle, kf),
                                          frame.kp_angle, m,
                                          cfg.matcher.histo_length)
    return m, _matched(frame.kp_uv.shape[0], m, kf_obs)


def track_vs_keyframe(state: MapState, frame: Frame, slots, kf, Rcw0, tcw0,
                      cam: Camera, cfg: SlamConfig, old=None) -> TrackResult:
    """Descriptor-only matching against one keyframe's map-point features
    (TrackReferenceKeyFrame), then optimize."""
    m, obs_point = _match_keyframe(state, frame, kf, cfg,
                                   cfg.matcher.nn_ratio_init,
                                   cfg.matcher.check_orientation)
    res, obs_out = _optimize(state, frame, slots, Rcw0, tcw0, obs_point, cam,
                             cfg, old)
    return TrackResult(res.Rcw, res.tcw, obs_out, res.n_inliers,
                       m.valid.sum())


def reloc_candidates(state: MapState, frame: Frame, cfg: SlamConfig,
                     max_candidates: int = 4):
    """BoW relocalization candidates (DetectRelocalizationCandidates,
    src/KeyFrameDatabase.cc:199+): the loop candidates' shared-word and
    covisible-group gates without the minimum score. (idx, acc, keep)."""
    return retrieval.detect_candidates_grouped(
        frame.bow, state.kf_bow, state.kf_valid,
        covis_w=covisibility_matrix(state).to(torch.float32),
        exclude_mask=torch.zeros_like(state.kf_valid), min_score=0.0,
        max_candidates=max_candidates)


def reloc_pnp(state: MapState, frame: Frame, slots, kf, cam: Camera,
              cfg: SlamConfig) -> TrackResult:
    """Relocalization against one candidate keyframe (Relocalization,
    Tracking.cc:1741-1914): mutual descriptor matches give 2D-3D pairs,
    RANSAC PnP a pose, the pose LM refines it. n_inliers is 0 when PnP
    found too few inliers; n_matches holds PnP's inlier count."""
    _, obs_point = _match_keyframe(state, frame, kf, cfg, 0.75)
    pts, pvalid = _point_world_arrays(state, obs_point)
    res = pnp.ransac_pnp(pts, frame.kp_uv, pvalid & frame.kp_valid, cam,
                         chi2_th=cfg.optim.chi2_mono,
                         min_inliers=cfg.tracking.min_inliers_track)
    opt, obs_out = _optimize(state, frame, slots, res.Rcw, res.tcw,
                             obs_point, cam, cfg)
    return TrackResult(opt.Rcw, opt.tcw, obs_out,
                       torch.where(res.ok, opt.n_inliers, 0), res.n_inliers)


def track_local_map(state: MapState, frame: Frame, slots, Rcw0, tcw0,
                    obs_point, cam: Camera, cfg: SlamConfig, old=None,
                    pt_candidates=None, radius_scale: float = 1.0):
    """Search unmatched local-map points by projection and re-optimize
    (TrackLocalMap + SearchLocalPoints). Returns (TrackResult,
    (pt_visible, pt_found))."""
    L = state.L
    dev = obs_point.device
    pts = state.pt_xyz
    p_cam = se3_apply(Rcw0[None], tcw0[None], pts)
    uv_pred = cam_mod.project(cam, p_cam)
    dist = torch.linalg.norm(p_cam, dim=-1)
    visible = (state.pt_valid & (p_cam[..., 2] > 0.05)
               & cam_mod.in_image(cam, uv_pred, margin=1.0)
               & (dist >= 0.8 * state.pt_min_dist)
               & (dist <= 1.2 * state.pt_max_dist))
    _, twc = se3_inverse(Rcw0, tcw0)
    view = pts - twc[None]
    vn = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True),
                            min=1e-9)
    cosang = torch.sum(vn * state.pt_normal, dim=-1)
    has_normal = torch.linalg.norm(state.pt_normal, dim=-1) > 0.1
    visible = visible & (~has_normal | (cosang > 0.5))
    already = mark(L, obs_point)
    cand = visible & ~already
    if pt_candidates is not None:
        cand = cand & pt_candidates
    sf = cfg.orb.scale_factor
    lvl_ratio = (torch.clamp(state.pt_max_dist, min=1e-6)
                 / torch.clamp(dist, min=1e-6))
    oct_pred = torch.clamp(torch.ceil(torch.log(lvl_ratio) / torch.log(
        torch.full((), sf, dtype=torch.float32, device=dev))),
        0, cfg.orb.num_levels - 1).to(torch.int64)
    C = min(L, cfg.tracking.local_map_candidates)
    cscore, cidx = stable_topk(cand, C)
    csel = cscore > 0
    feat_free = frame.kp_valid & (obs_point < 0)
    oct_c = oct_pred[cidx]
    m = matching.match_in_window(
        state.pt_desc[cidx], frame.desc, uv_pred[cidx], frame.kp_uv,
        radius=cfg.matcher.search_radius_map * radius_scale
        * (sf ** oct_c.to(torch.float32)),
        mask_a=csel, mask_b=feat_free, octave_a=oct_c,
        octave_b=frame.kp_octave, max_octave_diff=1,
        max_dist=float(cfg.matcher.th_high),
        nn_ratio=cfg.matcher.nn_ratio_tracking,
    )
    new_obs = _matched(frame.kp_uv.shape[0], m, cidx)
    obs_point = torch.where(obs_point >= 0, obs_point, new_obs)
    n_matches = (obs_point >= 0).sum()
    res, obs_out = _optimize(state, frame, slots, Rcw0, tcw0, obs_point, cam,
                             cfg, old)
    found_sel = mark(L, obs_out)
    new_visible = state.pt_visible + visible.to(torch.float32)
    new_found = state.pt_found + found_sel.to(torch.float32)
    return (TrackResult(res.Rcw, res.tcw, obs_out, res.n_inliers, n_matches),
            (new_visible, new_found))


def marker_old(state: MapState, slots, cfg: SlamConfig,
               final_map: bool):
    """[A] bool: the bound markers tracking leaves out of its marker seeds.
    mvbOldAruco (old_marker_flags) keeps SLAM-mode tracking off markers a
    loop correction has yet to move. On a `final_map` (localization mode:
    the per-frame facade and every track_batch mode) no loop is closed, so
    no marker counts as old, where every marker mapped more than
    min_kfs_between_loops keyframes before the newest would otherwise be."""
    if final_map:
        return torch.zeros_like(slots, dtype=torch.bool)
    return old_marker_flags(state, slots, cfg.loop.min_kfs_between_loops)


class _Seed(NamedTuple):
    """The motion stage's results: the marker binding, the old-marker
    flags, whether the marker seed was taken, the seed pose and the
    motion-model track."""
    slots: torch.Tensor
    old: torch.Tensor
    ok_a: torch.Tensor
    R0: torch.Tensor
    t0: torch.Tensor
    tr: TrackResult


def _motion_stage(state: MapState, frame: Frame, R_pred, t_pred, last,
                  cam: Camera, cfg: SlamConfig, seed_budget: bool,
                  final_map: bool) -> _Seed:
    """Marker seed + motion-model tracking: what the cascade queues before
    its first branch read. `last` is the last frame's context
    (_frame_context)."""
    slots = bind_markers(state, frame)
    old = marker_old(state, slots, cfg, final_map)
    ok_a, R_a, t_a, _ = aruco_pose_candidate(state, frame, slots, cam, cfg,
                                             old=old)
    R0, t0 = torch.where(ok_a, R_a, R_pred), torch.where(ok_a, t_a, t_pred)
    tr = track_frame(state, frame, slots, R0, t0, *last, cam, cfg,
                     search_radius=cfg.matcher.search_radius_motion,
                     old=old, seed_budget=seed_budget)
    return _Seed(slots, old, ok_a, R0, t0, tr)


def _needs_retry(tr):
    """Too few motion-model matches: widen the window (TrackWithMotionModel,
    Tracking.cc:1010-1015)."""
    return tr.n_matches < 20


def _needs_ref(tr, cfg: SlamConfig):
    """Too few inliers: track against the reference keyframe
    (Tracking.cc:233-258)."""
    return tr.n_inliers < cfg.tracking.min_inliers_track


def _fallbacks(state: MapState, frame: Frame, seed: _Seed, retry: bool,
               need_ref, R_last, t_last, last, ref_kf, cam: Camera,
               cfg: SlamConfig, seed_budget: bool):
    """The widened-window retry if `retry`, then the reference-keyframe
    track if need_ref reads True: (tr, need_ref). `need_ref` is the seed
    track's; a retry recomputes it."""
    tr = seed.tr
    if retry:
        with annotate("tracking.retry"):
            tr = track_frame(
                state, frame, seed.slots, seed.R0, seed.t0, *last, cam, cfg,
                search_radius=2.0 * cfg.matcher.search_radius_motion,
                old=seed.old, seed_budget=seed_budget)
        need_ref = _needs_ref(tr, cfg)
    if host_sync(need_ref):
        # TrackReferenceKeyFrame seeds from the LAST pose
        with annotate("tracking.refkf"):
            tr = track_vs_keyframe(state, frame, seed.slots, ref_kf, R_last,
                                   t_last, cam, cfg, old=seed.old)
    return tr, need_ref


def _cascade_seed(state: MapState, frame: Frame, R_pred, t_pred, R_last,
                  t_last, last_uv, last_desc, last_obs, last_valid,
                  last_octave, last_angle, ref_kf, cam: Camera,
                  cfg: SlamConfig, seed_budget: bool = False,
                  final_map: bool = False):
    """Marker seed + motion-model tracking with the widened-window and
    reference-keyframe fallbacks (Tracking.cc:233-258). Returns (tr, slots,
    old, ok_a, need_ref); `final_map`: see marker_old."""
    last = (last_uv, last_desc, last_obs, last_valid, last_octave, last_angle)
    with annotate("tracking.motion"):
        seed = _motion_stage(state, frame, R_pred, t_pred, last, cam, cfg,
                             seed_budget, final_map)
        need_ref = _needs_ref(seed.tr, cfg)
        retry = host_sync(_needs_retry(seed.tr))
    tr, need_ref = _fallbacks(state, frame, seed, retry, need_ref, R_last,
                              t_last, last, ref_kf, cam, cfg, seed_budget)
    return tr, seed.slots, seed.old, seed.ok_a, need_ref


class _Ctrl(NamedTuple):
    """FullTrackResult.ctrl's [20] float32 layout (the JAX package's), field
    by field: `_finish` writes it, `_read_ctrl` decodes a host copy."""
    n_inliers: int          # final (local-map) inliers
    n_first: int            # inliers after the first-stage track
    used_aruco: bool
    used_ref_kf: bool
    any_new_marker: bool
    Rcw: np.ndarray         # [3, 3]
    tcw: np.ndarray         # [3]
    n_ref3: int             # reference-keyframe points seen >= 3 times
    n_ref2: int             # ... and >= 2 times
    ref_kf: int


# each field's index in the vector (a slice for the pose's two fields)
_CTRL_AT = dict(zip(_Ctrl._fields, (0, 1, 2, 3, 4, slice(5, 14),
                                    slice(14, 17), 17, 18, 19)))


def _read_ctrl(v) -> _Ctrl:
    """A control vector's host copy v (numpy [20]), decoded."""
    c = _Ctrl(*(v[at] for at in _CTRL_AT.values()))
    return _Ctrl(int(c.n_inliers), int(c.n_first), bool(c.used_aruco > 0.5),
                 bool(c.used_ref_kf > 0.5), bool(c.any_new_marker > 0.5),
                 c.Rcw.reshape(3, 3).copy(), c.tcw.copy(), int(c.n_ref3),
                 int(c.n_ref2), int(c.ref_kf))


def _ctrl_scaled_t(ctrl, s):
    """A control vector on the device with its tcw scaled by s."""
    t = _CTRL_AT["tcw"]
    return torch.cat([ctrl[:t.start], ctrl[t] * s, ctrl[t.stop:]])


def _finish(state: MapState, frame: Frame, tr, n_first, slots, old, ok_a,
            need_ref, ref_kf, best_kf, vis, found) -> FullTrackResult:
    """FullTrackResult and its ctrl from a final local-map track `tr`: the
    NeedNewKeyFrame inputs (reference-keyframe tracked-point counts at
    minObs 3 and 2, Tracking.cc:1323-1329) on the updated reference
    keyframe."""
    any_new = (frame.mk_good & frame.mk_valid & (slots < 0)).any()
    ref_kf = torch.where(best_kf >= 0, best_kf, ref_kf)
    ref_obs = row(state.kf_obs_point, ref_kf)
    ref_obs_safe = torch.clamp(ref_obs, min=0)
    ref_pt_ok = (ref_obs >= 0) & state.pt_valid[ref_obs_safe]
    obs_count = (state.pt_obs_kf & state.kf_valid[None, :]).sum(dim=1)
    ref_cnt = obs_count[ref_obs_safe]
    n_ref3 = (ref_pt_ok & (ref_cnt >= 3)).sum()
    n_ref2 = (ref_pt_ok & (ref_cnt >= 2)).sum()
    ctrl = torch.cat([x.to(torch.float32).reshape(-1) for x in _Ctrl(
        tr.n_inliers, n_first, ok_a, need_ref, any_new, tr.Rcw, tr.tcw,
        n_ref3, n_ref2, ref_kf)])
    return FullTrackResult(
        Rcw=tr.Rcw, tcw=tr.tcw, obs_point=tr.obs_point,
        n_inliers=tr.n_inliers, n_first_stage=n_first,
        used_aruco=ok_a, used_ref_kf=need_ref, slots=slots, old_flags=old,
        any_new_marker=any_new, pt_visible=vis, pt_found=found, ctrl=ctrl,
    )


def _local_map_track(state: MapState, frame: Frame, slots, tr, cam: Camera,
                     cfg: SlamConfig, old=None):
    """TrackLocalMap on a first-stage track tr (local_point_mask, then
    track_local_map): (TrackResult, (pt_visible, pt_found), best_kf)."""
    pt_local, best_kf = local_point_mask(state, tr.obs_point,
                                         cfg.tracking.max_local_keyframes)
    tr2, vis_found = track_local_map(state, frame, slots, tr.Rcw, tr.tcw,
                                     tr.obs_point, cam, cfg, old=old,
                                     pt_candidates=pt_local)
    return tr2, vis_found, best_kf


def _refine_stage(state: MapState, frame: Frame, tr, slots, old, ok_a,
                  need_ref, ref_kf, cam: Camera,
                  cfg: SlamConfig) -> FullTrackResult:
    """Local-map search + pose refine (TrackLocalMap) and the
    NeedNewKeyFrame inputs."""
    tr2, (vis, found), best_kf = _local_map_track(state, frame, slots, tr,
                                                  cam, cfg, old)
    return _finish(state, frame, tr2, tr.n_inliers, slots, old, ok_a,
                   need_ref, ref_kf, best_kf, vis, found)


def _cascade_refine(state: MapState, frame: Frame, tr, slots, old, ok_a,
                    need_ref, ref_kf, cam: Camera,
                    cfg: SlamConfig) -> FullTrackResult:
    """_refine_stage in the span tracking.local_map."""
    with annotate("tracking.local_map"):
        return _refine_stage(state, frame, tr, slots, old, ok_a, need_ref,
                             ref_kf, cam, cfg)


def _motion_seed(R, t, vel, has_vel=None):
    """The motion model's seed (TrackWithMotionModel, Tracking.cc:995-1000):
    the velocity vel = (vR, vt) composed onto the last pose (R, t), or the
    last pose without one (vel None, or has_vel a False device bool)."""
    if vel is None:
        return R, t
    Rp, tp = se3_compose(*vel, R, t)
    if has_vel is None:
        return Rp, tp
    return torch.where(has_vel, Rp, R), torch.where(has_vel, tp, t)


def _motion_advance(tr, R_prev, t_prev, cfg: SlamConfig = None):
    """The motion model's advance (mVelocity, Tracking.cc:395-404): the
    velocity (vR, vt) from the previous pose to tr's, and has_vel: with
    `cfg` a device bool, tr kept min_matches_local_map inliers (a failed
    frame seeds the next from the last pose); without, True (the facade
    gates on the host)."""
    vel = se3_compose(tr.Rcw, tr.tcw, *se3_inverse(R_prev, t_prev))
    if cfg is None:
        return vel, True
    return vel, tr.n_inliers >= cfg.tracking.min_matches_local_map


def _frame_context(frame: Frame, obs_point):
    """The last frame's part of the tracking context, in track_full's
    order: (kp_uv, desc, obs_point, kp_valid, kp_octave, kp_angle)."""
    return (frame.kp_uv, frame.desc, obs_point, frame.kp_valid,
            frame.kp_octave, frame.kp_angle)


def _track_full_eager(state: MapState, frame: Frame, R_pred, t_pred, R_last,
                      t_last, last_uv, last_desc, last_obs, last_valid,
                      last_octave, last_angle, ref_kf, cam: Camera,
                      cfg: SlamConfig, final_map: bool = False,
                      seed_budget: bool = False) -> FullTrackResult:
    """track_full with its ops issued one by one: the CPU route, SLAM mode,
    and the first call of a key on the card."""
    tr, slots, old, ok_a, need_ref = _cascade_seed(
        state, frame, R_pred, t_pred, R_last, t_last, last_uv, last_desc,
        last_obs, last_valid, last_octave, last_angle, ref_kf, cam, cfg,
        seed_budget=seed_budget, final_map=final_map)
    return _cascade_refine(state, frame, tr, slots, old, ok_a, need_ref,
                           ref_kf, cam, cfg)


# track_full's calls by route: "capture" (a key's first call on the card in
# localization mode: one eager call, then its graphs captured), "replay"
# (the card in localization mode after that), "eager" (CPU tensors, SLAM
# mode)
GRAPH = {"capture": 0, "replay": 0, "eager": 0}

# graph_key's first part -> the _CascadeGraphs of the map its second part
# names; a new map under the same first part replaces the entry
_GRAPHS = {}

# the map's tensors a replay takes by value: each frame brings new ones
_COPIED = ("pt_visible", "pt_found")


def graph_key(state: MapState, frame: Frame, args, cam: Camera,
              cfg: SlamConfig, final_map: bool = True,
              seed_budget: bool = False):
    """What a captured cascade depends on besides the values copied into it
    (the frame, track_full's `args` from R_pred to ref_kf, the map's visible
    / found counts): (the device, every input's shape and dtype, the
    settings the cascade reads, the camera, whose tensors the graphs read by
    address, final_map and seed_budget; the map's other tensors, which they
    read by address)."""
    head = (state.pt_xyz.device,
            tuple((t.shape, t.dtype) for t in (*frame, *args, *state)),
            cfg.orb, cfg.aruco, cfg.matcher, cfg.optim, cfg.tracking,
            cam.width, cam.height,
            tuple(t.data_ptr() for t in (cam.fx, cam.fy, cam.cx, cam.cy,
                                         cam.dist)),
            final_map, seed_budget)
    maps = tuple(t.data_ptr() for f, t in zip(MapState._fields, state)
                 if f not in _COPIED)
    return head, maps


def _tallies():
    """The counters a capture bumps for launches that only its replays
    run."""
    return kernels.launch_counts, pose_opt.LM_CALLS


class _CascadeGraphs:
    """track_full on one key as two CUDA graphs captured into one memory
    pool: the motion stage up to the retry read (and its need_ref), then the
    local-map stage, which reads the motion stage's track. Their inputs are
    static tensors that a replay fills with copy_; a fallback runs between
    the two eagerly on those tensors and writes its track over the motion
    stage's."""

    def __init__(self, state: MapState, frame: Frame, args, cam: Camera,
                 cfg: SlamConfig, maps, seed_budget: bool):
        # the static inputs, made on the current stream; the map's other
        # tensors and the camera's are read by address: kept alive
        self.cam, self.cfg, self.maps = cam, cfg, maps
        self.seed_budget = seed_budget
        self.frame = Frame(*(torch.empty_like(t) for t in frame))
        self.args = tuple(torch.empty_like(t) for t in args)
        self.state = state._replace(**{f: torch.empty_like(getattr(state, f))
                                       for f in _COPIED})
        self.inputs = (*self.frame, *self.args,
                       *(getattr(self.state, f) for f in _COPIED))

    def capture(self, final_map: bool):
        """Capture both graphs on the current stream, which must not be the
        default one."""
        st, fr, a = self.state, self.frame, self.args
        cam, cfg = self.cam, self.cfg
        self.motion, self.local_map = (torch.cuda.CUDAGraph(),
                                       torch.cuda.CUDAGraph())
        pool = torch.cuda.graph_pool_handle()
        before = [dict(c) for c in _tallies()]
        with _capturing(self.motion, pool):
            self.seed = _motion_stage(st, fr, a[0], a[1], a[4:10], cam, cfg,
                                      self.seed_budget, final_map)
            self.need_ref = _needs_ref(self.seed.tr, cfg)
            self.retry = _needs_retry(self.seed.tr)
        with _capturing(self.local_map, pool):
            s = self.seed
            self.out = _refine_stage(st, fr, s.tr, s.slots, s.old, s.ok_a,
                                     self.need_ref, a[10], cam, cfg)
        # the capture counted launches that only the replays run
        self.launches = [{k: c[k] - n for k, n in b.items()}
                         for c, b in zip(_tallies(), before)]
        for c, b in zip(_tallies(), before):
            c.update(b)

    def replay(self, state: MapState, frame: Frame, args) -> FullTrackResult:
        """track_full on these inputs: the inputs copied in, the motion
        graph replayed, the branch reads and fallbacks as in the eager
        route, the local-map graph replayed, its outputs cloned, so that no
        later replay writes into a result returned."""
        s, a = self.seed, self.args
        with annotate("tracking.motion"):
            for dst, src in zip(self.inputs, (*frame, *args, *(
                    getattr(state, f) for f in _COPIED))):
                dst.copy_(src)
            self.motion.replay()
            retry = host_sync(self.retry)
        tr, need_ref = _fallbacks(self.state, self.frame, s, retry,
                                  self.need_ref, a[2], a[3], a[4:10], a[10],
                                  self.cam, self.cfg, self.seed_budget)
        if tr is not s.tr:
            for dst, src in zip(s.tr, tr):
                dst.copy_(src)
        if need_ref is not self.need_ref:
            self.need_ref.copy_(need_ref)
        with annotate("tracking.local_map"):
            self.local_map.replay()
            out = FullTrackResult(*(t.clone() for t in self.out))
        for c, n in zip(_tallies(), self.launches):
            for k, v in n.items():
                c[k] += v
        return out


def _capture(state: MapState, frame: Frame, args, cam: Camera,
             cfg: SlamConfig, maps, final_map: bool,
             seed_budget: bool = False):
    """A key's first call on the card: (the eager result, the graphs). The
    graphs' static inputs are made on the current stream; the eager call
    and the capture run on a side stream that waits for the current one and
    that it then waits for."""
    graphs = _CascadeGraphs(state, frame, args, cam, cfg, maps, seed_budget)
    dev = state.pt_xyz.device
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = _track_full_eager(state, frame, *args, cam, cfg, final_map,
                                seed_budget)
        graphs.capture(final_map)
    main.wait_stream(side)
    for t in out:
        t.record_stream(main)
    return out, graphs


def _graph_route(state: MapState, final_map: bool) -> bool:
    """Whether track_full captures and replays: localization mode on the
    card."""
    return final_map and state.pt_xyz.is_cuda


def track_full(state: MapState, frame: Frame, R_pred, t_pred, R_last, t_last,
               last_uv, last_desc, last_obs, last_valid, last_octave,
               last_angle, ref_kf, cam: Camera, cfg: SlamConfig,
               final_map: bool = False) -> FullTrackResult:
    """The whole per-frame OK-state cascade (Track(), Tracking.cc:192-492,
    minus keyframe creation); `final_map`: localization mode, in which no
    marker counts as old (marker_old). On the card in localization mode
    the first call of a graph_key runs eagerly and captures the cascade's
    two stages as CUDA graphs; later calls replay them and return fresh
    tensors."""
    args = (R_pred, t_pred, R_last, t_last, last_uv, last_desc, last_obs,
            last_valid, last_octave, last_angle, ref_kf)
    if not _graph_route(state, final_map):
        GRAPH["eager"] += 1
        return _track_full_eager(state, frame, *args, cam, cfg, final_map)
    head, maps = graph_key(state, frame, args, cam, cfg, final_map)
    graphs = _GRAPHS.get(head)
    if graphs is not None and graphs.maps == maps:
        GRAPH["replay"] += 1
        return graphs.replay(state, frame, args)
    _GRAPHS.pop(head, None)         # another map: its graphs go
    out, _GRAPHS[head] = _capture(state, frame, args, cam, cfg, maps,
                                  final_map)
    GRAPH["capture"] += 1
    return out


def track_full_img(state: MapState, img, R_pred, t_pred, R_last, t_last,
                   last_uv, last_desc, last_obs, last_valid, last_octave,
                   last_angle, ref_kf, cam: Camera, cfg: SlamConfig):
    """make_frame of the raw frame img [H, W], then track_full: (frame,
    FullTrackResult). The JAX package fuses the two into one program; here
    they are queued one after the other."""
    frame = make_frame(img, cam, cfg)
    return frame, track_full(state, frame, R_pred, t_pred, R_last, t_last,
                             last_uv, last_desc, last_obs, last_valid,
                             last_octave, last_angle, ref_kf, cam, cfg)


# ---------------------------------------------------------------------------
# chunked localization
# ---------------------------------------------------------------------------


def _chunk_result(state: MapState, frames, outs, R_last, t_last,
                  cfg: SlamConfig):
    """(ctrls [B, 20], carry) of a chunk whose frames were all tracked
    against the same map state: per-frame visible/found deltas summed, the
    last frame's context, the velocity of the last two poses."""
    vis = state.pt_visible + torch.stack(
        [o.pt_visible - state.pt_visible for o in outs]).sum(dim=0)
    found = state.pt_found + torch.stack(
        [o.pt_found - state.pt_found for o in outs]).sum(dim=0)
    last = outs[-1]
    R_prev, t_prev = ((outs[-2].Rcw, outs[-2].tcw) if len(outs) >= 2
                      else (R_last, t_last))
    vel, ok_last = _motion_advance(last, R_prev, t_prev, cfg)
    carry = (last.Rcw, last.tcw, *vel, ok_last,
             *_frame_context(frames[-1], last.obs_point), vis, found)
    return torch.stack([o.ctrl for o in outs]), carry


def track_batch(state: MapState, imgs, R_last, t_last, vel_R, vel_t, has_vel,
                last_uv, last_desc, last_obs, last_valid, last_octave,
                last_angle, ref_kf, cam: Camera, cfg: SlamConfig):
    """Localization-mode tracking of a chunk of consecutive frames
    imgs [B, H, W] (reference localization pass, mono_cvcam.cc:183-235).
    Returns (ctrls [B, 20] in the FullTrackResult.ctrl layout, carry =
    (R, t, vel_R, vel_t, ok, kp_uv, desc, obs_point, kp_valid, kp_octave,
    kp_angle, pt_visible, pt_found) of the chunk's last frame). has_vel is a
    0-d bool tensor. The frames are built one by one (make_frame takes one
    image); the modes are the JAX package's:

      * extrapolate (loc_two_stage, loc_seed_mode "extrapolate"): every
        seed is the velocity composed i+1 times onto the last pose, or an
        absolute marker pose where one passes loc_seed_marker_err; each
        frame matches the map directly at loc_extrap_radius_scale x the
        radius, then (loc_extrap_passes >= 2) one more local-map refine.
        No host sync.
      * two-stage (loc_two_stage): the motion-model cascade in sequence
        with a trimmed LM, then every frame's local-map refine against the
        chunk's input map state. Two host branches per frame, as
        `_cascade_seed` has.
      * sequential: `track_full` frame after frame, each on the previous
        frame's visible/found counts.

    The map is final in every mode: no marker counts as old (marker_old).
    """
    frames = [make_frame(im, cam, cfg) for im in imgs]
    tcfg = cfg.tracking
    vel = (vel_R, vel_t)
    if tcfg.loc_two_stage and tcfg.loc_seed_mode == "extrapolate":
        outs = []
        Rp, tp = R_last, t_last
        for frame in frames:
            Rp, tp = _motion_seed(Rp, tp, vel, has_vel)
            slots = bind_markers(state, frame)
            old = marker_old(state, slots, cfg, final_map=True)
            ok_a, R_a, t_a, _ = aruco_pose_candidate(
                state, frame, slots, cam, cfg, old=old,
                err_th=tcfg.loc_seed_marker_err)
            R0, t0 = torch.where(ok_a, R_a, Rp), torch.where(ok_a, t_a, tp)
            no_obs = torch.full_like(frame.kp_octave, -1)
            tr, (vis, found) = track_local_map(
                state, frame, slots, R0, t0, no_obs, cam, cfg, old=old,
                radius_scale=tcfg.loc_extrap_radius_scale)
            need_ref = tr.n_inliers < tcfg.min_inliers_track
            if tcfg.loc_extrap_passes <= 1:
                # already the final local-map track: no second search
                _, best_kf = local_point_mask(state, tr.obs_point,
                                              tcfg.max_local_keyframes)
                outs.append(_finish(state, frame, tr, tr.n_inliers, slots,
                                    old, ok_a, need_ref, ref_kf, best_kf,
                                    vis, found))
            else:
                outs.append(_cascade_refine(state, frame, tr, slots, old,
                                            ok_a, need_ref, ref_kf, cam, cfg))
        return _chunk_result(state, frames, outs, R_last, t_last, cfg)

    # two-stage and sequential: the motion-model cascade frame after frame
    st, Rl, tl, hv = state, R_last, t_last, has_vel
    last = (last_uv, last_desc, last_obs, last_valid, last_octave, last_angle)
    steps = []
    for frame in frames:
        R0, t0 = _motion_seed(Rl, tl, vel, hv)
        if tcfg.loc_two_stage:
            step = _cascade_seed(state, frame, R0, t0, Rl, tl, *last, ref_kf,
                                 cam, cfg, seed_budget=True, final_map=True)
            tr = step[0]
        else:
            tr = step = track_full(st, frame, R0, t0, Rl, tl, *last, ref_kf,
                                   cam, cfg, final_map=True)
            st = st._replace(pt_visible=tr.pt_visible, pt_found=tr.pt_found)
        vel, hv = _motion_advance(tr, Rl, tl, cfg)
        Rl, tl, last = tr.Rcw, tr.tcw, _frame_context(frame, tr.obs_point)
        steps.append(step)
    if tcfg.loc_two_stage:
        outs = [_cascade_refine(state, frame, *seed, ref_kf, cam, cfg)
                for frame, seed in zip(frames, steps)]
        return _chunk_result(state, frames, outs, R_last, t_last, cfg)
    carry = (Rl, tl, *vel, hv, *last, st.pt_visible, st.pt_found)
    return torch.stack([o.ctrl for o in steps]), carry
