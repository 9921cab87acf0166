"""Map maintenance: keyframe insertion, triangulation, point culling and
fusion, local / global bundle adjustment, keyframe culling, the marker
plane update.

Port of orb_slam2_aruco_tpu/pipeline/mapping.py (reference
src/LocalMapping.cc and the map-building parts of Tracking,
CreateInitialMapMonocular Tracking.cc:690-819 and CreateNewKeyFrame
:1394-1460), the distributed global BA included. Every function takes the
map and returns a new one; keyframe slots are Python ints the host already
knows (`SlamSystem` allocates them from its occupancy mirror), so no step
reads the device to index.

Scatters follow the JAX package's dump-row pattern: rejected entries go to
one extra row past the end, which is cut off afterwards. Where valid
targets could repeat, the reduction is explicit (`scatter_reduce` amax /
amin, `index_add_`); plain writes go only to targets that are unique.
Top-k always breaks ties by the lower index (ops/topk.stable_topk), as
`jax.lax.top_k` does.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.config import SlamConfig
from orb_slam2_aruco_tpu_torch.geometry import camera as cam_mod
from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.lie import se3_compose, se3_inverse
from orb_slam2_aruco_tpu_torch.geometry.triangulate import triangulate_dlt
from orb_slam2_aruco_tpu_torch.ops import matching
from orb_slam2_aruco_tpu_torch.ops.orb import unpack_pm1
from orb_slam2_aruco_tpu_torch.ops.topk import stable_topk
from orb_slam2_aruco_tpu_torch.optim import ba
from orb_slam2_aruco_tpu_torch.parallel import dist_ba
from orb_slam2_aruco_tpu_torch.pipeline.frontend import Frame, scale_sigma2
from orb_slam2_aruco_tpu_torch.pipeline.tracking import host_read, mark, row
from orb_slam2_aruco_tpu_torch.utils import threefry
from orb_slam2_aruco_tpu_torch.utils.consts import const
from orb_slam2_aruco_tpu_torch.worldmap.covisibility import (
    covisibility_matrix,
)
from orb_slam2_aruco_tpu_torch.worldmap.state import (
    MapState,
    first_free_slot,
    free_slots,
)

# plane hypotheses per marker in aruco_plane_update (mapping.py:1007)
PLANE_HYPOTHESES = 16
# descriptors per point considered for distinctiveness (mapping.py:1264)
MAX_DESC_OBS = 8
# fused pairs whose incidence rows merge per fuse_duplicates call
FUSE_BUDGET = 256


def _scale_factors(cfg: SlamConfig, device):
    return const(("scale_factors", cfg.orb.num_levels, cfg.orb.scale_factor),
                 device, lambda: np.asarray(
                     [cfg.orb.scale_factor**lv
                      for lv in range(cfg.orb.num_levels)], np.float32))


def _sig2(cfg: SlamConfig, device):
    return scale_sigma2(cfg.orb.num_levels, cfg.orb.scale_factor, device)


def _set_rows(arr, tgt, vals):
    """arr with rows tgt set to vals, where tgt == len(arr) drops the row
    (the JAX package's concatenate-pad, .at[].set, crop). Valid targets
    must be unique."""
    n = arr.shape[0]
    pad = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])
    pad[tgt] = vals.to(arr.dtype)
    return pad[:n]


def _scatter_reduce_rows(arr, tgt, vals, reduce: str):
    """arr[tgt[i]] = reduce(arr[tgt[i]], vals[i]) over a one-row-padded
    buffer (pad row zero, cut off): amax / amin with any repeats."""
    n = arr.shape[0]
    pad = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])
    idx = tgt.reshape((-1,) + (1,) * (arr.dim() - 1)).expand(
        (tgt.shape[0],) + arr.shape[1:])
    return pad.scatter_reduce(0, idx, vals.to(arr.dtype), reduce,
                              include_self=True)[:n]


def _centers(R, t):
    return se3_inverse(R, t)[1]


# ---------------------------------------------------------------------------
# keyframe insertion
# ---------------------------------------------------------------------------


def create_keyframe(state: MapState, frame: Frame, Rcw, tcw, obs_point,
                    slots, frame_id: int, ts: float, cam: Camera,
                    cfg: SlamConfig, mk_old=None, slot=None):
    """Insert the frame as keyframe `slot` and create MapAruco entries for
    its new good markers, Twm = Twc * Tcm (CreateNewKeyFrame,
    Tracking.cc:1394-1460). Returns (state, slot). `slot` None takes the
    first free slot, one host read (counted in tracking.SYNCS); the system
    passes the slot from its host mirror of kf_valid."""
    k = int(slot if slot is not None
            else host_read(first_free_slot(state.kf_valid)))
    A = slots.shape[0]
    M, L = state.M, state.L
    new_mk = frame.mk_valid & frame.mk_good & (slots < 0)
    mk_free = free_slots(state.mk_valid, A)
    rank = torch.cumsum(new_mk.to(torch.int64), 0) - 1
    # an out-of-range gather clamps, as XLA's does (M < A maps)
    alloc_slot = mk_free[torch.clamp(rank, 0, min(A, mk_free.shape[0]) - 1)]
    can_alloc = new_mk & (rank < A) & ~state.mk_valid[alloc_slot]
    final_slot = torch.where(can_alloc, alloc_slot, slots)
    Rwc, twc = se3_inverse(Rcw, tcw)
    Rwm_new, twm_new = se3_compose(Rwc.expand(frame.mk_Rcm.shape),
                                   twc.expand(frame.mk_tcm.shape),
                                   frame.mk_Rcm, frame.mk_tcm)
    tgt = torch.where(can_alloc, alloc_slot, M)

    def put(field, value):
        # a Python number goes in by fill_: `a[k] = number` copies it from
        # the host, a synchronizing call on the card
        a = getattr(state, field).clone()
        if isinstance(value, torch.Tensor):
            a[k] = value.to(a.dtype)
        else:
            a[k].fill_(value)
        return a

    pt_col = state.pt_obs_kf.clone()
    pt_col[:, k] = mark(L, obs_point)
    state = state._replace(
        kf_Rcw=put("kf_Rcw", Rcw), kf_tcw=put("kf_tcw", tcw),
        kf_valid=put("kf_valid", True),
        kf_frame_id=put("kf_frame_id", int(frame_id)),
        kf_ts=put("kf_ts", float(np.float32(ts))),
        kf_seq=put("kf_seq", state.next_seq),
        next_seq=state.next_seq + 1,
        kf_kp_uv=put("kf_kp_uv", frame.kp_uv),
        kf_kp_octave=put("kf_kp_octave", frame.kp_octave),
        kf_kp_angle=put("kf_kp_angle", frame.kp_angle),
        kf_desc=put("kf_desc", frame.desc),
        kf_kp_valid=put("kf_kp_valid", frame.kp_valid),
        kf_obs_point=put("kf_obs_point", obs_point),
        pt_obs_kf=pt_col,
        mk_Rwm=_set_rows(state.mk_Rwm, tgt, Rwm_new),
        mk_twm=_set_rows(state.mk_twm, tgt, twm_new),
        mk_id=_set_rows(state.mk_id, tgt, frame.mk_ids),
        mk_valid=_set_rows(state.mk_valid, tgt, can_alloc),
        kf_mk_slot=put("kf_mk_slot", final_slot),
        kf_mk_uv=put("kf_mk_uv", frame.mk_corners),
        kf_mk_valid=put("kf_mk_valid", frame.mk_valid & (final_slot >= 0)),
        kf_mk_old=put("kf_mk_old", mk_old if mk_old is not None
                      else torch.zeros_like(final_slot, dtype=torch.bool)),
        kf_bow=put("kf_bow", frame.bow),
    )
    return state, k


# ---------------------------------------------------------------------------
# triangulation of new map points
# ---------------------------------------------------------------------------


def _tri_candidates(state: MapState, kf_new: int, nb, cam: Camera,
                    cfg: SlamConfig, enable):
    """Triangulation candidates of the new keyframe against neighbour `nb`
    (a 1-element slot tensor) without any state write (the match + DLT +
    gate half of CreateNewMapPoints, LocalMapping.cc:222-467): (good [N],
    xyz [N, 3], prev_idx [N], cos_parallax [N]) over the new keyframe's
    features."""
    dev = state.kf_Rcw.device
    d_new, d_prev = state.kf_desc[kf_new], row(state.kf_desc, nb)
    free_new = state.kf_kp_valid[kf_new] & (state.kf_obs_point[kf_new] < 0)
    free_prev = row(state.kf_kp_valid, nb) & (row(state.kf_obs_point, nb) < 0)
    dist = matching.distance_matrix(d_new, d_prev, free_new, free_prev)
    R1, t1 = row(state.kf_Rcw, nb), row(state.kf_tcw, nb)
    R2, t2 = state.kf_Rcw[kf_new], state.kf_tcw[kf_new]
    # epipolar gate before the nearest-neighbour choice (CheckDistEpipolar-
    # Line, ORBmatcher.cc:140-157)
    R21, t21 = se3_compose(R2, t2, *se3_inverse(R1, t1))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tx, ty, tz = t21[0], t21[1], t21[2]
    skew = torch.stack([torch.stack([zero, -tz, ty]),
                        torch.stack([tz, zero, -tx]),
                        torch.stack([-ty, tx, zero])])
    E = skew @ R21
    one = torch.ones_like(zero)
    Kinv = torch.stack([
        torch.stack([1.0 / cam.fx, zero, -cam.cx / cam.fx]),
        torch.stack([zero, 1.0 / cam.fy, -cam.cy / cam.fy]),
        torch.stack([zero, zero, one])])
    F = Kinv.T @ E @ Kinv
    uv1_all, uv2_all = row(state.kf_kp_uv, nb), state.kf_kp_uv[kf_new]
    ones = torch.ones_like(uv1_all[:, :1])
    lines = torch.cat([uv1_all, ones], dim=1) @ F.T          # [N_prev, 3]
    num = torch.abs(torch.cat([uv2_all, ones], dim=1) @ lines.T)
    den = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)[None, :]
    epi_d2 = (num / torch.clamp(den, min=1e-9)) ** 2
    sig2 = _sig2(cfg, dev)
    s2_new = sig2[state.kf_kp_octave[kf_new]]
    dist = torch.where(epi_d2 * s2_new[:, None] < 3.84, dist, float("inf"))
    m = matching.nn_match(dist, max_dist=float(cfg.matcher.th_low),
                          nn_ratio=0.8, mutual=True)
    prev_idx = torch.clamp(m.idx, min=0)
    uv_prev = uv1_all[prev_idx]
    xn2 = cam_mod.pixels_to_normalized(cam, uv2_all)
    xn1 = cam_mod.pixels_to_normalized(cam, uv_prev)
    n = xn1.shape[0]
    xyz = triangulate_dlt(R1.expand(n, 3, 3), t1.expand(n, 3),
                          R2.expand(n, 3, 3), t2.expand(n, 3), xn1, xn2)
    p1 = xyz @ R1.T + t1
    p2 = xyz @ R2.T + t2
    e1 = torch.sum((cam_mod.project(cam, p1) - uv_prev) ** 2, dim=-1)
    e2 = torch.sum((cam_mod.project(cam, p2) - uv2_all) ** 2, dim=-1)
    r1 = xyz - _centers(R1, t1)[None]
    r2 = xyz - _centers(R2, t2)[None]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-9)
    good = (m.valid & enable & torch.isfinite(xyz).all(dim=-1)
            & (p1[:, 2] > 0.02) & (p2[:, 2] > 0.02)
            & (e1 * s2_new < 5.991) & (e2 * s2_new < 5.991)
            & (cosp < 0.9999))
    return good, xyz, prev_idx, cosp


def triangulate_new_points(state: MapState, kf_new: int, kf_prev: int,
                           cam: Camera, cfg: SlamConfig, max_new: int = 256):
    """Two-view triangulation between a new keyframe and one neighbour
    (CreateNewMapPoints, LocalMapping.cc:222-467). Returns (state,
    n_created [] tensor)."""
    dev = state.kf_Rcw.device
    nb = torch.full((1,), int(kf_prev), dtype=torch.int64, device=dev)
    good, xyz, prev_idx, _ = _tri_candidates(
        state, kf_new, nb, cam, cfg, torch.ones((), dtype=torch.bool,
                                                device=dev))
    return _allocate_points(state, kf_new, nb.expand(good.shape[0]),
                            prev_idx, good, xyz, cfg, max_new)


def triangulate_vs_covisible(state: MapState, kf_new: int, cam: Camera,
                             cfg: SlamConfig, n_neighbors: int = 20,
                             max_new: int = 256):
    """Triangulate the new keyframe against its top-N covisible neighbours
    that pass the baseline / mean-scene-depth > 1 % gate (LocalMapping.cc:
    222-260); each free feature keeps its best-parallax candidate over all
    neighbours, then one allocation pass creates the points. Returns
    (state, n_created [] tensor)."""
    K = state.K
    dev = state.kf_Rcw.device
    row_new = state.pt_obs_kf[:, kf_new] & state.pt_valid
    inc = state.pt_obs_kf & state.kf_valid[None, :]
    share = row_new.to(torch.float32) @ inc.to(torch.float32)     # [K]
    kiota = torch.arange(K, device=dev)
    share = torch.where((kiota == kf_new) | ~state.kf_valid, 0.0, share)
    c_all = _centers(state.kf_Rcw, state.kf_tcw)                  # [K, 3]
    baseline = torch.linalg.norm(c_all - c_all[kf_new][None], dim=-1)
    z_all = state.pt_xyz @ state.kf_Rcw[:, 2, :].T + state.kf_tcw[None, :, 2]
    obs_v = inc & state.pt_valid[:, None]
    depth_sum = torch.where(obs_v, z_all, 0.0).sum(dim=0)
    depth_cnt = torch.clamp(obs_v.to(torch.float32).sum(dim=0), min=1.0)
    mean_depth = depth_sum / depth_cnt
    ratio_ok = baseline / torch.clamp(mean_depth, min=1e-6) > 0.01
    share = torch.where(ratio_ok, share, 0.0)
    top_w, top_idx = stable_topk(share, min(n_neighbors, K))
    cands = [_tri_candidates(state, kf_new, top_idx[j:j + 1], cam, cfg,
                             top_w[j] > 0)
             for j in range(top_idx.shape[0])]
    good_n = torch.stack([c[0] for c in cands])                   # [n, N]
    xyz_n = torch.stack([c[1] for c in cands])                    # [n, N, 3]
    prev_n = torch.stack([c[2] for c in cands])
    cosp_n = torch.stack([c[3] for c in cands])
    score = torch.where(good_n, -cosp_n, float("-inf"))
    choice = torch.argmax(score, dim=0)                           # [N]
    good = good_n.any(dim=0)
    xyz = torch.gather(xyz_n, 0, choice[None, :, None].expand(1, -1, 3))[0]
    prev_idx = torch.gather(prev_n, 0, choice[None])[0]
    return _allocate_points(state, kf_new, top_idx[choice], prev_idx, good,
                            xyz, cfg, max_new)


def _allocate_points(state: MapState, kf_new: int, nb_slot, prev_idx, good,
                     xyz, cfg: SlamConfig, max_new: int):
    """One allocation pass for the chosen candidates: slots, the stale-
    reference scrub, point attributes, observation rows (the state-write
    half of CreateNewMapPoints)."""
    N = good.shape[0]
    K, L = state.K, state.L
    dev = xyz.device
    rank = torch.cumsum(good.to(torch.int64), 0) - 1
    slots_free = free_slots(state.pt_valid, max_new)
    pslot = slots_free[torch.clamp(rank, 0, slots_free.shape[0] - 1)]
    can = good & (rank < max_new) & ~state.pt_valid[pslot]
    tgt = torch.where(can, pslot, L)
    # clear stale feature->point references to the (re)allocated slots
    recycled = mark(L, pslot, can)
    obs_all = state.kf_obs_point
    stale = (obs_all >= 0) & recycled[torch.clamp(obs_all, min=0)]
    state = state._replace(kf_obs_point=torch.where(stale, -1, obs_all))

    view = xyz - _centers(state.kf_Rcw[kf_new], state.kf_tcw[kf_new])[None]
    vdist = torch.linalg.norm(view, dim=-1)
    normal = view / torch.clamp(vdist[..., None], min=1e-9)
    sf = _scale_factors(cfg, dev)
    max_d = vdist * sf[state.kf_kp_octave[kf_new]]
    min_d = max_d / sf[-1]
    full = lambda v, dt: torch.full((N,), v, dtype=dt, device=dev)  # noqa
    state = state._replace(
        pt_xyz=_set_rows(state.pt_xyz, tgt, xyz),
        pt_valid=_set_rows(state.pt_valid, tgt, can),
        pt_desc=_set_rows(state.pt_desc, tgt, state.kf_desc[kf_new]),
        pt_normal=_set_rows(state.pt_normal, tgt, normal),
        pt_min_dist=_set_rows(state.pt_min_dist, tgt, min_d),
        pt_max_dist=_set_rows(state.pt_max_dist, tgt, max_d),
        pt_ref_kf=_set_rows(state.pt_ref_kf, tgt, full(kf_new, torch.int64)),
        # creation stamp = the creating keyframe's insertion sequence
        pt_first_kf=_set_rows(state.pt_first_kf, tgt,
                              state.kf_seq[kf_new].expand(N)),
        pt_found=_set_rows(state.pt_found, tgt, full(1.0, torch.float32)),
        pt_visible=_set_rows(state.pt_visible, tgt,
                             full(1.0, torch.float32)),
        pt_aruco=_set_rows(state.pt_aruco, tgt, full(-1, torch.int64)),
    )
    # observations: the new keyframe's row, then each chosen neighbour's
    # matched feature (a flat [K + 1, N] scatter-max, dump row K)
    kf_obs = state.kf_obs_point.clone()
    kf_obs[kf_new] = torch.where(can, pslot, kf_obs[kf_new])
    flat = torch.cat([kf_obs, kf_obs.new_zeros((1, N))]).reshape(-1)
    flat = flat.scatter_reduce(
        0, torch.where(can, nb_slot, K) * N + prev_idx,
        torch.where(can, pslot, -1), "amax", include_self=True)
    kiota = torch.arange(K, device=dev)
    inc_rows = ((kiota[None, :] == kf_new)
                | (kiota[None, :] == nb_slot[:, None]))
    state = state._replace(
        kf_obs_point=flat.reshape(K + 1, N)[:K],
        pt_obs_kf=_set_rows(state.pt_obs_kf, tgt, inc_rows))
    return state, can.sum()


# ---------------------------------------------------------------------------
# point culling
# ---------------------------------------------------------------------------


def cull_points(state: MapState, min_found_ratio: float = 0.25):
    """MapPointCulling (LocalMapping.cc:185-220): drop points at most 3
    keyframe insertions old whose found/visible ratio is poor or that have
    2 or fewer observing keyframes from their second insertion on. Returns
    (state, n_culled [] tensor)."""
    ratio = state.pt_found / torch.clamp(state.pt_visible, min=1.0)
    cnt = (state.pt_obs_kf & state.kf_valid[None, :]).sum(dim=1)
    age = (state.next_seq - 1) - torch.clamp(state.pt_first_kf, min=0)
    recent = age <= 3
    bad = state.pt_valid & recent & ((ratio < min_found_ratio)
                                     | ((age >= 2) & (cnt <= 2)))
    new_valid = state.pt_valid & ~bad
    obs = state.kf_obs_point
    stale = (obs >= 0) & ~new_valid[torch.clamp(obs, min=0)]
    return state._replace(pt_valid=new_valid,
                          kf_obs_point=torch.where(stale, -1, obs)), bad.sum()


# ---------------------------------------------------------------------------
# local / global bundle adjustment over the map state
# ---------------------------------------------------------------------------


def build_ba_problem(state: MapState, center_kf: int, cfg: SlamConfig,
                     max_cams: int = 16, max_pts: int = 4096,
                     window_all: bool = False, max_fixed: int = 0,
                     pt_offset: int = 0):
    """Window selection + edge lists (the problem-building half of
    LocalBundleAdjustment / GlobalBA): (prob, sel, sel_ok, pt_sel, pt_ok).
    `max_fixed`: capacity of the fixed observer ring of a local BA
    (Optimizer.cc:820-838)."""
    K, N = state.kf_obs_point.shape
    A = state.kf_mk_slot.shape[1]
    M, L = state.M, state.L
    dev = state.kf_Rcw.device
    big = 2**30
    if window_all:
        order_key = torch.where(state.kf_valid, state.kf_frame_id, -1)
        sel_val, sel = stable_topk(state.kf_valid.to(torch.int64)
                                   * (order_key + 2), max_cams)
        sel_ok = (sel_val > 0) & state.kf_valid[sel]
    else:
        W = covisibility_matrix(state)
        recency = torch.where(state.kf_valid, state.kf_frame_id, -1)
        score = torch.where(state.kf_valid,
                            W[center_kf].to(torch.float32) * 1e4
                            + recency.to(torch.float32), -1.0)
        score[center_kf].fill_(1e12)
        sel_val, sel = stable_topk(score, max_cams)
        sel_ok = (sel_val > 0) & state.kf_valid[sel]
        sel_val = recency[sel]
    # gauge: fix the oldest selected camera and the map's first keyframe
    first_kf = torch.argmin(torch.where(state.kf_valid, state.kf_frame_id,
                                        big))
    oldest = torch.argmin(torch.where(sel_ok, sel_val, big)).reshape(1)
    cam_free = sel_ok.to(torch.float32).index_fill(0, oldest, 0.0)
    cam_free = torch.where(sel == first_kf, 0.0, cam_free)

    obs_sel = state.kf_obs_point[sel]                             # [C, N]
    hit_ok = (obs_sel >= 0) & sel_ok[:, None] & state.kf_kp_valid[sel]
    pt_hit = mark(L, obs_sel.reshape(-1), hit_ok.reshape(-1)) & state.pt_valid
    if max_fixed > 0 and not window_all:
        inc = state.pt_obs_kf & state.kf_valid[None, :]
        ring_share = pt_hit.to(torch.float32) @ inc.to(torch.float32)
        in_window = mark(K, sel, sel_ok)
        ring_share = torch.where(in_window | ~state.kf_valid, 0.0, ring_share)
        ring_val, ring_sel = stable_topk(ring_share, max_fixed)
        sel = torch.cat([sel, ring_sel])
        sel_ok = torch.cat([sel_ok, ring_val > 0])
        cam_free = torch.cat([cam_free, cam_free.new_zeros((max_fixed,))])
        max_cams = max_cams + max_fixed
        obs_sel = state.kf_obs_point[sel]
    hit_score = pt_hit.to(torch.int64)
    if window_all:
        # GBA bucket rotation (mapping.py:584-594)
        band = ((torch.arange(L, device=dev) - pt_offset) % L) < max_pts
        hit_score = hit_score * (1 + band.to(torch.int64))
    hit_val, pt_sel = stable_topk(hit_score, max_pts)
    pt_ok = hit_val > 0
    comp = _set_rows(torch.full((L,), -1, dtype=torch.int64, device=dev),
                     torch.where(pt_ok, pt_sel, L),
                     torch.arange(max_pts, device=dev))

    e_kf = torch.arange(max_cams, device=dev).repeat_interleave(N)
    e_pt = torch.where(obs_sel >= 0, comp[torch.clamp(obs_sel, 0, L - 1)],
                       -1).reshape(-1)
    sig2 = _sig2(cfg, dev)
    e_mask = ((e_pt >= 0) & state.kf_kp_valid[sel].reshape(-1)
              & sel_ok.repeat_interleave(N)).to(torch.float32)
    mk_slot_sel = state.kf_mk_slot[sel]                           # [C, A]
    m_ok = ((mk_slot_sel >= 0) & state.kf_mk_valid[sel]
            & ~state.kf_mk_old[sel] & sel_ok[:, None])
    F = max_cams * A * 4
    prob = ba.BAProblem(
        Rcw=state.kf_Rcw[sel], tcw=state.kf_tcw[sel],
        points=state.pt_xyz[pt_sel], Rwm=state.mk_Rwm, twm=state.mk_twm,
        marker_side=state.mk_side,
        e_kf=e_kf, e_pt=torch.clamp(e_pt, min=0),
        e_uv=state.kf_kp_uv[sel].reshape(-1, 2),
        e_info=sig2[state.kf_kp_octave[sel]].reshape(-1), e_mask=e_mask,
        m_kf=torch.arange(max_cams, device=dev).repeat_interleave(A * 4),
        m_marker=torch.clamp(mk_slot_sel, 0, M - 1).reshape(-1)
        .repeat_interleave(4),
        m_corner=torch.arange(4, device=dev).repeat(max_cams * A),
        m_uv=state.kf_mk_uv[sel].reshape(-1, 2),
        m_info=torch.full((F,), cfg.aruco.edge_weight, dtype=torch.float32,
                          device=dev),
        m_mask=m_ok.reshape(-1).repeat_interleave(4).to(torch.float32),
        cam_free=cam_free, pt_free=pt_ok.to(torch.float32),
        marker_free=state.mk_valid.to(torch.float32),
    )
    return prob, sel, sel_ok, pt_sel, pt_ok


def writeback_ba(state: MapState, out: ba.BAResult, e_mask, sel, sel_ok,
                 pt_sel, pt_ok, cfg: SlamConfig, propagate: bool = False,
                 erase_outliers: bool = True):
    """Scatter a BA solution back into the map (Optimizer.cc:1207-1240),
    erasing chi2 > 5.991 observations in a local BA (:1171-1201).
    `propagate` (global BA): points outside the problem's bucket move with
    their reference keyframe's pose delta (LoopClosing.cc:1190-1224)."""
    K, N = state.kf_obs_point.shape
    L = state.L
    C = sel.shape[0]
    kf_tgt = torch.where(sel_ok, sel, K)
    kf_Rcw = _set_rows(state.kf_Rcw, kf_tgt, out.Rcw)
    kf_tcw = _set_rows(state.kf_tcw, kf_tgt, out.tcw)
    pt_tgt = torch.where(pt_ok, pt_sel, L)
    pt_xyz = _set_rows(state.pt_xyz, pt_tgt, out.points)
    if propagate:
        moved = mark(K, sel, sel_ok)
        written = mark(L, pt_sel, pt_ok)
        ref_raw = state.pt_ref_kf
        ref_c = torch.clamp(ref_raw, 0, K - 1)
        obs_ok = state.pt_obs_kf & state.kf_valid[None, :]
        ref_live = ((ref_raw >= 0) & state.kf_valid[ref_c]
                    & torch.gather(obs_ok, 1, ref_c[:, None])[:, 0])
        eff_ref = torch.where(ref_live, ref_c,
                              torch.argmax(obs_ok.to(torch.int32), dim=1))
        eff_ok = ref_live | obs_ok.any(dim=1)
        prop = state.pt_valid & ~written & eff_ok & moved[eff_ref]
        x_cam = ((state.kf_Rcw[eff_ref] @ state.pt_xyz[..., None])[..., 0]
                 + state.kf_tcw[eff_ref])
        x_prop = (kf_Rcw[eff_ref].transpose(-1, -2)
                  @ (x_cam - kf_tcw[eff_ref])[..., None])[..., 0]
        pt_xyz = torch.where(prop[:, None], x_prop, pt_xyz)
    obs_rows = state.kf_obs_point[sel].reshape(-1)
    if erase_outliers:
        edge_bad = (out.edge_chi2 > cfg.optim.chi2_mono) & (e_mask > 0)
        obs_rows = torch.where(edge_bad, -1, obs_rows)
    obs_rows = obs_rows.reshape(C, N)
    kf_obs = _set_rows(state.kf_obs_point, kf_tgt, obs_rows)
    # rebuild the incidence columns of the window keyframes
    cols = torch.zeros((C, L + 1), dtype=torch.bool, device=sel.device)
    cols.scatter_(1, torch.where(obs_rows >= 0, obs_rows, L), True)
    pt_obs_kf = _set_rows(state.pt_obs_kf.T, kf_tgt, cols[:, :L]).T
    state = state._replace(
        kf_Rcw=kf_Rcw, kf_tcw=kf_tcw, pt_xyz=pt_xyz, kf_obs_point=kf_obs,
        pt_obs_kf=pt_obs_kf.contiguous(),
        mk_Rwm=torch.where(state.mk_valid[:, None, None], out.Rwm,
                           state.mk_Rwm),
        mk_twm=torch.where(state.mk_valid[:, None], out.twm, state.mk_twm))
    return state, out.chi2


def bundle_adjust(state: MapState, center_kf: int, cam: Camera,
                  cfg: SlamConfig, max_cams: int = 16, max_pts: int = 4096,
                  iters: int = 10, window_all: bool = False,
                  max_fixed: int = 0, pt_offset: int = 0):
    """Windowed BA over `center_kf` and its best covisible keyframes
    (LocalBundleAdjustment, Optimizer.cc:772-1242), or over all keyframes
    (global BA) when window_all; the oldest selected camera and the map's
    first keyframe are the gauge; every valid marker joins with its corner
    edges. Returns (state, chi2)."""
    prob, sel, sel_ok, pt_sel, pt_ok = build_ba_problem(
        state, center_kf, cfg, max_cams=max_cams, max_pts=max_pts,
        window_all=window_all, max_fixed=max_fixed, pt_offset=pt_offset)
    out = ba.ba_solve(prob, cam, iters=iters,
                      huber_delta=cfg.optim.huber_delta,
                      lam0=cfg.optim.lm_lambda_init)
    return writeback_ba(state, out, prob.e_mask, sel, sel_ok, pt_sel, pt_ok,
                        cfg, propagate=window_all,
                        erase_outliers=not window_all)


def bundle_adjust_distributed(state: MapState, center_kf: int, cam: Camera,
                              cfg: SlamConfig, mesh, max_cams: int = 256,
                              max_pts: int = 8192, iters: int = 10,
                              window_all: bool = True, pt_offset: int = 0):
    """Global BA with the observations sharded over `mesh`, a list of
    devices (parallel.dist_ba.distributed_ba_solve): bundle_adjust's
    problem and write-back around the sharded solve. Enabled in the
    tracking loop by cfg.optim.distributed_gba. The solve's result lies on
    mesh[0], so mesh[0] must be the map's device. Returns (state, chi2)."""
    mesh = dist_ba.make_mesh(devices=mesh)
    if mesh[0] != state.kf_Rcw.device:
        raise ValueError(f"the mesh's lead device {mesh[0]} is not the "
                         f"map's device {state.kf_Rcw.device}")
    prob, sel, sel_ok, pt_sel, pt_ok = build_ba_problem(
        state, center_kf, cfg, max_cams=max_cams, max_pts=max_pts,
        window_all=window_all, pt_offset=pt_offset)
    out = dist_ba.distributed_ba_solve(prob, cam, mesh, iters=iters,
                                       huber_delta=cfg.optim.huber_delta,
                                       lam0=cfg.optim.lm_lambda_init)
    # the write-back indexes edges by the original [max_cams * N] layout
    out = out._replace(edge_chi2=out.edge_chi2[:prob.e_kf.shape[0]])
    return writeback_ba(state, out, prob.e_mask, sel, sel_ok, pt_sel, pt_ok,
                        cfg, propagate=window_all,
                        erase_outliers=not window_all)


# ---------------------------------------------------------------------------
# keyframe culling
# ---------------------------------------------------------------------------


def cull_keyframes(state: MapState, keep_kf: int, cfg: SlamConfig,
                   force: bool = False):
    """KeyFrameCulling (LocalMapping.cc:1000-1082): a keyframe is redundant
    if over 90 % of its points have >= 3 other observing keyframes; one
    observing a marker with <= 5 observations, one holding a loop edge,
    `keep_kf` and the first keyframe are never culled. At most one
    keyframe per call; `force` evicts the most redundant eligible one even
    below the gate. Returns (state, victim [] tensor, -1 for none)."""
    K = state.K
    L, M = state.L, state.M
    dev = state.kf_valid.device
    obs = torch.where(state.kf_kp_valid & state.kf_valid[:, None],
                      state.kf_obs_point, -1)
    cnt = (state.pt_obs_kf & state.kf_valid[None, :]).sum(dim=1)
    has_pt = obs >= 0
    redundant = has_pt & (cnt[torch.clamp(obs, 0, L - 1)] >= 4)
    n_pts = has_pt.to(torch.float32).sum(dim=1)
    ratio = redundant.to(torch.float32).sum(dim=1) / torch.clamp(n_pts,
                                                                 min=1.0)
    mk_obs = torch.where(state.kf_mk_valid & state.kf_valid[:, None],
                         state.kf_mk_slot, -1)
    mk_cnt = torch.zeros((M + 1,), dtype=torch.int64, device=dev).index_add_(
        0, torch.where(mk_obs >= 0, mk_obs, M).reshape(-1),
        torch.ones(mk_obs.numel(), dtype=torch.int64, device=dev))[:M]
    rare = mk_cnt <= cfg.map.kf_cull_marker_min_obs
    sees_rare = torch.where(mk_obs >= 0, rare[torch.clamp(mk_obs, 0, M - 1)],
                            False).any(dim=1)
    first_kf = torch.argmin(torch.where(state.kf_valid, state.kf_frame_id,
                                        2**30)).reshape(1)
    in_loop = (mark(K, torch.clamp(state.loop_i, 0, K - 1), state.loop_valid)
               | mark(K, torch.clamp(state.loop_j, 0, K - 1),
                       state.loop_valid))
    eligible = state.kf_valid & ~sees_rare & ~in_loop
    eligible[keep_kf].fill_(False)
    eligible = eligible.index_fill(0, first_kf, False)
    candidate = eligible & (ratio > cfg.map.kf_cull_redundancy) & (n_pts > 10)
    score = torch.where(candidate, 2.0 + ratio,
                        torch.where(eligible & bool(force), ratio, -1.0))
    any_c = score.max() >= 0.0
    victim = torch.argmax(score)
    kf_valid = torch.where(any_c, state.kf_valid.index_fill(
        0, victim.reshape(1), False), state.kf_valid)
    return state._replace(kf_valid=kf_valid), torch.where(any_c, victim, -1)


# ---------------------------------------------------------------------------
# marker plane fitting, quality promotion, one-shot scale correction
# ---------------------------------------------------------------------------


def _point_in_quad(uv, quad):
    """Convex-quad inside test by cross-product signs: uv [..., 2], quad
    [..., 4, 2] (consistent winding) -> bool [...]."""
    def cross(o, a, b):
        return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
                - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))

    s = torch.stack([cross(quad[..., c, :], quad[..., (c + 1) % 4, :], uv)
                     for c in range(4)], dim=-1)
    return (s >= 0).all(dim=-1) | (s <= 0).all(dim=-1)


def aruco_plane_update(state: MapState, kf: int, cam: Camera,
                       cfg: SlamConfig):
    """Plane-fit marker measurement + one-shot metric scale correction
    (CreateArucoMapPoints, LocalMapping.cc:487-797): tag the points inside
    each observed marker quad; per marker, 16 random 5-point plane
    hypotheses (drawn as the JAX package draws them, utils/threefry), keep
    the one whose ray-intersected corners give the most equal sides;
    accumulate the measured side, promote / strike the marker by the
    normal's angle; rescale the map once when enough markers agree.
    Returns (state, s [] tensor, 1 when nothing was rescaled)."""
    A = state.kf_mk_slot.shape[1]
    N = state.kf_obs_point.shape[1]
    M, L = state.M, state.L
    dev = state.kf_Rcw.device
    Rwc, twc = se3_inverse(state.kf_Rcw[kf], state.kf_tcw[kf])
    obs = state.kf_obs_point[kf]
    has_pt = ((obs >= 0) & state.kf_kp_valid[kf]
              & state.pt_valid[torch.clamp(obs, min=0)])
    X = state.pt_xyz[torch.clamp(obs, min=0)]                    # [N, 3]
    uv = state.kf_kp_uv[kf]
    quads = state.kf_mk_uv[kf]                                   # [A, 4, 2]
    mk_slots = state.kf_mk_slot[kf]
    mk_obs_ok = state.kf_mk_valid[kf] & (mk_slots >= 0)
    inside = _point_in_quad(uv[None], quads[:, None])            # [A, N]
    w0 = inside & has_pt[None, :]
    enough = w0.sum(dim=1) >= cfg.aruco.plane_fit_min_points

    # marker tag of every point inside an observed quad (MapPointRelatedAruco)
    slot_per_feat = torch.where(w0 & mk_obs_ok[:, None],
                                torch.clamp(mk_slots, 0, M - 1)[:, None],
                                -1).max(dim=0).values            # [N]
    tag_tgt = torch.where((slot_per_feat >= 0) & has_pt,
                          torch.clamp(obs, min=0), L)
    state = state._replace(pt_aruco=_scatter_reduce_rows(
        state.pt_aruco, tag_tgt, slot_per_feat, "amax"))

    # 5-point plane hypotheses; the JAX draw broadcasts the [A, 1, N] mask
    # against [A, H, 5, N], so hypothesis h of every marker samples the
    # points of marker row h (mapping.py:1015-1017)
    H = PLANE_HYPOTHESES
    key = threefry.fold_in(threefry.PRNGKey(17), kf)
    mask = w0 | ~w0.any(dim=1, keepdim=True)
    samp = threefry.categorical_masked_argmax(key, mask[:, None, :],
                                              (A, H, 5))          # [A, H, 5]
    P5 = X[samp]                                                  # [A,H,5,3]
    mu = P5.mean(dim=2)
    d = P5 - mu[:, :, None]
    nrm_h = torch.linalg.eigh(d.transpose(-1, -2) @ d).eigenvectors[..., 0]
    xn = cam_mod.pixels_to_normalized(cam, quads)                 # [A, 4, 2]
    d_w = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1) @ Rwc.T
    denom = torch.einsum("aci,ahi->ahc", d_w, nrm_h)
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    lam_h = (torch.sum((mu - twc) * nrm_h, dim=-1)[..., None]
             / denom)                                             # [A, H, 4]
    corners_h = twc + lam_h[..., None] * d_w[:, None]             # [A,H,4,3]
    sides_h = torch.linalg.norm(corners_h - torch.roll(corners_h, -1, dims=2),
                                dim=-1)
    mean_h = sides_h.mean(dim=-1)
    maxdiff_h = torch.abs(sides_h - mean_h[..., None]).max(dim=-1).values
    cheir_h = (lam_h > 0.05).all(dim=-1) & torch.isfinite(mean_h)
    maxdiff_h = torch.where(cheir_h, maxdiff_h, float("inf"))
    best = torch.argmin(maxdiff_h, dim=1)                         # [A]
    take = lambda a: torch.gather(a, 1, best.reshape(  # noqa: E731
        (A, 1) + (1,) * (a.dim() - 2)).expand((A, 1) + a.shape[2:]))[:, 0]
    nrm, mean_len = take(nrm_h), take(mean_h)
    maxdiff, lam = take(maxdiff_h), take(lam_h)
    len_ok = (enough & mk_obs_ok & (lam > 0.05).all(dim=1)
              & torch.isfinite(mean_len)
              & (maxdiff < cfg.aruco.scale_corr_max_len_diff))
    slots_safe = torch.clamp(mk_slots, 0, M - 1)
    tgtm = torch.where(len_ok, slots_safe, M)

    def add(arr, vals):
        return torch.cat([arr, arr.new_zeros((1,))]).index_add_(
            0, tgtm, vals.to(arr.dtype))[:M]

    mk_mean_len = add(state.mk_mean_len, mean_len)
    mk_len_cnt = add(state.mk_len_cnt, torch.ones_like(mean_len))
    z_w = state.mk_Rwm[slots_safe][:, :, 2]                       # [A, 3]
    cosang = torch.abs(torch.sum(z_w * nrm, dim=1)) / torch.clamp(
        torch.linalg.norm(nrm, dim=1), min=1e-9)
    ang = torch.rad2deg(torch.arccos(torch.clamp(cosang, 0.0, 1.0)))
    not_old = ~state.kf_mk_old[kf]
    well = len_ok & not_old & (ang < cfg.aruco.plane_angle_good_deg)
    bad = len_ok & not_old & (ang > cfg.aruco.plane_angle_bad_lo_deg)
    mk_well = state.mk_well | mark(M, slots_safe, well)
    mk_nbad = torch.cat([state.mk_nbad, state.mk_nbad.new_zeros((1,))]
                        ).index_add_(0, torch.where(bad, slots_safe, M),
                                     torch.ones_like(slots_safe))[:M]
    strike_out = (mk_nbad >= cfg.aruco.max_bad_computed) & ~mk_well
    mk_valid = state.mk_valid & ~strike_out

    # one-shot scale correction (keypoint-initialized maps only)
    have = mk_valid & (mk_len_cnt > 0)
    est_len = mk_mean_len / torch.clamp(mk_len_cnt, min=1.0)
    lmin = torch.where(have, est_len, float("inf")).min()
    lmax = torch.where(have, est_len, float("-inf")).max()
    n_have = have.sum()
    consistent = (~state.scale_done
                  & (n_have >= cfg.aruco.scale_corr_min_markers)
                  & ((lmax - lmin) < cfg.aruco.scale_corr_max_len_diff))
    mean_all = (torch.where(have, est_len, 0.0).sum()
                / torch.clamp(n_have, min=1))
    s = torch.where(consistent, cfg.aruco.marker_size
                    / torch.clamp(mean_all, min=1e-6),
                    torch.ones((), dtype=torch.float32, device=dev))
    state = state._replace(
        pt_xyz=state.pt_xyz * s, kf_tcw=state.kf_tcw * s,
        mk_twm=state.mk_twm * s, pt_min_dist=state.pt_min_dist * s,
        pt_max_dist=state.pt_max_dist * s,
        mk_mean_len=mk_mean_len * torch.where(consistent, s, 1.0),
        mk_len_cnt=mk_len_cnt, mk_well=mk_well, mk_nbad=mk_nbad,
        mk_valid=mk_valid, scale_done=state.scale_done | consistent)
    return state, s


# ---------------------------------------------------------------------------
# duplicate map-point fusion
# ---------------------------------------------------------------------------


def fuse_duplicates(state: MapState, kf: int, cam: Camera, cfg: SlamConfig,
                    restrict_covisible: bool = True,
                    radius_scale: float = 0.05):
    """Merge duplicated map points (SearchInNeighbors / Fuse,
    LocalMapping.cc:822-902): a point of keyframe `kf` within the
    scale-appropriate radius of an older point of its covisible
    neighbourhood with a matching descriptor merges into that point.
    Returns (state, n_fused [] tensor, merged_to [L])."""
    L = state.L
    dev = state.pt_xyz.device
    obs = state.kf_obs_point[kf]
    my_slot = torch.clamp(obs, 0, L - 1)
    my_ok = (obs >= 0) & state.pt_valid[my_slot] & state.kf_kp_valid[kf]
    inc = state.pt_obs_kf & state.kf_valid[None, :]
    mine = mark(L, my_slot, my_ok)
    share = mine.to(torch.float32) @ inc.to(torch.float32)
    covis_kf = (share >= 1) & state.kf_valid
    tgt_mask = (inc & covis_kf[None, :]).any(dim=1)
    if not restrict_covisible:
        tgt_mask = torch.ones_like(tgt_mask)
    Xm, Xa = state.pt_xyz[my_slot], state.pt_xyz
    d2 = ((Xm[:, None, 0] - Xa[None, :, 0]) ** 2
          + (Xm[:, None, 1] - Xa[None, :, 1]) ** 2
          + (Xm[:, None, 2] - Xa[None, :, 2]) ** 2)
    sim = unpack_pm1(state.pt_desc[my_slot]) @ unpack_pm1(state.pt_desc).T
    hamm = (256.0 - sim) * 0.5
    radius = radius_scale * torch.clamp(state.pt_max_dist[my_slot][:, None],
                                        min=0.2)
    first_mine = state.pt_first_kf[my_slot]
    lidx = torch.arange(L, device=dev)
    older = ((state.pt_first_kf[None, :] < first_mine[:, None])
             | ((state.pt_first_kf[None, :] == first_mine[:, None])
                & (lidx[None, :] < my_slot[:, None])))
    cand = (my_ok[:, None] & state.pt_valid[None, :] & tgt_mask[None, :]
            & (d2 < radius * radius) & (hamm < cfg.matcher.th_low) & older)
    row_has = cand.any(dim=1)
    row_tgt = torch.argmax(cand.to(torch.int32), dim=1)
    has_tgt = torch.zeros((L,), dtype=torch.int32, device=dev).scatter_reduce(
        0, my_slot, row_has.to(torch.int32), "amax") > 0
    tgt_l = torch.full((L,), L, dtype=torch.int64, device=dev).scatter_reduce(
        0, my_slot, torch.where(row_has, row_tgt, L), "amin")
    tgt = torch.where(has_tgt, torch.clamp(tgt_l, 0, L - 1), lidx)
    obs_all = state.kf_obs_point
    remapped = torch.where(obs_all >= 0, tgt[torch.clamp(obs_all, 0, L - 1)],
                           obs_all)
    add_found = torch.zeros((L,), device=dev).index_add_(
        0, tgt, torch.where(has_tgt, state.pt_found, 0.0))
    add_vis = torch.zeros((L,), device=dev).index_add_(
        0, tgt, torch.where(has_tgt, state.pt_visible, 0.0))
    # the merge target inherits the source's observing keyframes (a fixed
    # budget of fused pairs per call)
    _, src_idx = stable_topk(has_tgt, min(FUSE_BUDGET, L))
    src_ok = has_tgt[src_idx]
    dst_idx = torch.where(src_ok, tgt[src_idx], L)
    pt_obs_kf = _scatter_reduce_rows(
        state.pt_obs_kf.to(torch.int32), dst_idx,
        state.pt_obs_kf[src_idx].to(torch.int32), "amax") > 0
    state = state._replace(
        pt_valid=state.pt_valid & ~has_tgt, kf_obs_point=remapped,
        pt_found=state.pt_found + add_found,
        pt_visible=state.pt_visible + add_vis, pt_obs_kf=pt_obs_kf)
    return state, has_tgt.sum(), tgt


# ---------------------------------------------------------------------------
# point statistics maintenance
# ---------------------------------------------------------------------------


def _popcount32(x):
    """Set bits of each int32 word (its uint32 pattern), as int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def distinctive_descriptors(state: MapState, cfg: SlamConfig, kf=None):
    """Per-point representative descriptor: the observed descriptor with the
    least median Hamming distance to the point's other observations, over
    its first MAX_DESC_OBS observing keyframe slots
    (MapPoint::ComputeDistinctiveDescriptors, MapPoint.cc:271). With `kf`
    only the points keyframe `kf` observes are recomputed."""
    K, N = state.kf_obs_point.shape
    L, O = state.L, MAX_DESC_OBS
    dev = state.pt_xyz.device
    obs_all = torch.where(state.kf_kp_valid & state.kf_valid[:, None],
                          state.kf_obs_point, -1)                 # [K, N]
    # inverse map per keyframe: the first feature observing each point
    feat = torch.arange(N, device=dev).expand(K, N)
    inv = torch.full((K, L), N, dtype=torch.int64, device=dev).scatter_reduce(
        1, torch.clamp(obs_all, 0, L - 1), torch.where(obs_all >= 0, feat, N),
        "amin")
    if kf is None:
        rows = torch.arange(L, device=dev)
        row_valid = state.pt_valid
    else:
        pts = torch.where(state.kf_kp_valid[kf], state.kf_obs_point[kf], -1)
        rows = torch.clamp(pts, 0, L - 1)
        row_valid = (pts >= 0) & state.pt_valid[rows]
    invT = inv[:, rows].T                                         # [R, K]
    vals, kf_sel = stable_topk(invT < N, O)
    jv_sel = vals > 0
    cnt = jv_sel.sum(dim=-1)
    f = torch.gather(invT, 1, kf_sel)
    table = torch.where(jv_sel[..., None],
                        state.kf_desc[kf_sel, torch.clamp(f, 0, N - 1)], 0)
    dist = _popcount32(table[:, :, None, :] ^ table[:, None, :, :]).sum(-1)
    jv = torch.arange(O, device=dev)[None, :] < cnt[:, None]
    dist = torch.where(jv[:, None, :], dist, 512)
    srt = torch.sort(dist, dim=-1).values
    med_idx = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"),
                          0, O - 1)
    med = torch.gather(srt, 2, med_idx[:, None, None].expand(-1, O, 1))[..., 0]
    med = torch.where(jv, med, 10**9)
    best = torch.argmin(med, dim=-1)
    best_desc = torch.gather(table, 1, best[:, None, None].expand(-1, 1, 8)
                             )[:, 0]
    use = (cnt > 0) & row_valid
    return state._replace(pt_desc=_set_rows(
        state.pt_desc, torch.where(use, rows, L), best_desc))


def update_point_stats(state: MapState, cfg: SlamConfig):
    """Refresh each point's viewing normal, the mean unit direction from its
    observing keyframes' centers (MapPoint::UpdateNormalAndDepth,
    MapPoint.cc:359)."""
    m = (state.pt_obs_kf & state.kf_valid[None, :]).to(torch.float32)
    centers = _centers(state.kf_Rcw, state.kf_tcw)                # [K, 3]
    d = state.pt_xyz[:, None, :] - centers[None, :, :]            # [L, K, 3]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    sum_d = torch.einsum("lkj,lk->lj", d, m)
    normal = sum_d / torch.clamp(torch.linalg.norm(sum_d, dim=-1,
                                                   keepdim=True), min=1e-9)
    has = m.sum(dim=1) > 0
    return state._replace(pt_normal=torch.where(
        (has & state.pt_valid)[:, None], normal, state.pt_normal))
