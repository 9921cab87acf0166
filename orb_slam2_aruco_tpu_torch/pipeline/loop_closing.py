"""Loop closing: loop detection, the loop Sim3, loop correction.

Port of orb_slam2_aruco_tpu/pipeline/loop_closing.py (LoopClosing,
reference src/LoopClosing.cc):

  * DetectLoopByAruco (:116-189)  -> detect_loop_by_marker: a marker
    observed by an old keyframe that is not covisible with the current one
    signals a loop;
  * DetectLoop (:191-360)         -> detect_loop_by_bow (retrieval scores
    outside the covisible neighbourhood) and ConsistencyTracker (three
    consistent detections in a row);
  * ComputeSim3ByAruco (:362-483) -> compute_sim3: the Sim3 seeded from the
    shared marker (s = 1), refined on point matches (optim.sim3_opt),
    verified by projection;
  * ComputeSim3 (:485-654)        -> compute_sim3_classic: Horn on RANSAC
    triples of 3D-3D matches, refined;
  * CorrectLoopByAruco (:656-887) -> correct_loop: Sim3 propagation over
    the current covisible group, point correction, the essential graph
    (optim.pose_graph) with persistent loop edges, marker re-anchoring.

Keyframe and marker slots are host ints (the system reads the detection
on the host, as the JAX facade does); every function runs on the state's
device with fixed shapes and reads nothing back. The JAX package's
SLAM_DEBUG_LOOP prints are not ported (ROADMAP.md C2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_aruco_tpu_torch.config import SlamConfig
from orb_slam2_aruco_tpu_torch.geometry import camera as cam_mod
from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.horn import horn_sim3
from orb_slam2_aruco_tpu_torch.geometry.ippe import ippe_square
from orb_slam2_aruco_tpu_torch.geometry.lie import (
    se3_apply,
    se3_compose,
    se3_inverse,
    sim3_apply,
    sim3_compose,
    sim3_inverse,
)
from orb_slam2_aruco_tpu_torch.ops import matching
from orb_slam2_aruco_tpu_torch.optim import pose_graph, sim3_opt
from orb_slam2_aruco_tpu_torch.pipeline.frontend import scale_sigma2
from orb_slam2_aruco_tpu_torch.pipeline.tracking import (
    _matched,
    host_read,
    row,
)
from orb_slam2_aruco_tpu_torch.utils import threefry
from orb_slam2_aruco_tpu_torch.worldmap import retrieval
from orb_slam2_aruco_tpu_torch.worldmap.covisibility import (
    covisibility_matrix,
    spanning_parent,
)
from orb_slam2_aruco_tpu_torch.worldmap.state import MapState


class LoopDetection(NamedTuple):
    found: torch.Tensor        # bool
    kf_loop: torch.Tensor      # loop keyframe slot, -1 if none
    marker_slot: torch.Tensor  # shared marker slot, -1 for a BoW loop


class Sim3Candidate(NamedTuple):
    ok: torch.Tensor
    s: torch.Tensor            # Sim3 cur <- loop (camera frames)
    R: torch.Tensor
    t: torch.Tensor
    n_inliers: torch.Tensor


def _insertion_rank(state: MapState):
    """[K] number of valid keyframes inserted before each one."""
    fid = state.kf_frame_id
    return ((fid[:, None] > fid[None, :]) & state.kf_valid[None, :]).sum(1)


def detect_loop_by_marker(state: MapState, kf_cur: int, min_gap: int = 10,
                          W=None) -> LoopDetection:
    """A marker flagged old in the current keyframe (mvbOldAruco) and
    observed by a valid, earlier, non-covisible keyframe at least
    `min_gap` insertions older signals a loop; among such observers the
    one with the most surviving map points wins."""
    A = state.kf_mk_slot.shape[1]
    W = covisibility_matrix(state) if W is None else W
    cur_slots = state.kf_mk_slot[kf_cur]                         # [A]
    cur_valid = (state.kf_mk_valid[kf_cur] & (cur_slots >= 0)
                 & state.kf_mk_old[kf_cur])
    obs = ((state.kf_mk_slot[:, :, None] == cur_slots[None, None, :])
           & state.kf_mk_valid[:, :, None]).any(dim=1)           # [K, A]
    # (masks against an arange, not element writes: writing a Python
    # number into a device tensor synchronizes)
    not_cur = torch.arange(state.K, device=W.device) != kf_cur
    old = (state.kf_valid & (state.kf_frame_id < state.kf_frame_id[kf_cur])
           & (W[kf_cur] < 15) & not_cur)
    rank = _insertion_rank(state)
    cand = (obs & old[:, None] & cur_valid[None, :]
            & ((rank[kf_cur] - rank[:, None]) >= min_gap))
    any_c = cand.any()
    obs_pt = state.kf_obs_point
    pts_of_kf = ((obs_pt >= 0)
                 & state.pt_valid[torch.clamp(obs_pt, min=0)]).sum(1)
    flat = torch.argmax(torch.where(cand, pts_of_kf[:, None], -1).reshape(-1))
    return LoopDetection(
        found=any_c,
        kf_loop=torch.where(any_c, flat // A, -1),
        marker_slot=torch.where(any_c, row(cur_slots, flat % A), -1))


def _marker_cam_pose(state: MapState, kf: int, marker_slot: int,
                     cam: Camera):
    """T_cam_marker by IPPE (best solution) from the stored corners of
    `marker_slot` in keyframe `kf`, and whether kf observes it."""
    hit = (state.kf_mk_slot[kf] == marker_slot) & state.kf_mk_valid[kf]
    uv = row(state.kf_mk_uv[kf], torch.argmax(hit.to(torch.int32)))
    # the unit square: t scales with the side (the side is a device value)
    res = ippe_square(1.0, cam_mod.pixels_to_normalized(cam, uv)[None])
    return res.R[0, 0], res.t[0, 0] * state.mk_side[marker_slot], hit.any()


def _pick(use_b, a, b):
    """Sim3Result b where use_b, else a."""
    return sim3_opt.Sim3Result(*(torch.where(use_b, y, x)
                                 for x, y in zip(a, b)))


def _point_matches(state: MapState, kf_cur: int, kf_loop: int,
                   cfg: SlamConfig):
    """Mutual descriptor matches between the two keyframes' map-point
    features and the Sim3 inputs they give."""
    cur_obs = state.kf_obs_point[kf_cur]
    loop_obs = state.kf_obs_point[kf_loop]
    mask_cur = state.kf_kp_valid[kf_cur] & (cur_obs >= 0)
    mask_loop = state.kf_kp_valid[kf_loop] & (loop_obs >= 0)
    d = matching.distance_matrix(state.kf_desc[kf_cur], state.kf_desc[kf_loop],
                                 mask_cur, mask_loop)
    m = matching.nn_match(d, max_dist=float(cfg.matcher.th_low),
                          nn_ratio=0.9, mutual=True)
    # p1: cur's own map points in cur's camera frame; p2: the matched loop
    # features' points in loop's (OptimizeSim3's vertex setup)
    cur_safe = torch.clamp(cur_obs, min=0)
    p1 = se3_apply(state.kf_Rcw[kf_cur][None], state.kf_tcw[kf_cur][None],
                   state.pt_xyz[cur_safe])
    j = torch.clamp(m.idx, min=0)
    loop_safe = torch.clamp(loop_obs[j], min=0)
    p2 = se3_apply(state.kf_Rcw[kf_loop][None], state.kf_tcw[kf_loop][None],
                   state.pt_xyz[loop_safe])
    valid = (m.valid & mask_cur & state.pt_valid[cur_safe]
             & state.pt_valid[loop_safe])
    return dict(m=m, j=j, p1=p1, p2=p2, valid=valid, cur_obs=cur_obs,
                loop_obs=loop_obs, mask_cur=mask_cur, mask_loop=mask_loop)


def compute_sim3(state: MapState, kf_cur: int, kf_loop: int,
                 marker_slot: int, cam: Camera,
                 cfg: SlamConfig) -> Sim3Candidate:
    """The Sim3 cur <- loop (camera frames) seeded by the shared marker,
    refined on point matches, grown by projection (SearchBySim3), and
    verified by projecting the loop keyframe's covisible group into the
    current image (ComputeSim3ByAruco)."""
    dev = state.pt_xyz.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    # marker seed: T_cur_loop = T_cur_m inv(T_loop_m), s = 1
    Rc_m, tc_m, ok1 = _marker_cam_pose(state, kf_cur, marker_slot, cam)
    Rl_m, tl_m, ok2 = _marker_cam_pose(state, kf_loop, marker_slot, cam)
    R0, t0 = se3_compose(Rc_m, tc_m, *se3_inverse(Rl_m, tl_m))
    s0 = one
    pm = _point_matches(state, kf_cur, kf_loop, cfg)
    m, j, p1, p2, valid = pm["m"], pm["j"], pm["p1"], pm["p2"], pm["valid"]
    cur_obs, loop_obs = pm["cur_obs"], pm["loop_obs"]
    uv1 = state.kf_kp_uv[kf_cur]
    sig2 = scale_sigma2(cfg.orb.num_levels, cfg.orb.scale_factor, dev)
    inv1 = sig2[state.kf_kp_octave[kf_cur]]
    opt = dict(cam=cam, fix_scale=cfg.loop.fix_scale,
               iters_first=cfg.optim.sim3_iters,
               iters_second=2 * cfg.optim.sim3_iters)
    # dual seed: the marker pose may be the flipped IPPE solution on a
    # near-frontal view; the map's relative pose carries the drift
    R0b, t0b = se3_compose(state.kf_Rcw[kf_cur], state.kf_tcw[kf_cur],
                           *se3_inverse(state.kf_Rcw[kf_loop],
                                        state.kf_tcw[kf_loop]))
    uv2 = state.kf_kp_uv[kf_loop][j]
    inv2 = sig2[state.kf_kp_octave[kf_loop][j]]
    res_a = sim3_opt.optimize_sim3(s0, R0, t0, p1, p2, uv1, uv2, valid, inv1,
                                   inv2, **opt)
    res_b = sim3_opt.optimize_sim3(s0, R0b, t0b, p1, p2, uv1, uv2, valid,
                                   inv1, inv2, **opt)
    res = _pick(res_b.n_inliers > res_a.n_inliers, res_a, res_b)._replace(
        n_inliers=torch.maximum(res_a.n_inliers, res_b.n_inliers))

    # SearchBySim3 (ORBmatcher.cc:1106): every loop map point through the
    # solved Sim3 into the current image, window-matched
    loop_safe = torch.clamp(loop_obs, min=0)
    p2_all = se3_apply(state.kf_Rcw[kf_loop][None],
                       state.kf_tcw[kf_loop][None], state.pt_xyz[loop_safe])
    q = sim3_apply(res.s[None], res.R, res.t, p2_all)
    loop_ok = pm["mask_loop"] & state.pt_valid[loop_safe] & (q[:, 2] > 0.02)
    m2 = matching.match_in_window(
        state.kf_desc[kf_loop], state.kf_desc[kf_cur], cam_mod.project(cam, q),
        uv1, radius=7.5, mask_a=loop_ok, mask_b=pm["mask_cur"],
        max_dist=float(cfg.matcher.th_high), nn_ratio=1.0)
    # per current feature, the first round's match wins
    Ncur = cur_obs.shape[0]
    ar = torch.arange(loop_obs.shape[0], device=dev)
    j2_of_cur = _matched(Ncur, m2, ar)
    j_merged = torch.where(m.valid, m.idx, j2_of_cur)
    jm = torch.clamp(j_merged, min=0)
    loop_jm = torch.clamp(loop_obs[jm], min=0)
    p2b = se3_apply(state.kf_Rcw[kf_loop][None], state.kf_tcw[kf_loop][None],
                    state.pt_xyz[loop_jm])
    valid2 = ((j_merged >= 0) & pm["mask_cur"]
              & state.pt_valid[torch.clamp(cur_obs, min=0)]
              & state.pt_valid[loop_jm])
    res2 = sim3_opt.optimize_sim3(
        res.s, res.R, res.t, p1, p2b, uv1, state.kf_kp_uv[kf_loop][jm],
        valid2, inv1, sig2[state.kf_kp_octave[kf_loop][jm]], **opt)
    fin = _pick(res2.n_inliers >= res.n_inliers, res, res2)
    n_f = torch.maximum(res2.n_inliers, res.n_inliers)

    # 2D-3D verification (LoopClosing.cc:440-476): the loop keyframe's
    # covisible group's points through S_cur_w into the current image; the
    # marker seed is itself a valid answer when point consensus is short
    W = covisibility_matrix(state)
    group = (((W[kf_loop] >= 15)
              | (torch.arange(state.K, device=dev) == kf_loop))
             & state.kf_valid)
    pt_group = (state.pt_obs_kf & group[None, :]).any(dim=1) & state.pt_valid

    def proj_count(s_c, R_c, t_c):
        sw, Rw, tw = sim3_compose(s_c, R_c, t_c, one, state.kf_Rcw[kf_loop],
                                  state.kf_tcw[kf_loop])
        qq = sim3_apply(sw[None], Rw, tw, state.pt_xyz)
        mm = matching.match_in_window(
            state.pt_desc, state.kf_desc[kf_cur], cam_mod.project(cam, qq),
            uv1, radius=10.0, mask_a=pt_group & (qq[:, 2] > 0.02),
            mask_b=state.kf_kp_valid[kf_cur],
            max_dist=float(cfg.matcher.th_low), nn_ratio=1.0)
        return mm.valid.sum()

    n_proj_seed = proj_count(s0, R0, t0)
    n_proj_ref = proj_count(fin.s, fin.R, fin.t)
    use_seed = (n_f < cfg.loop.sim3_min_inliers) & (n_proj_seed >= n_proj_ref)
    n_proj = torch.maximum(n_proj_seed, n_proj_ref)
    ok = ok1 & ok2 & ((n_f >= cfg.loop.sim3_min_inliers)
                      | (n_proj >= cfg.loop.proj_min_matches))
    return Sim3Candidate(
        ok=ok, s=torch.where(use_seed, s0, fin.s),
        R=torch.where(use_seed, R0, fin.R),
        t=torch.where(use_seed, t0, fin.t),
        n_inliers=torch.maximum(n_f, n_proj))


def covis_edge_set(W, kf_valid, chain_j, loop_i, loop_j, loop_valid,
                   min_covis: int):
    """Every covisibility pair of weight >= min_covis (Optimizer.cc:
    1416-1440, no top-N cut) over the upper K x K triangle, minus the
    spanning-tree and stored loop pairs: (cov_i, cov_j, cov_mask) flat
    over the K*K grid. Loop entries must be valid slots where valid."""
    K = kf_valid.shape[0]
    iu = torch.arange(K, device=W.device)
    cov_i = iu.repeat_interleave(K)
    cov_j = iu.repeat(K)
    is_span = (chain_j[cov_i] == cov_j) | (chain_j[cov_j] == cov_i)
    li = torch.clamp(loop_i, 0, K - 1)
    lj = torch.clamp(loop_j, 0, K - 1)
    lv = loop_valid.to(torch.int32)
    LP = torch.zeros(K * K, dtype=torch.int32, device=W.device)
    LP.index_add_(0, li * K + lj, lv).index_add_(0, lj * K + li, lv)
    cov_mask = ((cov_i < cov_j) & (W.reshape(-1) >= min_covis)
                & kf_valid[cov_i] & kf_valid[cov_j] & ~is_span & (LP == 0))
    return cov_i, cov_j, cov_mask


def correct_loop(state: MapState, kf_cur: int, kf_loop: int, s_rel, R_rel,
                 t_rel, cam: Camera, cfg: SlamConfig):
    """Propagate the loop correction and optimize the essential graph:
    (new state, the graph's final chi2)."""
    K, M = state.K, state.M
    dev = state.kf_Rcw.device
    f32 = torch.float32
    W = covisibility_matrix(state)
    one = torch.ones((), dtype=f32, device=dev)
    R_all, t_all = state.kf_Rcw, state.kf_tcw
    R_loop, t_loop = R_all[kf_loop], t_all[kf_loop]
    # corrected current keyframe: S_cur = S_rel S_loop_w
    s_cur_c, R_cur_c, t_cur_c = sim3_compose(s_rel, R_rel, t_rel, one,
                                             R_loop, t_loop)

    # the current covisible group moves with it: S_k = (T_k_w T_cur_w^-1)
    # S_cur; the loop keyframe is the graph's fixed anchor and stays
    ar = torch.arange(K, device=dev)
    covis_cur = (((W[kf_cur] >= 15) & state.kf_valid) | (ar == kf_cur)) \
        & (ar != kf_loop)
    R_k_cur, t_k_cur = se3_compose(R_all, t_all,
                                   *se3_inverse(R_all[kf_cur], t_all[kf_cur]))
    ones_k = torch.ones((K,), dtype=f32, device=dev)
    s_k_c, R_k_c, t_k_c = sim3_compose(ones_k, R_k_cur, t_k_cur,
                                       s_cur_c.expand(K),
                                       R_cur_c.expand(K, 3, 3),
                                       t_cur_c.expand(K, 3))
    s_init = torch.where(covis_cur, s_k_c, ones_k)
    R_init = torch.where(covis_cur[:, None, None], R_k_c, R_all)
    t_init = torch.where(covis_cur[:, None], t_k_c, t_all)

    # points of the group, through their reference keyframe
    ref = torch.clamp(state.pt_ref_kf, 0, K - 1)
    in_group = covis_cur[ref] & (state.pt_ref_kf >= 0) & state.pt_valid
    Xc = se3_apply(R_all[ref], t_all[ref], state.pt_xyz)
    X_new = sim3_apply(*sim3_inverse(s_init[ref], R_init[ref], t_init[ref]),
                       Xc)
    pt_xyz = torch.where(in_group[:, None], X_new, state.pt_xyz)

    # essential graph: (a) the covisibility spanning tree (a keyframe with
    # no earlier covisible falls back to its predecessor in insertion order)
    order_key = torch.where(state.kf_valid, state.kf_seq, 2**30)
    parent = spanning_parent(W, state.kf_valid, order_key)
    pred_key = torch.where((order_key[None, :] < order_key[:, None])
                           & state.kf_valid[None, :], order_key[None, :], -1)
    best_pred, pred = torch.max(pred_key, dim=1)
    chain_j = torch.where(parent >= 0, parent, pred)
    chain_mask = state.kf_valid & ((parent >= 0) | (best_pred >= 0))
    # the persistent loop-edge table (KeyFrame::AddLoopEdge,
    # KeyFrame.cc:515-525) with the current pair stored in its first free
    # row unless it is already there
    lt_i, lt_j, lt_v = state.loop_i, state.loop_j, state.loop_valid
    already = (lt_v & (((lt_i == kf_cur) & (lt_j == kf_loop))
                       | ((lt_i == kf_loop) & (lt_j == kf_cur)))).any()
    e_free = torch.argmin(lt_v.to(torch.int32)).reshape(1)
    do_add = ~already & ~lt_v.index_select(0, e_free)
    loop_i_t = lt_i.index_copy(0, e_free, torch.where(
        do_add, kf_cur, lt_i.index_select(0, e_free)))
    loop_j_t = lt_j.index_copy(0, e_free, torch.where(
        do_add, kf_loop, lt_j.index_select(0, e_free)))
    loop_valid_t = lt_v.index_copy(0, e_free, do_add
                                   | lt_v.index_select(0, e_free))
    li = torch.clamp(loop_i_t, 0, K - 1)
    lj = torch.clamp(loop_j_t, 0, K - 1)
    # (b) every strong covisibility pair
    cov_i, cov_j, cov_mask = covis_edge_set(
        W, state.kf_valid, chain_j, li, lj, loop_valid_t,
        cfg.optim.essential_graph_min_covis)
    # (c) the stored loops, and the current one as its own row (its table
    # row, if any, is masked so it enters once, and still enters when the
    # table is full)
    cur_row = loop_valid_t & (((loop_i_t == kf_cur) & (loop_j_t == kf_loop))
                              | ((loop_i_t == kf_loop)
                                 & (loop_j_t == kf_cur)))
    e_i = torch.cat([ar, cov_i, li,
                     torch.full((1,), kf_cur, dtype=li.dtype, device=dev)])
    e_j = torch.cat([chain_j, cov_j, lj,
                     torch.full((1,), kf_loop, dtype=lj.dtype, device=dev)])
    loop_edge_mask = (loop_valid_t & ~cur_row & state.kf_valid[li]
                      & state.kf_valid[lj])
    e_mask = torch.cat([chain_mask, cov_mask, loop_edge_mask,
                        torch.ones((1,), dtype=torch.bool, device=dev)]
                       ).to(f32)
    # measurements S_m = S_jw S_wi: the pre-correction relative poses for
    # the tree, covisibility and past loop edges; the solved Sim3 for the
    # current loop
    Ra, ta = se3_inverse(R_all[e_i[:-1]], t_all[e_i[:-1]])
    Rm_c, tm_c = se3_compose(R_all[e_j[:-1]], t_all[e_j[:-1]], Ra, ta)
    sl, Rl, tl = sim3_compose(one, R_loop, t_loop,
                              *sim3_inverse(s_cur_c, R_cur_c, t_cur_c))
    sm = torch.cat([torch.ones(Rm_c.shape[0], dtype=f32, device=dev),
                    sl[None]])
    Rm = torch.cat([Rm_c, Rl[None]])
    tm = torch.cat([tm_c, tl[None]])
    free = torch.where(ar == kf_loop, 0.0, state.kf_valid.to(f32))
    out = pose_graph.optimize_pose_graph(
        s_init, R_init, t_init, e_i, e_j, sm, Rm, tm, e_mask, free,
        iters=cfg.optim.essential_graph_iters,
        lam=cfg.optim.lm_lambda_essential, fix_scale=cfg.loop.fix_scale)

    # back to SE3 (t / s); points through their reference keyframe's
    # pre-graph and optimized Sim3
    kv = state.kf_valid
    s_new = torch.where(kv, out.s, 1.0)
    R_new = torch.where(kv[:, None, None], out.R, R_all)
    t_new = torch.where(kv[:, None],
                        out.t / torch.clamp(s_new, min=1e-9)[:, None], t_all)
    Xc2 = sim3_apply(s_init[ref], R_init[ref], t_init[ref], pt_xyz)
    X2 = sim3_apply(*sim3_inverse(out.s[ref], out.R[ref], out.t[ref]), Xc2)
    move = state.pt_valid & (state.pt_ref_kf >= 0)
    pt_xyz = torch.where(move[:, None], X2, pt_xyz)

    # markers: Twm = T_w_k(corrected) T_k_m(stored observation), from the
    # observation of the corrected group with the sharpest IPPE, the
    # solution chosen by consistency with the marker's prior pose
    A = state.kf_mk_slot.shape[1]
    obs_mask = (state.kf_mk_valid & (state.kf_mk_slot >= 0)
                & kv[:, None])
    xn_all = cam_mod.pixels_to_normalized(cam, state.kf_mk_uv.reshape(K * A,
                                                                      4, 2))
    ippe_all = ippe_square(1.0, xn_all)            # unit side: t scales
    ratio_all = ippe_all.ratio
    score = covis_cur[:, None].to(f32) * 10.0 - ratio_all.reshape(K, A)
    flat_slot = torch.where(obs_mask, state.kf_mk_slot, M).reshape(-1)
    slots_eq = flat_slot[:, None] == torch.arange(M, device=dev)[None, :]
    sc = torch.where(slots_eq, score.reshape(-1)[:, None], -float("inf"))
    best_idx = torch.argmax(sc, dim=0)                             # [M]
    has_obs = slots_eq.any(dim=0)
    kf_of = torch.clamp(best_idx // A, 0, K - 1)
    R2 = ippe_all.R[best_idx]                                      # [M,2,3,3]
    t2 = ippe_all.t[best_idx] * state.mk_side[:, None, None]
    R_exp, _ = se3_compose(R_all[kf_of], t_all[kf_of], state.mk_Rwm,
                           state.mk_twm)
    tr0 = torch.sum(R2[:, 0] * R_exp, dim=(-1, -2))
    tr1 = torch.sum(R2[:, 1] * R_exp, dim=(-1, -2))
    pick1 = ((ratio_all[best_idx] >= cfg.aruco.ippe_ambiguity_ratio)
             & (tr1 > tr0))
    Rk_m = torch.where(pick1[:, None, None], R2[:, 1], R2[:, 0])
    tk_m = torch.where(pick1[:, None], t2[:, 1], t2[:, 0])
    Rwm_new, twm_new = se3_compose(*se3_inverse(R_new[kf_of], t_new[kf_of]),
                                   Rk_m, tk_m)
    upd = state.mk_valid & has_obs
    state = state._replace(
        kf_Rcw=R_new, kf_tcw=t_new, pt_xyz=pt_xyz,
        mk_Rwm=torch.where(upd[:, None, None], Rwm_new, state.mk_Rwm),
        mk_twm=torch.where(upd[:, None], twm_new, state.mk_twm),
        kf_mk_old=torch.zeros_like(state.kf_mk_old),
        loop_i=loop_i_t, loop_j=loop_j_t, loop_valid=loop_valid_t,
        big_change_idx=state.big_change_idx + 1)
    return state, out.chi2


def covis_weight(state: MapState, kf_a: int, kf_b: int):
    """Shared-point count of two keyframes."""
    return covisibility_matrix(state)[kf_a, kf_b]


def covis_row(state: MapState, kf: int):
    """[K] shared valid-point counts of one keyframe with every keyframe,
    from the [L, K] incidence without the K x K product."""
    r = (state.pt_obs_kf[:, kf] & state.pt_valid).to(torch.float32)
    inc = (state.pt_obs_kf & state.kf_valid[None, :]).to(torch.float32)
    return (r @ inc).to(torch.int64)


class ConsistencyTracker:
    """The 3-consecutive-consistency gate of BoW loop candidates (DetectLoop
    consistency groups, LoopClosing.cc:260-319): a candidate is accepted
    once candidates consistent with it (the same keyframe or covisible with
    it) appeared in `threshold` consecutive detections. Host-side; one
    covisibility row read per candidate."""

    def __init__(self, threshold: int = 3):
        self.threshold = threshold
        self.prev: list = []          # (kf slot, count)

    def update(self, state: MapState, cand_kf: int) -> bool:
        new_prev = []
        accepted = matched = False
        w = host_read(covis_row(state, cand_kf)) if self.prev else None
        for kf_old, count in self.prev:
            if kf_old == cand_kf or int(w[kf_old]) >= 15:
                matched = True
                new_prev.append((cand_kf, count + 1))
                accepted = accepted or count + 1 >= self.threshold
        if not matched:
            new_prev.append((cand_kf, 1))
            accepted = accepted or self.threshold <= 1
        self.prev = new_prev
        return accepted

    def reset(self):
        self.prev = []


def detect_loop_by_bow(state: MapState, kf_cur: int, min_gap: int = 10,
                       W=None) -> LoopDetection:
    """Appearance loop candidates (DetectLoop): the best old keyframe by
    the grouped retrieval score outside the covisible neighbourhood,
    scoring at least the lowest score of the current covisibles."""
    K = state.K
    dev = state.kf_bow.device
    W = covisibility_matrix(state) if W is None else W
    not_cur = torch.arange(K, device=dev) != kf_cur
    covis = ((W[kf_cur] >= 15) & state.kf_valid) | ~not_cur
    scores = state.kf_bow @ state.kf_bow[kf_cur]
    min_score = torch.where(covis & not_cur, scores, 1.0).min()
    rank = _insertion_rank(state)
    exclude = covis | ~state.kf_valid | ((rank[kf_cur] - rank) < min_gap)
    idx, _, keep = retrieval.detect_candidates_grouped(
        state.kf_bow[kf_cur], state.kf_bow, state.kf_valid,
        covis_w=W.to(torch.float32), exclude_mask=exclude,
        min_score=min_score, max_candidates=4)
    return LoopDetection(found=keep[0],
                         kf_loop=torch.where(keep[0], idx[0], -1),
                         marker_slot=torch.full((), -1, dtype=torch.int64,
                                                device=dev))


def detect_loops(state: MapState, kf_cur: int, min_gap: int = 10):
    """Marker and BoW loop detection over one covisibility matrix."""
    W = covisibility_matrix(state)
    return (detect_loop_by_marker(state, kf_cur, min_gap, W),
            detect_loop_by_bow(state, kf_cur, min_gap, W))


def compute_sim3_classic(state: MapState, kf_cur: int, kf_loop: int,
                         cam: Camera, cfg: SlamConfig,
                         num_hypotheses: int = 128) -> Sim3Candidate:
    """The classic Sim3 (ComputeSim3): Horn on RANSAC triples of the
    matched 3D-3D pairs, all hypotheses at once (the JAX package's
    `jax.random.choice(PRNGKey(1), ...)` draw, bit for bit), the best by
    image transfer into the current keyframe, then sim3_opt."""
    dev = state.pt_xyz.device
    pm = _point_matches(state, kf_cur, kf_loop, cfg)
    j, p1, p2, valid = pm["j"], pm["p1"], pm["p2"], pm["valid"]
    w = valid.to(torch.float32)
    sets = threefry.choice_p(threefry.PRNGKey(1), (num_hypotheses, 3),
                             w / torch.clamp(w.sum(), min=1.0))
    # maps loop-frame points into the current frame
    s_h, R_h, t_h = horn_sim3(p2[sets], p1[sets], fix_scale=cfg.loop.fix_scale)
    q1 = (s_h[:, None, None] * torch.einsum("hij,nj->hni", R_h, p2)
          + t_h[:, None])
    uv1 = state.kf_kp_uv[kf_cur]
    err = torch.sum((cam_mod.project(cam, q1) - uv1[None]) ** 2, dim=-1)
    ok_pt = (err < 9.21) & (q1[..., 2] > 0.02) & valid[None]
    scores = ok_pt.sum(dim=1)
    b = torch.argmax(scores)
    sig2 = scale_sigma2(cfg.orb.num_levels, cfg.orb.scale_factor, dev)
    res = sim3_opt.optimize_sim3(
        row(s_h, b), row(R_h, b), row(t_h, b), p1, p2, uv1,
        state.kf_kp_uv[kf_loop][j], valid, sig2[state.kf_kp_octave[kf_cur]],
        sig2[state.kf_kp_octave[kf_loop][j]], cam,
        fix_scale=cfg.loop.fix_scale, iters_first=cfg.optim.sim3_iters,
        iters_second=2 * cfg.optim.sim3_iters)
    n_min = cfg.loop.sim3_min_inliers_classic
    ok = (row(scores, b) >= n_min) & (res.n_inliers >= n_min)
    return Sim3Candidate(ok=ok, s=res.s, R=res.R, t=res.t,
                         n_inliers=res.n_inliers)
