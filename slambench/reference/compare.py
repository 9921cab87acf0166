"""The comparison that decides `correct`: the program's poses, map and
frontend output against the scene's own truth.

Plain NumPy in float64. It takes the true poses and the wall from the
generator, and the program's outputs as host arrays; it imports nothing of
the program. Units: cm, degrees, pixels.

The program's map lives in its own frame (the first keyframe's camera,
metric by the markers' stated size). One rigid transform (rotation and
translation, no scale: the marker size fixes the scale) is fitted from the
map to the world over the map's keyframe centres and marker centres, each
against its true position. Every pose, keyframe, marker and point is then
judged in the world frame. `compare` returns every number below; the
cell's limits file says which are held to a limit (the others are
reported beside them):

  pose_err_max_cm       the largest error of a returned pose: the farther
                        displaced of the camera centre and of the point
                        `ahead` metres in front of it (the wall's distance),
                        so that a turn counts as well as a shift (infinite
                        where no frame got a pose)
  pose_err_p90_cm       90th percentile of those errors
  pose_rot_max_deg      the largest rotation error of a returned pose
  lost_frames           frames handed after the first pose that got none
  lost_pct              those frames, in percent of the frames handed after
                        the first pose (100 where no frame got a pose)
  kf_err_max_cm         the largest error of the map's keyframes, and of
  kf_rot_max_deg        their rotations
  marker_pos_max_cm     the farthest map marker centre from its true place
  foreign_markers       map markers whose id the wall does not hold
  point_plane_p90_cm    90th percentile of the map points' distance from
                        the wall's plane (every textured point lies on it)
  detect_pos_p90_cm     90th percentile over the detected markers of every
  detect_pos_max_cm     frame that got a pose of the distance from the
                        marker's centre as the frontend places it in the
                        camera (IPPE on the refined corners) to the truth,
                        and the largest
  corner_max_px         the largest distance of a detected corner
                        (undistorted pixels) from the true corner's pinhole
                        projection
  wrong_ids             detections whose id is not on the wall or not in
                        view
  missed_markers        markers wholly in view (every corner 24 px inside
                        the frame, at least 40 px a side) left undetected
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from reference import scene as scn

VIEW_MARGIN_PX = 24.0
MIN_SIDE_PX = 40.0


def fit_rigid(src: np.ndarray, dst: np.ndarray):
    """(R, t) minimising sum |R src + t - dst|^2 (Horn / Umeyama without
    scale)."""
    ms, md = src.mean(0), dst.mean(0)
    H = (src - ms).T @ (dst - md)
    U, _, Vt = np.linalg.svd(H)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    return R, md - R @ ms


def rot_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def center(R, t) -> np.ndarray:
    return -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)


def pose_errors(Rmw, tmw, R_est, t_est, R_true, t_true, ahead=2.0):
    """(cm, degrees) between a pose in the map's frame and the true pose,
    with the map frame X_m = Rmw X_w + tmw: the farther displaced of the
    camera centre and of the point `ahead` metres before it, and the
    rotation error."""
    R_est = np.asarray(R_est, np.float64)
    R_true = np.asarray(R_true, np.float64)
    p = np.asarray([0.0, 0.0, ahead])
    # camera-frame points to the world: the estimate through the map frame
    est = [Rmw.T @ (R_est.T @ (q - np.asarray(t_est, np.float64)) - tmw)
           for q in (np.zeros(3), p)]
    true = [R_true.T @ (q - np.asarray(t_true, np.float64))
            for q in (np.zeros(3), p)]
    cm = 100.0 * max(float(np.linalg.norm(a - b)) for a, b in zip(est, true))
    return cm, rot_deg(R_est @ Rmw @ R_true.T)


def align(world: scn.World, truth: Dict[int, Tuple], mp: dict):
    """(Rmw, tmw) from the map's keyframe and marker centres."""
    src, dst = [], []
    for fid, R, t in zip(mp["kf_frame_id"], mp["kf_Rcw"], mp["kf_tcw"]):
        if int(fid) in truth:
            src.append(center(*truth[int(fid)]))
            dst.append(center(R, t))
    where = {mid: i for i, mid in enumerate(world.ids)}
    for mid, twm in zip(mp["mk_id"], mp["mk_twm"]):
        if int(mid) in where:
            src.append(np.r_[world.centers[where[int(mid)]], 0.0])
            dst.append(np.asarray(twm, np.float64))
    if len(src) < 3:
        return None
    return fit_rigid(np.asarray(src), np.asarray(dst))


def in_view(world: scn.World, cam: dict, R, t) -> Tuple[np.ndarray, ...]:
    """(undistorted pixel corners [n, 4, 2], wholly in view [n], partly in
    view [n]) of every marker from the true pose."""
    X = world.corners() @ np.asarray(R, np.float64).T + np.asarray(t)
    z = X[..., 2]
    xn = X[..., :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[..., None]
    f = np.asarray([cam["fx"], cam["fy"]])
    c = np.asarray([cam["cx"], cam["cy"]])
    uv = xn * f + c
    uv_d = scn.distort(cam, xn) * f + c
    W, H = cam["width"], cam["height"]
    front = (z > 0.05).all(-1)

    def inside(m):
        return ((uv_d[..., 0] >= m) & (uv_d[..., 0] < W - m)
                & (uv_d[..., 1] >= m) & (uv_d[..., 1] < H - m))

    side = np.linalg.norm(uv_d - np.roll(uv_d, 1, axis=1), axis=-1).min(-1)
    whole = front & inside(VIEW_MARGIN_PX).all(-1) & (side >= MIN_SIDE_PX)
    part = front & inside(0.0).any(-1)
    return uv, whole, part


def frontend_numbers(world, cam, truth, samples) -> Dict[str, float]:
    where = {mid: i for i, mid in enumerate(world.ids)}
    corner_max, wrong, missed, pos = 0.0, [], 0, []
    for fid, ids, corners, valid, tcm in samples:
        R, t = truth[fid]
        uv, whole, part = in_view(world, cam, R, t)
        seen = set()
        for mid, cor, ok, tm in zip(ids, corners, valid, tcm):
            if not ok:
                continue
            i = where.get(int(mid))
            if i is None or not part[i]:
                wrong.append((fid, int(mid)))
                continue
            seen.add(i)
            err = np.linalg.norm(np.asarray(cor, np.float64) - uv[i], axis=-1)
            corner_max = max(corner_max, float(err.max()))
            c_cam = np.asarray(R) @ np.r_[world.centers[i], 0.0] + t
            pos.append(100.0 * float(np.linalg.norm(
                np.asarray(tm, np.float64) - c_cam)))
        missed += int(sum(1 for i in np.flatnonzero(whole) if i not in seen))
    return dict(corner_max_px=corner_max, wrong_ids=float(len(wrong)),
                missed_markers=float(missed),
                detect_pos_p90_cm=(float(np.percentile(pos, 90)) if pos
                                   else float("inf")),
                detect_pos_max_cm=max(pos, default=float("inf")),
                wrong_id_list=wrong)


def compare(world: scn.World, cam: dict, truth: Dict[int, Tuple],
            posed: List[Tuple[int, Optional[Tuple]]], mp: dict,
            samples: list, ahead: float = 2.0) -> Dict[str, float]:
    """Every number above, and `per_frame`: [(frame id, cm, degrees)] of
    each posed frame, and `wrong_id_list`: [(frame id, id)].

    truth: {frame id: (Rcw, tcw)} of every frame handed to the program;
    posed: [(frame id, (Rcw, tcw) or None)] in the order handed; mp: the
    map's arrays (valid keyframes' kf_frame_id, kf_Rcw, kf_tcw, valid
    markers' mk_id, mk_Rwm, mk_twm, valid points' pt_xyz); samples: [(frame
    id, mk_ids, mk_corners, mk_valid, mk_tcm)] of the frames checked."""
    out = {}
    first = next((i for i, (_, p) in enumerate(posed) if p is not None),
                 None)
    out["lost_frames"] = float(
        len(posed) if first is None
        else sum(p is None for _, p in posed[first:]))
    out["lost_pct"] = (100.0 if first is None else
                       100.0 * out["lost_frames"] / (len(posed) - first))
    A = align(world, truth, mp)
    if A is None:
        inf = float("inf")
        out.update(pose_err_p90_cm=inf, pose_err_max_cm=inf,
                   pose_rot_max_deg=inf,
                   kf_err_max_cm=inf, kf_rot_max_deg=inf,
                   marker_pos_max_cm=inf, point_plane_p90_cm=inf)
    else:
        Rmw, tmw = A
        errs = [pose_errors(Rmw, tmw, *p, *truth[fid], ahead)
                for fid, p in posed if p is not None]
        out["per_frame"] = [(fid, *e) for (fid, p), e in zip(
            [q for q in posed if q[1] is not None], errs)]
        kf = [pose_errors(Rmw, tmw, R, t, *truth[int(fid)], ahead)
              for fid, R, t in zip(mp["kf_frame_id"], mp["kf_Rcw"],
                                   mp["kf_tcw"]) if int(fid) in truth]
        out["pose_err_max_cm"] = max((e[0] for e in errs),
                                     default=float("inf"))
        out["pose_err_p90_cm"] = (
            float(np.percentile([e[0] for e in errs], 90))
            if errs else float("inf"))
        out["pose_rot_max_deg"] = max((e[1] for e in errs),
                                      default=float("inf"))
        out["kf_err_max_cm"] = max((e[0] for e in kf), default=0.0)
        out["kf_rot_max_deg"] = max((e[1] for e in kf), default=0.0)
        where = {mid: i for i, mid in enumerate(world.ids)}
        mk = [100.0 * float(np.linalg.norm(
            Rmw.T @ (np.asarray(twm, np.float64) - tmw)
            - np.r_[world.centers[where[int(mid)]], 0.0]))
            for mid, twm in zip(mp["mk_id"], mp["mk_twm"])
            if int(mid) in where]
        out["marker_pos_max_cm"] = max(mk, default=0.0)
        pts = (np.asarray(mp["pt_xyz"], np.float64) - tmw) @ Rmw
        out["point_plane_p90_cm"] = (
            100.0 * float(np.percentile(np.abs(pts[:, 2]), 90))
            if len(pts) else float("inf"))
    ids = set(world.ids)
    out["foreign_markers"] = float(sum(int(m) not in ids
                                       for m in mp["mk_id"]))
    out.update(frontend_numbers(world, cam, truth, samples))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, number, limit)]): every limited number at or under
    its limit; a number the run did not give, or gave as infinite, fails."""
    rows = [(k, numbers.get(k, float("nan")), float(v))
            for k, v in limits.items()]
    ok = all(np.isfinite(n) and n <= lim for _, n, lim in rows)
    return bool(ok), rows
