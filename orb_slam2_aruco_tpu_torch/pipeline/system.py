"""System facade: the host-side per-frame loop.

Port of orb_slam2_aruco_tpu/pipeline/system.py (reference System.cc and
the Tracking state machine, Tracking.cc:192-492), in two modes:

  * SLAM mode, the default without a loaded map: two-view
    initialization (marker pose, else the classic H / F fallback), the
    tracking cascade (`tracking.track_full`), the keyframe decision and,
    after each insert, the mapping phase in steps (`_mapping_phase_steps`):
    triangulation against the covisible keyframes, point culling + fusion
    + normals, distinctive descriptors + the marker plane update, local
    BA, keyframe culling + loop detection. A detected loop is verified by
    its Sim3 and corrected (essential graph, a whole-map fuse), and a
    global BA follows in slices of a few iterations, two at once and one
    per later frame (also while LOST; `flush` drains the rest). A frame
    LOST with few keyframes resets the map.
    At tracking.pipeline_depth 0 every frame reads its control vector and
    runs the whole mapping phase of its insert before the next frame. At
    depth d > 0 (pipelined) a tracked frame's control vector is read d
    frames later: the tracking context chains from frame to frame on the
    device, the keyframe and LOST decisions lag by up to d frames, the
    mapping phase runs one step per later tracked frame (its local BA in
    `optim.local_ba_slices` slices) with its reads deferred, and a frame
    found LOST rewinds the frames in flight through the per-frame path.
    The host issues the work in the JAX package's order, on one stream.
  * localization against a saved map, the reference's two-pass workflow,
    pass 2 (mono_cvcam.cc:183-235): `load_map` enters LOST +
    localization-only mode, the first frame relocalizes, every later frame
    runs the tracking cascade. The chunked serving form tracks a chunk of
    frames per `tracking.track_batch` call and reads one control vector per
    chunk: `track_monocular_batch` and `localize_stream` (chunks
    dispatched speculatively, `depth` in flight).

A LOST frame relocalizes by a bound marker, else by BoW candidates and
RANSAC PnP (both modes). `save_map` writes the map as the JAX package's
checkpoint. With `optim.distributed_gba` the global BA slices shard their
observations over a device list (`_gba_mesh`, by default every CUDA
device; parallel/dist_ba.py) when it has more than one entry; one card
takes the single-device branch, as the reference does on one chip.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch import require_device
from orb_slam2_aruco_tpu_torch.config import SlamConfig
from orb_slam2_aruco_tpu_torch.geometry import camera as cam_mod
from orb_slam2_aruco_tpu_torch.geometry.lie import se3_compose, se3_inverse
from orb_slam2_aruco_tpu_torch.io import checkpoint
from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource
from orb_slam2_aruco_tpu_torch.parallel import dist_ba
from orb_slam2_aruco_tpu_torch.pipeline import (
    initializer,
    loop_closing,
    mapping,
    tracking,
)
from orb_slam2_aruco_tpu_torch.pipeline.frontend import Frame, make_frame
from orb_slam2_aruco_tpu_torch.worldmap.state import empty_map


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass
class FrameRecord:
    frame_id: int
    ts: float
    Rcw: np.ndarray
    tcw: np.ndarray
    state: TrackingState


class SlamSystem:
    """Monocular engine facade (System::TrackMonocular): SLAM mode from an
    empty map, or localization against a loaded one."""

    def __init__(self, cfg: SlamConfig, device="cuda"):
        self.cfg = cfg
        self.device = require_device(device)
        self.cam = cam_mod.camera_from_config(cfg.camera, self.device)
        self.trajectory: List[FrameRecord] = []
        self.localization_only = False
        self.frame_id = 0
        self.stats = {"kf_inserted": 0, "pts_created": 0, "ba_runs": 0,
                      "reloc": 0, "aruco_seeded": 0, "loops_closed": 0,
                      "chunks": 0, "rewinds": 0}
        self.bow_consistency = loop_closing.ConsistencyTracker(
            cfg.loop.consistency_threshold)
        self._in_rewind = False
        # the distributed global BA's device list (None: the map's device,
        # then the other CUDA devices, at its first slice)
        self._gba_mesh = None
        self.reset()

    def reset(self, state=None):
        """System::Reset — clear all tracking context and install `state`
        as the map, by default an empty one."""
        K = self.cfg.map.max_keyframes
        self.map = empty_map(self.cfg, self.device) if state is None else state
        self.state = TrackingState.NO_IMAGES_YET
        self.n_keyframes = 0
        self.last_kf_frame_id = -(10**9)
        self.last_reloc_frame_id = -(10**9)
        self.last_loop_kf_count = 0
        self.ref_kf = 0
        self.last_kf_slot = -1
        self.prev_kf_slot = -1
        # host mirror of keyframe-slot occupancy: the host hands each
        # insert its slot, nothing reads the device for it
        self._kf_valid_host = np.zeros(K, bool)
        # per-slot timestamps in float64 (the map's kf_ts is float32)
        self.kf_ts64 = np.zeros(K, np.float64)
        self.last_frame: Optional[Frame] = None
        self.last_obs = None
        self.last_pose = None
        self.vel = None
        self.init_frame: Optional[Frame] = None
        self.init_frame_id = -1
        self.init_ts = 0.0
        self.bow_consistency.reset()
        # the post-loop global BA, run in slices: iterations still due,
        # the halfway whole-map fuse, the (cameras, points) bucket and the
        # keyframe count it was sized at, the point bucket's rotation
        self.pending_gba_iters = 0
        self.pending_gba_fuse = False
        self._gba_shape = None
        self._gba_shape_kfs = -1
        self._gba_pt_offset = 0
        # pipelined SLAM mode: the frames in flight (fid, ts, frame,
        # FullTrackResult, the copy of its control vector), the deferred
        # mapping-phase steps, the last keyframe cull's victim and loop
        # detections not read yet, deferred stats (key, device scalar) and
        # the reference keyframe as the device computed it
        self._pending = []
        self._map_phase = []
        self._pending_cull = None
        self._pending_loop = None
        self._stat_futures = []
        self._ref_kf_dev = None

    # ------------------------------------------------------------------
    def track_monocular(self, img, ts: float):
        """Process one grayscale frame ([H, W], 0..255, numpy or tensor).
        Returns the world->camera pose (Rcw, tcw) as numpy, or None while
        uninitialized or lost.

        At tracking.pipeline_depth > 0 a frame tracked in SLAM mode returns
        its pose as device tensors whose work may still be queued, and its
        OK / LOST state and keyframe decision come `depth` frames later: the
        trajectory records carry the authoritative per-frame state."""
        fid = self.frame_id
        self.frame_id += 1
        img = self._on_device(img)
        if self.state is TrackingState.OK and self._pipelined():
            return self._track_pipelined(img, fid, ts, is_img=True)
        frame = make_frame(img, self.cam, self.cfg)
        return self._step_frame(frame, fid, ts)

    def _pipelined(self) -> bool:
        return (self.cfg.tracking.pipeline_depth > 0
                and not self.localization_only and not self._in_rewind)

    def _scalar(self, v):
        """A 0-d bool or int64 tensor on the device, filled there: no
        host-to-device copy, which would synchronize."""
        dtype = torch.bool if isinstance(v, bool) else torch.int64
        return torch.full((), v, dtype=dtype, device=self.device)

    def _on_device(self, img):
        """The frame on the device. A host frame goes through pinned memory
        without blocking: a copy from pageable memory is a synchronizing
        call, which waits for all queued work."""
        if not isinstance(img, torch.Tensor):
            img = torch.as_tensor(np.asarray(img))
        if img.device.type == "cpu" and self.device.type == "cuda":
            return img.pin_memory().to(self.device, non_blocking=True)
        return img.to(self.device)

    def _step_frame(self, frame: Frame, fid: int, ts: float):
        if self.state in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED):
            pose = self._try_initialize(frame, fid, ts)
        elif self.state is TrackingState.OK:
            if self._pipelined():
                return self._track_pipelined(frame, fid, ts)
            pose = self._track(frame, fid, ts)
        else:
            pose = self._relocalize(frame, fid, ts)
        # LOST with few keyframes resets the system instead of relocalizing
        # forever (Tracking.cc:458-466); a loaded map is never reset
        if (self.state is TrackingState.LOST and not self.localization_only
                and self.n_keyframes
                <= self.cfg.tracking.reset_if_lost_with_kfs_leq):
            self.reset()
        # one slice of a pending post-loop global BA, also while LOST: the
        # reference's GBA thread repairs the map while tracking is down
        if self.pending_gba_iters > 0 and not self.localization_only:
            self._gba_slice()
        Rcw, tcw = pose if pose is not None else (
            np.eye(3, dtype=np.float32), np.zeros(3, dtype=np.float32))
        self.trajectory.append(
            FrameRecord(fid, ts, np.asarray(Rcw), np.asarray(tcw), self.state))
        return pose

    # ------------------------------------------------------------------
    def _track(self, frame: Frame, fid: int, ts: float):
        cfg = self.cfg
        if self.vel is not None:
            R_pred, t_pred = se3_compose(self.vel[0], self.vel[1],
                                         self.last_pose[0], self.last_pose[1])
        else:
            R_pred, t_pred = self.last_pose
        lf = self.last_frame
        out = tracking.track_full(
            self.map, frame, R_pred, t_pred, self.last_pose[0],
            self.last_pose[1], lf.kp_uv, lf.desc, self.last_obs, lf.kp_valid,
            lf.kp_octave, lf.kp_angle,
            self._scalar(self.ref_kf), self.cam, cfg,
        )
        # one device->host read per frame: control scalars + pose
        tracking.SYNCS["count"] += 1
        ctrl = out.ctrl.cpu().numpy()
        n_map_inliers = int(ctrl[0])
        if ctrl[2] > 0.5:
            self.stats["aruco_seeded"] += 1
        recently_reloc, min_ok = self._inlier_gate(fid)
        if n_map_inliers < min_ok:
            self.state = TrackingState.LOST
            return None
        self.map = self.map._replace(pt_visible=out.pt_visible,
                                     pt_found=out.pt_found)
        if int(ctrl[19]) >= 0:
            self.ref_kf = int(ctrl[19])
        Rl_inv, tl_inv = se3_inverse(*self.last_pose)
        self.vel = se3_compose(out.Rcw, out.tcw, Rl_inv, tl_inv)
        # the tracking context is committed before the mapping phase: its
        # point fusion forwards last_obs through merges
        self.last_frame = frame
        self.last_obs = out.obs_point
        Rcw, tcw = out.Rcw, out.tcw
        if (not self.localization_only
                and self._kf_decision(ctrl, fid, n_map_inliers,
                                      recently_reloc)):
            k = self._insert_keyframe(frame, Rcw, tcw, out.obs_point,
                                      out.slots, fid, ts,
                                      mk_old=out.old_flags)
            if k is not None:
                # the next frame tracks from the post-BA keyframe pose
                Rcw, tcw = self.map.kf_Rcw[k], self.map.kf_tcw[k]
        self.last_pose = (Rcw, tcw)
        return ctrl[5:14].reshape(3, 3), ctrl[14:17].copy()

    def _inlier_gate(self, fid: int):
        """(recently relocalized, least local-map inliers): the
        TrackLocalMap gates (Tracking.cc:1286-1292), < 30 inliers fails,
        < 50 within mMaxFrames of a relocalization."""
        cfg = self.cfg
        recently_reloc = (fid < self.last_reloc_frame_id
                          + cfg.tracking.max_frames_between_kf)
        return recently_reloc, (cfg.tracking.reloc_min_inliers
                                if recently_reloc
                                else cfg.tracking.min_matches_local_map)

    # ------------------------------------------------------------------
    # pipelined SLAM mode (tracking.pipeline_depth > 0)
    # ------------------------------------------------------------------
    def _track_pipelined(self, frame, fid: int, ts: float,
                         is_img: bool = False):
        """Queue this frame's tracking (from its image when `is_img`) and
        defer its control-vector read: the tracking context (pose,
        velocity, last frame, visibility counters, reference keyframe)
        chains on the device, and the oldest frame is read once more than
        `pipeline_depth` frames are in flight (the reference's tracking
        thread running ahead of LocalMapping, System.cc:96-101). Returns
        the pose as device tensors."""
        cfg = self.cfg
        if self.vel is not None:
            R_pred, t_pred = se3_compose(*self.vel, *self.last_pose)
        else:
            R_pred, t_pred = self.last_pose
        ref = (self._ref_kf_dev if self._ref_kf_dev is not None
               else self._scalar(self.ref_kf))
        lf = self.last_frame
        args = (R_pred, t_pred, *self.last_pose, lf.kp_uv, lf.desc,
                self.last_obs, lf.kp_valid, lf.kp_octave, lf.kp_angle, ref,
                self.cam, cfg)
        if is_img:
            frame, out = tracking.track_full_img(self.map, frame, *args)
        else:
            out = tracking.track_full(self.map, frame, *args)
        ctrl = tracking.HostCopy(out.ctrl)
        self.map = self.map._replace(pt_visible=out.pt_visible,
                                     pt_found=out.pt_found)
        self.vel = se3_compose(out.Rcw, out.tcw, *se3_inverse(*self.last_pose))
        self.last_pose = (out.Rcw, out.tcw)
        self.last_frame = frame
        self.last_obs = out.obs_point
        ref_new = out.ctrl[19].to(torch.int64)
        self._ref_kf_dev = torch.where(ref_new >= 0, ref_new, ref)
        self._pending.append((fid, ts, frame, out, ctrl))
        while len(self._pending) > cfg.tracking.pipeline_depth:
            if not self._process_oldest():
                break
        return out.Rcw, out.tcw

    def _process_oldest(self) -> bool:
        """Read the oldest frame in flight and take its host decisions: its
        trajectory record, then a keyframe insert, else one deferred
        mapping-phase step, else one global-BA slice. The previous insert's
        deferred reads are resolved first. Returns False when the frame was
        LOST and the frames in flight were rewound."""
        fid, ts, frame, out, ctrl = self._pending.pop(0)
        self._resolve_cull()
        self._resolve_loop_detection()
        ctrl = ctrl.read()
        n_map_inliers = int(ctrl[0])
        if ctrl[2] > 0.5:
            self.stats["aruco_seeded"] += 1
        recently_reloc, min_ok = self._inlier_gate(fid)
        if n_map_inliers < min_ok:
            self._rewind_lost(fid, ts)
            return False
        if int(ctrl[19]) >= 0:
            self.ref_kf = int(ctrl[19])
        self.trajectory.append(FrameRecord(
            fid, ts, ctrl[5:14].reshape(3, 3), ctrl[14:17].copy(),
            TrackingState.OK))
        if self._kf_decision(ctrl, fid, n_map_inliers, recently_reloc):
            self._insert_keyframe(frame, out.Rcw, out.tcw, out.obs_point,
                                  out.slots, fid, ts, mk_old=out.old_flags,
                                  sync=False)
        elif self._map_phase:
            self._map_phase.pop(0)[1]()
        elif self.pending_gba_iters > 0:
            self._gba_slice()
        return True

    def _rewind_lost(self, fid: int, ts: float):
        """The oldest frame in flight was LOST: the frames queued after it
        chained from a bad pose. Record it LOST, finish the previous
        insert's mapping phase, and replay the frames in flight through the
        per-frame path (relocalization, then tracking); reset if that ends
        LOST with few keyframes (Tracking.cc:458-466)."""
        self.state = TrackingState.LOST
        self.vel = None
        self._ref_kf_dev = None
        self._drain_map_phase()
        rest, self._pending = self._pending, []
        self.trajectory.append(FrameRecord(
            fid, ts, np.eye(3, dtype=np.float32),
            np.zeros(3, dtype=np.float32), self.state))
        self._in_rewind = True
        try:
            for pfid, pts, pframe, _, _ in rest:
                self._step_frame(pframe, pfid, pts)
        finally:
            self._in_rewind = False
        if (self.state is TrackingState.LOST and not self.localization_only
                and self.n_keyframes
                <= self.cfg.tracking.reset_if_lost_with_kfs_leq):
            self.reset()

    def flush_pipeline(self):
        """Read every frame in flight and take its decisions, run the
        deferred mapping-phase steps, resolve the deferred reads and add
        the deferred stats (one read)."""
        while self._pending:
            if not self._process_oldest():
                break
        self._drain_map_phase()
        self._resolve_cull()
        self._resolve_loop_detection()
        if self._stat_futures:
            vals = tracking.host_read(torch.stack(
                [v.to(torch.int64).reshape(()) for _, v in
                 self._stat_futures]))
            for (key, _), v in zip(self._stat_futures, vals):
                self.stats[key] = self.stats.get(key, 0) + int(v)
            self._stat_futures = []

    def _drain_map_phase(self):
        while self._map_phase:
            self._map_phase.pop(0)[1]()

    def _rescale_context(self, s):
        """Carry a marker-plane scale correction `s` (a device scalar; 1
        when none) into the tracking context on the device: the last pose's
        and the velocity's translations and every frame in flight's pose
        and control-vector translation (on a copy)."""
        self.last_pose = (self.last_pose[0], self.last_pose[1] * s)
        if self.vel is not None:
            self.vel = (self.vel[0], self.vel[1] * s)
        pending = []
        for fid, ts, frame, out, _ in self._pending:
            c = out.ctrl
            ctrl = torch.cat([c[:14], c[14:17] * s, c[17:]])
            pending.append((fid, ts, frame,
                            out._replace(tcw=out.tcw * s, ctrl=ctrl),
                            tracking.HostCopy(ctrl)))
        self._pending = pending

    # ------------------------------------------------------------------
    # SLAM mode: initialization, keyframe decision, mapping phase
    # ------------------------------------------------------------------
    def _try_initialize(self, frame: Frame, fid: int, ts: float):
        """Two-view initialization (MonocularInitialization,
        Tracking.cc:494-688): the first frame with enough features is the
        reference; a later frame sharing a good marker with it gives the
        relative pose (classic H / F after 2 frames without a common
        marker). Then two keyframes, triangulation and a global BA over
        them (CreateInitialMapMonocular, :690-819)."""
        cfg = self.cfg
        n_kp, n_good_mk = (int(v) for v in tracking.host_read(frame.ctrl))
        if self.init_frame is None:
            if n_kp >= cfg.tracking.min_init_features:
                self._set_init_frame(frame, fid, ts)
                self.state = TrackingState.NOT_INITIALIZED
            return None
        metric = True
        cand = initializer.marker_relative_pose(self.init_frame, frame,
                                                self.cam, cfg)
        cand_ok, err, _ = tracking.host_read(cand.ctrl)   # ok, err, baseline
        cand_ok = cand_ok > 0.5
        if not cand_ok:
            bad_geometry = err >= cfg.tracking.init_marker_reproj_err
            no_common_marker = err >= 1e8
            if no_common_marker and fid - self.init_frame_id >= 2:
                # markerless fallback: unit scale; a later marker plane
                # update supplies the metric scale
                cand = initializer.classic_relative_pose(
                    self.init_frame, frame, self.cam, cfg)
                metric = False
                cand_ok = tracking.host_sync(cand.ok)
            if not cand_ok:
                # keep the reference while only the baseline is short;
                # replace it when the geometry is inconsistent or stale
                if ((bad_geometry and not no_common_marker and n_good_mk > 0)
                        or fid - self.init_frame_id > 20):
                    self._set_init_frame(frame, fid, ts)
                return None
        N = self.init_frame.kp_uv.shape[0]
        no_obs = torch.full((N,), -1, dtype=torch.int64, device=self.device)
        eye = torch.eye(3, dtype=torch.float32, device=self.device)
        zero = torch.zeros(3, dtype=torch.float32, device=self.device)
        k1 = self._host_alloc_slot()
        self.map, _ = mapping.create_keyframe(
            self.map, self.init_frame, eye, zero, no_obs,
            tracking.bind_markers(self.map, self.init_frame),
            self.init_frame_id, self.init_ts, self.cam, cfg, slot=k1)
        k2 = self._host_alloc_slot()
        self.map, _ = mapping.create_keyframe(
            self.map, frame, cand.R21, cand.t21, no_obs,
            tracking.bind_markers(self.map, frame), fid, ts, self.cam, cfg,
            slot=k2)
        self.map, n_new = mapping.triangulate_new_points(
            self.map, k2, k1, self.cam, cfg, max_new=512)
        self.map, _ = mapping.bundle_adjust(
            self.map, k2, self.cam, cfg, max_cams=4, max_pts=1024,
            iters=cfg.optim.global_ba_iters, window_all=True)
        # marker init is metric; a classic init waits for the plane update
        self.map = self.map._replace(scale_done=torch.full(
            (), metric, dtype=torch.bool, device=self.device))
        # one read: the new point count and the pose
        head = tracking.host_read(torch.cat([
            n_new.to(torch.float32).reshape(1), cand.R21.reshape(-1),
            cand.t21]))
        self.kf_ts64[k1] = self.init_ts
        self.kf_ts64[k2] = ts
        self.n_keyframes = 2
        self.stats["kf_inserted"] += 2
        self.stats["pts_created"] += int(head[0])
        self.ref_kf = k2
        self.prev_kf_slot = k1
        self.last_kf_slot = k2
        self.last_kf_frame_id = fid
        self.last_frame = frame
        self.last_obs = self.map.kf_obs_point[k2]
        self.last_pose = (cand.R21, cand.t21)
        self.vel = None
        self.state = TrackingState.OK
        return head[1:10].reshape(3, 3), head[10:13].copy()

    def _set_init_frame(self, frame: Frame, fid: int, ts: float):
        self.init_frame = frame
        self.init_frame_id = fid
        self.init_ts = ts

    def _kf_decision(self, ctrl, fid, n_map_inliers, recently_reloc) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1296-1392): a new good marker always
        inserts; otherwise (c1a: mMaxFrames since the last keyframe, or
        c1b: mMinFrames with mapping idle, always true here) and c2: fewer
        inliers than thRefRatio x the reference keyframe's points, above
        15; no insert right after a relocalization in a mature map."""
        cfg = self.cfg
        since_kf = fid - self.last_kf_frame_id
        nkfs = self.n_keyframes
        max_f = cfg.tracking.max_frames_between_kf
        n_ref = int(ctrl[18] if nkfs <= 2 else ctrl[17])
        th_ratio = 0.4 if nkfs < 2 else cfg.tracking.kf_ref_ratio
        reloc_block = recently_reloc and nkfs > max_f
        c1 = (since_kf >= max_f
              or since_kf >= cfg.tracking.min_frames_between_kf)
        c2 = n_map_inliers < n_ref * th_ratio and n_map_inliers > 15
        return bool(ctrl[4] > 0.5 or (c1 and c2 and not reloc_block))

    def _host_alloc_slot(self) -> int:
        free = np.flatnonzero(~self._kf_valid_host)
        if len(free) == 0:
            return -1
        k = int(free[0])
        self._kf_valid_host[k] = True
        return k

    def _read_victim(self, victim) -> int:
        """The one device read of a keyframe cull (a tracking.HostCopy), and
        the host bookkeeping of the culled slot."""
        v = int(victim.read())
        if v >= 0:
            self._kf_valid_host[v] = False
            self.n_keyframes -= 1
            self.stats["kf_culled"] = self.stats.get("kf_culled", 0) + 1
            if v == self.prev_kf_slot:
                self.prev_kf_slot = self.last_kf_slot
            if v == self.ref_kf:
                self.ref_kf = self.last_kf_slot
        return v

    def _resolve_cull(self):
        """Read the last keyframe cull's victim, if one is pending."""
        if self._pending_cull is not None:
            victim, self._pending_cull = self._pending_cull, None
            self._read_victim(victim)

    def _insert_keyframe(self, frame, Rcw, tcw, obs_point, slots, fid, ts,
                         mk_old=None, sync=True):
        """Insert a keyframe and its mapping phase (LocalMapping::Run): run
        inline (`sync`), or queued one step per later tracked frame with
        its reads deferred (pipelined mode). A previous insert's pending
        steps and reads are settled first. Returns the slot, or None."""
        cfg = self.cfg
        self._drain_map_phase()
        self._resolve_cull()
        self._resolve_loop_detection()
        if self.n_keyframes >= cfg.map.max_keyframes:
            # pool at capacity: evict the most redundant keyframe first
            self.map, victim = mapping.cull_keyframes(
                self.map, self.last_kf_slot, cfg, force=True)
            if self._read_victim(tracking.HostCopy(victim, defer=False)) < 0:
                return None
        k = self._host_alloc_slot()
        if k < 0:
            return None
        self.map, _ = mapping.create_keyframe(
            self.map, frame, Rcw, tcw, obs_point, slots, fid, ts, self.cam,
            cfg, mk_old=mk_old, slot=k)
        self.n_keyframes += 1
        self.stats["kf_inserted"] += 1
        self.kf_ts64[k] = ts
        self.prev_kf_slot = self.last_kf_slot
        self.last_kf_slot = k
        self.last_kf_frame_id = fid
        self.ref_kf = k
        self._ref_kf_dev = None
        steps = self._mapping_phase_steps(k, sync)
        if sync:
            for _, step in steps:
                step()
        else:
            self._map_phase.extend(steps)
        return k

    def _mapping_phase_steps(self, k: int, sync: bool):
        """The post-insert mapping phase of keyframe k in the reference's
        order, as (name, step) pairs: triangulation, point culling + fusion
        + stats, descriptors + the marker plane, the local BA (one slice
        when `sync`, else `optim.local_ba_slices` slices of
        ceil(local_ba_iters_second / slices) iterations), keyframe culling
        + loop detection. Inline (`sync`) the steps read the new point
        count, the scale correction, the culled keyframe and the loop
        detections; pipelined, the point count waits for flush_pipeline,
        the scale correction and each BA slice's move of the keyframe are
        carried into the tracking context on the device, and the victim
        and detections are read one frame later."""
        cfg = self.cfg

        def triangulate():
            self.map, n_new = mapping.triangulate_vs_covisible(
                self.map, k, self.cam, cfg,
                n_neighbors=cfg.map.triangulation_neighbors, max_new=256)
            if sync:
                self.stats["pts_created"] += int(tracking.host_read(n_new))
            else:
                self._stat_futures.append(("pts_created", n_new))

        def fuse():
            # cull recent points, merge duplicates, refresh normals
            self.map, _ = mapping.cull_points(self.map,
                                              cfg.map.cull_found_ratio)
            self.map, _, merged_to = mapping.fuse_duplicates(
                self.map, k, self.cam, cfg)
            self._apply_point_remap(merged_to)
            self.map = mapping.update_point_stats(self.map, cfg)

        def desc_plane():
            # descriptors, marker plane measurement and the one-shot rescale
            self.map = mapping.distinctive_descriptors(self.map, cfg, kf=k)
            self.map, s_corr = mapping.aruco_plane_update(self.map, k,
                                                          self.cam, cfg)
            if not sync:
                self._rescale_context(s_corr)
                return
            s = float(tracking.host_read(s_corr))
            if abs(s - 1.0) > 1e-6:
                self.last_pose = (self.last_pose[0], self.last_pose[1] * s)
                self.vel = None
                self.stats["scale_corrections"] = (
                    self.stats.get("scale_corrections", 0) + 1)

        def ba_slice(iters, first):
            def run():
                if not self._mapped(k):
                    return
                T_pre = (self.map.kf_Rcw[k], self.map.kf_tcw[k])
                self.map, _ = mapping.bundle_adjust(
                    self.map, k, self.cam, cfg,
                    max_cams=cfg.map.local_ba_window, max_pts=2048,
                    iters=iters, max_fixed=cfg.map.local_ba_fixed_ring)
                if first:
                    self.stats["ba_runs"] += 1
                if not sync:
                    # later frames chained from the pre-BA pose
                    # (Tracking::UpdateLastFrame re-derives it)
                    self._reanchor(k, T_pre)
            return run

        def cull_and_detect():
            if not self._mapped(k):
                return
            self.map, victim = mapping.cull_keyframes(self.map, k, cfg)
            self._pending_cull = tracking.HostCopy(victim, defer=not sync)
            if sync:
                self._resolve_cull()
            if not (self._kf_valid_host[k]
                    and self.n_keyframes - self.last_loop_kf_count
                    >= cfg.loop.min_kfs_between_loops):
                return
            det_mk, det_bow = loop_closing.detect_loops(
                self.map, k, min_gap=cfg.loop.min_kfs_between_loops)
            self._pending_loop = (k, tracking.HostCopy(torch.stack([
                det_mk.found.to(torch.int64), det_mk.kf_loop,
                det_mk.marker_slot, det_bow.found.to(torch.int64),
                det_bow.kf_loop]), defer=not sync))
            if sync:
                self._resolve_loop_detection()

        total = cfg.optim.local_ba_iters_second
        n_slices = 1 if sync else max(1, int(cfg.optim.local_ba_slices))
        per = -(-total // n_slices)
        return [("triangulate", triangulate), ("fuse+stats", fuse),
                ("desc+plane", desc_plane),
                *[(f"ba[{per}]", ba_slice(per, i == 0))
                  for i in range(n_slices)],
                ("kf_cull+loop", cull_and_detect)]

    def _mapped(self, k: int) -> bool:
        """Whether keyframe k takes the local BA, culling and loop
        detection: still valid, in a map past its two initial keyframes."""
        return self.n_keyframes > 2 and bool(self._kf_valid_host[k])

    # ------------------------------------------------------------------
    # loop closing and the post-loop global BA
    # ------------------------------------------------------------------
    def _resolve_loop_detection(self):
        """Read the pending loop detections of keyframe k (LoopClosing::Run)
        as one vector, unless k was culled since: a marker loop, else a BoW
        loop past the consistency gate, verified by its Sim3
        (ComputeSim3ByAruco / ComputeSim3, one read of its verdict) and
        corrected (CorrectLoopByAruco, LoopClosing.cc:362-887)."""
        if self._pending_loop is None:
            return
        (k, dets), self._pending_loop = self._pending_loop, None
        if not self._kf_valid_host[k]:
            return
        cfg = self.cfg
        mk_found, mk_loop, mk_slot, bow_found, bow_loop = (
            int(v) for v in dets.read())
        if mk_found:
            kf_loop, slot = mk_loop, mk_slot
        elif bow_found and self.bow_consistency.update(self.map, bow_loop):
            # BoW candidates need three consistent detections in a row
            kf_loop, slot = bow_loop, -1
        else:
            return
        self.stats["loops_detected"] = self.stats.get("loops_detected", 0) + 1
        if slot >= 0:
            cand = loop_closing.compute_sim3(self.map, k, kf_loop, slot,
                                             self.cam, cfg)
        else:
            cand = loop_closing.compute_sim3_classic(self.map, k, kf_loop,
                                                     self.cam, cfg)
        if not tracking.host_sync(cand.ok):
            self.stats["loop_sim3_rejected"] = (
                self.stats.get("loop_sim3_rejected", 0) + 1)
            return
        ref = self.ref_kf
        T_ref0 = (self.map.kf_Rcw[ref], self.map.kf_tcw[ref])
        self.map, _ = loop_closing.correct_loop(
            self.map, k, kf_loop, cand.s, cand.R, cand.t, self.cam, cfg)
        # fuse the two sides of the loop now (SearchAndFuse,
        # LoopClosing.cc:1074-1100): tracking needs the merged points
        self.map, _, merged_to = mapping.fuse_duplicates(
            self.map, k, self.cam, cfg, restrict_covisible=False,
            radius_scale=0.015)
        self._apply_point_remap(merged_to)
        self._reanchor(ref, T_ref0)
        # the global BA (the reference's detached GBA thread,
        # LoopClosing.cc:880) in slices; a later loop restarts it. Two
        # slices now, so the next frame tracks against a consistent map
        self.pending_gba_iters = cfg.optim.post_loop_gba_iters
        self.pending_gba_fuse = True
        self._gba_shape = self._gba_bucket_shape()
        self._gba_shape_kfs = self.n_keyframes
        self._gba_pt_offset = 0
        self._gba_slice()
        self._gba_slice()
        self.last_loop_kf_count = self.n_keyframes
        self.stats["loops_closed"] += 1

    def _reanchor(self, ref: int, T_ref0):
        """Carry the tracking context through a move of the reference
        keyframe: T_last' = (T_last T_ref0^-1) T_ref1 (the reference
        re-derives frame poses from their reference keyframe)."""
        if self.last_pose is None:
            return
        Rrel, trel = se3_compose(*self.last_pose, *se3_inverse(*T_ref0))
        self.last_pose = se3_compose(Rrel, trel, self.map.kf_Rcw[ref],
                                     self.map.kf_tcw[ref])

    def _gba_bucket_shape(self):
        """Power-of-two (keyframe, point) bucket sizes covering the live
        map with headroom (one read: the live point count)."""
        cfg = self.cfg
        n_pts_live = int(tracking.host_read(self.map.pt_valid.sum()))
        kb = 8
        while kb < min(self.n_keyframes + 8, cfg.map.max_keyframes):
            kb *= 2
        kb = min(kb, cfg.map.max_keyframes)
        pb = 1024
        while pb < min(int(n_pts_live * 1.25) + 256, cfg.map.max_points):
            pb *= 2
        return kb, min(pb, 8192, cfg.map.max_points)

    def _gba_slice(self):
        """One slice of the pending post-loop global BA
        (RunGlobalBundleAdjustment, LoopClosing.cc:1132-1236): a few LM
        iterations over the whole map, its point bucket rotating from slice
        to slice, then the tracking context re-anchored. The bucket grows
        when keyframes were inserted since it was sized; halfway through,
        one more whole-map fuse. With optim.distributed_gba and a device
        list of more than one entry the slice's observations are sharded
        over it (the JAX package's system.py:1204-1215)."""
        cfg = self.cfg
        ref = self.ref_kf
        T_ref0 = (self.map.kf_Rcw[ref], self.map.kf_tcw[ref])
        if self.n_keyframes != self._gba_shape_kfs:
            kb1, pb1 = self._gba_bucket_shape()
            self._gba_shape = (max(self._gba_shape[0], kb1),
                               max(self._gba_shape[1], pb1))
            self._gba_shape_kfs = self.n_keyframes
        gba_cams, gba_pts = self._gba_shape
        if cfg.optim.distributed_gba and self._gba_mesh is None:
            # the map's device leads: the solve's result lands there
            lead = self.map.kf_Rcw.device
            self._gba_mesh = [lead] + (
                [d for d in dist_ba.make_mesh() if d != lead]
                if lead.type == "cuda" else [])
        if cfg.optim.distributed_gba and len(self._gba_mesh) > 1:
            self.map, _ = mapping.bundle_adjust_distributed(
                self.map, self.last_kf_slot, self.cam, cfg, self._gba_mesh,
                max_cams=gba_cams, max_pts=gba_pts,
                iters=cfg.optim.gba_slice_iters, window_all=True,
                pt_offset=self._gba_pt_offset)
            self.stats["gba_slices_distributed"] = self.stats.get(
                "gba_slices_distributed", 0) + 1
        else:
            self.map, _ = mapping.bundle_adjust(
                self.map, self.last_kf_slot, self.cam, cfg,
                max_cams=gba_cams, max_pts=gba_pts,
                iters=cfg.optim.gba_slice_iters, window_all=True,
                pt_offset=self._gba_pt_offset)
        self._gba_pt_offset = ((self._gba_pt_offset + gba_pts)
                               % cfg.map.max_points)
        self.pending_gba_iters -= cfg.optim.gba_slice_iters
        self.stats["gba_slices"] = self.stats.get("gba_slices", 0) + 1
        if (self.pending_gba_fuse and self.pending_gba_iters
                <= cfg.optim.post_loop_gba_iters // 2):
            self.map, _, merged_to = mapping.fuse_duplicates(
                self.map, self.last_kf_slot, self.cam, cfg,
                restrict_covisible=False)
            self._apply_point_remap(merged_to)
            self.pending_gba_fuse = False
        self._reanchor(ref, T_ref0)

    def flush(self):
        """Drain the pipeline and the pending global BA slices (joining the
        reference's threads at shutdown, System.cc:205-224)."""
        self.flush_pipeline()
        while self.pending_gba_iters > 0:
            self._gba_slice()

    def _apply_point_remap(self, merged_to):
        """Forward the tracking context and the frames in flight through a
        point merge (CheckReplacedInLastFrame, Tracking.cc:836)."""
        L = self.map.L

        def remap(obs):
            return torch.where(obs >= 0, merged_to[torch.clamp(obs, 0, L - 1)],
                               obs)

        if self.last_obs is not None:
            self.last_obs = remap(self.last_obs)
        self._pending = [(fid, ts, frame,
                          out._replace(obs_point=remap(out.obs_point)), c)
                         for fid, ts, frame, out, c in self._pending]

    def keyframe_trajectory(self):
        """Final keyframe poses (SaveKeyFrameTrajectoryTUM, System.cc:
        287-321), after `flush`: (frame ids [n],
        timestamps [n] float64, Rcw [n, 3, 3], tcw [n, 3]) sorted by
        frame."""
        self.flush()
        valid = self.map.kf_valid.cpu().numpy()
        fids = self.map.kf_frame_id.cpu().numpy()[valid]
        Rcw = self.map.kf_Rcw.cpu().numpy()[valid]
        tcw = self.map.kf_tcw.cpu().numpy()[valid]
        order = np.argsort(fids)
        return fids[order], self.kf_ts64[valid][order], Rcw[order], tcw[order]

    # ------------------------------------------------------------------
    def _relocalize(self, frame: Frame, fid: int, ts: float):
        """Relocalization of a LOST frame. By marker first
        (RelocalizationByAruco, Tracking.cc:1665-1739): a bound good marker
        gives the pose, refined against the marker's observing keyframe and
        the local map. Else by BoW (Relocalization, Tracking.cc:1741-1914):
        each kept candidate keyframe in turn through RANSAC PnP, and one
        with at least min_inliers_track PnP-refined inliers through the
        local map. Either must reach reloc_min_inliers local-map inliers.
        The candidates and keep flags are read as one vector."""
        cfg = self.cfg
        slots = tracking.bind_markers(self.map, frame)
        ok, R0, t0, _ = tracking.aruco_pose_candidate(
            self.map, frame, slots, self.cam, cfg)
        tr = None
        if tracking.host_sync(ok):
            kf_mk = tracking.marker_observer_kf(self.map, slots)
            if tracking.host_sync(kf_mk >= 0):
                tr0 = tracking.track_vs_keyframe(self.map, frame, slots, kf_mk,
                                                 R0, t0, self.cam, cfg)
                tr, vis_found = self._local_map(frame, slots, tr0)
        if tr is None:
            idx, _, keep = tracking.reloc_candidates(self.map, frame, cfg)
            C = idx.shape[0]
            cands = tracking.host_read(torch.cat([idx, keep.to(idx.dtype)]))
            for c in range(C):
                if not cands[C + c]:
                    continue
                cand = tracking.reloc_pnp(self.map, frame, slots,
                                          int(cands[c]), self.cam, cfg)
                if int(tracking.host_read(cand.n_inliers)) \
                        >= cfg.tracking.min_inliers_track:
                    tr, vis_found = self._local_map(frame, slots, cand)
                    if tr is not None:
                        break
        if tr is None:
            return None
        self.map = self.map._replace(pt_visible=vis_found[0],
                                     pt_found=vis_found[1])
        self.state = TrackingState.OK
        self.stats["reloc"] += 1
        self.last_reloc_frame_id = fid
        self.last_frame = frame
        self.last_obs = tr.obs_point
        self.last_pose = (tr.Rcw, tr.tcw)
        self.vel = None
        # one device->host read for the returned pose
        tracking.SYNCS["count"] += 1
        pose = torch.cat([tr.Rcw.reshape(-1), tr.tcw]).cpu().numpy()
        return pose[:9].reshape(3, 3), pose[9:]

    def _local_map(self, frame: Frame, slots, tr0):
        """The relocalized pose `tr0` through the local map: (TrackResult,
        (pt_visible, pt_found)) at reloc_min_inliers inliers or more (the
        recently-relocalized TrackLocalMap gate, Tracking.cc:1286-1288),
        else (None, None)."""
        cfg = self.cfg
        pt_local, _ = tracking.local_point_mask(
            self.map, tr0.obs_point, cfg.tracking.max_local_keyframes)
        tr, vis_found = tracking.track_local_map(
            self.map, frame, slots, tr0.Rcw, tr0.tcw, tr0.obs_point,
            self.cam, cfg, pt_candidates=pt_local)
        if not tracking.host_sync(tr.n_inliers
                                  >= cfg.tracking.reloc_min_inliers):
            return None, None
        return tr, vis_found

    # ------------------------------------------------------------------
    def _serving(self) -> bool:
        return (self.localization_only and self.state is TrackingState.OK
                and self.last_frame is not None)

    def _run_chunk(self, stack):
        """tracking.track_batch on the frames [B, H, W] after the last
        tracked one: (ctrls [B, 20], carry), both still on the device."""
        if self.vel is not None:
            vR, vt = self.vel
            hv = self._scalar(True)
        else:
            vR = torch.eye(3, dtype=torch.float32, device=self.device)
            vt = torch.zeros(3, dtype=torch.float32, device=self.device)
            hv = self._scalar(False)
        lf = self.last_frame
        self.stats["chunks"] += 1
        return tracking.track_batch(
            self.map, stack, self.last_pose[0], self.last_pose[1], vR, vt,
            hv, lf.kp_uv, lf.desc, self.last_obs, lf.kp_valid, lf.kp_octave,
            lf.kp_angle, self._scalar(self.ref_kf),
            self.cam, self.cfg)

    def _commit_chunk(self, carry):
        """Continue from a chunk's last frame."""
        (Rl, tl, vR2, vt2, _, luv, ldesc, lobs, lval, loct, lang, vis,
         found) = carry
        self.map = self.map._replace(pt_visible=vis, pt_found=found)
        self.last_frame = self.last_frame._replace(
            kp_uv=luv, desc=ldesc, kp_valid=lval, kp_octave=loct,
            kp_angle=lang)
        self.last_obs = lobs
        self.last_pose = (Rl, tl)
        self.vel = (vR2, vt2)

    def _read_chunk(self, ctrls, metas):
        """The one control-vector read of a chunk. Records the frames up to
        the first whose local-map inliers fall below the gate; returns
        ([(fid, ts, (Rcw, tcw))], index of that frame or None)."""
        tracking.SYNCS["count"] += 1
        c = ctrls.cpu().numpy()
        out = []
        for j, (fid, ts) in enumerate(metas):
            if c[j, 0] < self.cfg.tracking.min_matches_local_map:
                return out, j
            Rcw, tcw = c[j, 5:14].reshape(3, 3), c[j, 14:17]
            self.trajectory.append(
                FrameRecord(fid, ts, Rcw, tcw, TrackingState.OK))
            out.append((fid, ts, (Rcw, tcw)))
        return out, None

    def track_monocular_batch(self, imgs, ts_list):
        """Localization-mode throughput path: a chunk of consecutive frames
        in one `track_batch` call and one control-vector read. If a frame
        loses tracking, it and the rest of the chunk go through the
        per-frame path (relocalization). Outside localization mode with
        state OK, every frame goes through `track_monocular`."""
        if not self._serving():
            return [self.track_monocular(im, t) for im, t in zip(imgs, ts_list)]
        stack = torch.stack([self._on_device(im) for im in imgs])
        metas = [(self.frame_id + j, ts) for j, ts in enumerate(ts_list)]
        ctrls, carry = self._run_chunk(stack)
        done, lost_at = self._read_chunk(ctrls, metas)
        poses = [p for _, _, p in done]
        if lost_at is None:
            self._commit_chunk(carry)
            self.frame_id += len(imgs)
            return poses
        # the per-frame path resumes from the state before the chunk
        self.stats["rewinds"] += 1
        self.frame_id += lost_at
        self.state = TrackingState.LOST
        self.vel = None
        for j in range(lost_at, len(imgs)):
            poses.append(self.track_monocular(imgs[j], ts_list[j]))
        return poses

    def localize_stream(self, imgs_ts, chunk: int = 16, depth: int = 2):
        """Localization serving: a generator over (img, ts) pairs yielding
        (frame_id, ts, pose_or_None).

        Up to `depth` chunks are in flight: chunk k+1 is dispatched (its
        kernels queued on the device, no host sync in extrapolate mode)
        before chunk k's control vector is read. Dispatch is speculative: if
        chunk k holds a lost frame, every in-flight chunk after it is
        discarded and the frames from the lost one on go through the
        per-frame path (relocalization, then tracking) until tracking is OK
        again. A StagedSource with batch > 1 is consumed whole batch by
        whole batch. Needs localization mode and state OK."""
        if not self._serving():
            raise RuntimeError("localize_stream needs localization mode and "
                               "state OK (load a map and track first)")
        depth = max(1, int(depth))
        leftover = deque()          # single (img, ts) frames (after rewind)
        exhausted = False
        if isinstance(imgs_ts, StagedSource) and imgs_ts.batch > 1:
            batch_src, frame_src = imgs_ts.batches(), None
        else:
            batch_src, frame_src = None, iter(imgs_ts)

        def pull_one():
            """One more source item into `leftover` (a staged batch counts
            as one); False once the source is exhausted."""
            nonlocal exhausted
            if exhausted:
                return False
            try:
                if batch_src is not None:
                    stack, ts_list = next(batch_src)
                    leftover.extend((stack[j], ts)
                                    for j, ts in enumerate(ts_list))
                else:
                    leftover.append(next(frame_src))
            except StopIteration:
                exhausted = True
                return False
            return True

        def next_chunk():
            """(stack, ts list) of the next chunk, or None: a staged batch
            untouched, else up to `chunk` frames from `leftover`."""
            nonlocal exhausted
            if not leftover and batch_src is not None and not exhausted:
                try:
                    return next(batch_src)
                except StopIteration:
                    exhausted = True
                    return None
            while len(leftover) < chunk and pull_one():
                pass
            if not leftover:
                return None
            items = [leftover.popleft()
                     for _ in range(min(chunk, len(leftover)))]
            return (torch.stack([self._on_device(im) for im, _ in items]),
                    [ts for _, ts in items])

        pending = deque()           # in flight: (ctrls, metas, stack)
        while True:
            # lost, nothing in flight: one frame at a time until OK
            if not pending and self.state is not TrackingState.OK:
                while leftover or pull_one():
                    im, ts = leftover.popleft()
                    fid = self.frame_id
                    yield fid, ts, self.track_monocular(im, ts)
                    if self.state is TrackingState.OK:
                        break
                if self.state is not TrackingState.OK:
                    return
            while len(pending) < depth:
                nc = next_chunk()
                if nc is None:
                    break
                stack, ts_list = nc
                metas = [(self.frame_id + j, ts)
                         for j, ts in enumerate(ts_list)]
                self.frame_id += len(ts_list)
                ctrls, carry = self._run_chunk(stack)
                # committed before the read: the next chunk chains on it
                # speculatively
                self._commit_chunk(carry)
                pending.append((ctrls, metas, stack))
            if not pending:
                return
            ctrls, metas, stack = pending.popleft()
            done, lost_at = self._read_chunk(ctrls, metas)
            yield from done
            if lost_at is not None:
                # rewind: the lost frame, the rest of its chunk and every
                # speculative chunk go back to the per-frame path
                self.stats["rewinds"] += 1
                self.state = TrackingState.LOST
                self.vel = None
                redo = [(stack[j], ts)
                        for j, (_, ts) in enumerate(metas) if j >= lost_at]
                while pending:
                    _, metas_s, stack_s = pending.popleft()
                    redo += [(stack_s[j], ts)
                             for j, (_, ts) in enumerate(metas_s)]
                self.frame_id = metas[lost_at][0]
                leftover.extendleft(reversed(redo))

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """System::ActivateLocalizationMode — drain the pipeline, then stop
        inserting keyframes."""
        self.flush_pipeline()
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def get_trajectory(self):
        """The per-frame records, after the frames in flight are read."""
        self.flush_pipeline()
        return self.trajectory

    def save_map(self, path: str):
        """System::SaveMap: after `flush`, the map (markers included) and
        the float64 keyframe timestamps as the JAX package's checkpoint."""
        self.flush()
        checkpoint.save_map(path, self.map, kf_ts64=self.kf_ts64)

    def load_map(self, path: str):
        """System::LoadMap: load a checkpoint onto this system's device and
        enter localization-only tracking, LOST until the first
        relocalization."""
        self.set_map(checkpoint.load_map(path, self.device))
        ts64 = checkpoint.load_extras(path).get("kf_ts64")
        if ts64 is not None and ts64.shape == self.kf_ts64.shape:
            self.kf_ts64 = ts64.astype(np.float64)

    def set_map(self, state):
        """load_map for a map already in memory (a MapState on this
        system's device, e.g. another system's SLAM-built map)."""
        self.reset(state)
        self._kf_valid_host = state.kf_valid.cpu().numpy().copy()
        self.kf_ts64 = state.kf_ts.cpu().numpy().astype(np.float64)
        self.n_keyframes = int(self._kf_valid_host.sum())
        self.state = TrackingState.LOST
        self.localization_only = True
