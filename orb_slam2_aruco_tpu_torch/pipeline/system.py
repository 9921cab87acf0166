"""System facade, localization subset: the host-side per-frame loop.

Port of orb_slam2_aruco_tpu/pipeline/system.py for localization against a
saved map — the reference's two-pass workflow, pass 2
(mono_cvcam.cc:183-235): `load_map` enters LOST + localization-only mode,
the first frame relocalizes by markers, every later frame runs the tracking
cascade (`tracking.track_full`) and reads one control vector.

Not ported yet: SLAM mode (initializer, mapping, BA, loop closing —
ROADMAP.md slices 2-3), the BoW-PnP relocalization fallback (slice 3; a
frame whose marker relocalization fails stays LOST), and the chunked
serving paths `track_monocular_batch` / `localize_stream`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.config import SlamConfig
from orb_slam2_aruco_tpu_torch.geometry import camera as cam_mod
from orb_slam2_aruco_tpu_torch.geometry.lie import se3_compose, se3_inverse
from orb_slam2_aruco_tpu_torch.io import checkpoint
from orb_slam2_aruco_tpu_torch.pipeline import tracking
from orb_slam2_aruco_tpu_torch.pipeline.frontend import Frame, make_frame


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
    """Monocular engine facade (System::TrackMonocular), localization
    against a loaded map."""

    def __init__(self, cfg: SlamConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.cam = cam_mod.camera_from_config(cfg.camera, self.device)
        self.map = None
        self.state = TrackingState.NO_IMAGES_YET
        self.frame_id = 0
        self.last_reloc_frame_id = -(10**9)
        self.ref_kf = 0
        self.last_frame: Optional[Frame] = None
        self.last_obs = None
        self.last_pose = None
        self.vel = None
        self.trajectory: List[FrameRecord] = []
        self.localization_only = False
        self.stats = {"reloc": 0, "aruco_seeded": 0}

    # ------------------------------------------------------------------
    def track_monocular(self, img, ts: float):
        """Process one grayscale frame ([H, W], 0..255, numpy or tensor).
        Returns the world->camera pose (Rcw, tcw) as numpy, or None while
        lost."""
        if self.map is None or not self.localization_only:
            raise NotImplementedError(
                "SLAM mode (initialization, mapping, BA) is not ported yet: "
                "ROADMAP.md slice 2. Load a map with load_map() and track "
                "in localization mode.")
        fid = self.frame_id
        self.frame_id += 1
        img_t = torch.as_tensor(np.asarray(img)) if not isinstance(
            img, torch.Tensor) else img
        frame = make_frame(img_t.to(self.device), self.cam, self.cfg)
        return self._step_frame(frame, fid, ts)

    def _step_frame(self, frame: Frame, fid: int, ts: float):
        if self.state is TrackingState.OK:
            pose = self._track(frame, fid, ts)
        else:
            pose = self._relocalize(frame, fid, ts)
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
            torch.tensor(self.ref_kf, device=self.device), self.cam, cfg,
        )
        # one device->host read per frame: control scalars + pose
        tracking.SYNCS["count"] += 1
        ctrl = out.ctrl.cpu().numpy()
        n_map_inliers = int(ctrl[0])
        if ctrl[2] > 0.5:
            self.stats["aruco_seeded"] += 1
        # TrackLocalMap gates (Tracking.cc:1286-1292): < 30 inliers fails,
        # < 50 within mMaxFrames of a relocalization
        recently_reloc = (fid < self.last_reloc_frame_id
                          + cfg.tracking.max_frames_between_kf)
        min_ok = (cfg.tracking.reloc_min_inliers if recently_reloc
                  else cfg.tracking.min_matches_local_map)
        if n_map_inliers < min_ok:
            self.state = TrackingState.LOST
            return None
        self.map = self.map._replace(pt_visible=out.pt_visible,
                                     pt_found=out.pt_found)
        if int(ctrl[19]) >= 0:
            self.ref_kf = int(ctrl[19])
        Rl_inv, tl_inv = se3_inverse(*self.last_pose)
        self.vel = se3_compose(out.Rcw, out.tcw, Rl_inv, tl_inv)
        self.last_frame = frame
        self.last_obs = out.obs_point
        self.last_pose = (out.Rcw, out.tcw)
        return ctrl[5:14].reshape(3, 3), ctrl[14:17].copy()

    # ------------------------------------------------------------------
    def _relocalize(self, frame: Frame, fid: int, ts: float):
        """Marker relocalization (RelocalizationByAruco, Tracking.cc:
        1665-1739): a bound good marker gives the pose; matching against
        the marker's observing keyframe and the local map must reach 50
        inliers. The BoW-PnP fallback (Relocalization, Tracking.cc:1741+)
        is not ported yet (ROADMAP.md slice 3): the frame stays LOST."""
        cfg = self.cfg
        slots = tracking.bind_markers(self.map, frame)
        ok, R0, t0, _ = tracking.aruco_pose_candidate(
            self.map, frame, slots, self.cam, cfg)
        if not tracking.host_sync(ok):
            return None
        kf_mk = tracking.marker_observer_kf(self.map, slots)
        if not tracking.host_sync(kf_mk >= 0):
            return None
        tr0 = tracking.track_vs_keyframe(self.map, frame, slots, kf_mk, R0,
                                         t0, self.cam, cfg)
        pt_local, _ = tracking.local_point_mask(
            self.map, tr0.obs_point, cfg.tracking.max_local_keyframes)
        tr, (vis, found) = tracking.track_local_map(
            self.map, frame, slots, tr0.Rcw, tr0.tcw, tr0.obs_point,
            self.cam, cfg, pt_candidates=pt_local)
        if not tracking.host_sync(tr.n_inliers >= cfg.tracking.reloc_min_inliers):
            return None
        self.map = self.map._replace(pt_visible=vis, pt_found=found)
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

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """System::ActivateLocalizationMode — stop inserting keyframes."""
        self.localization_only = True

    def get_trajectory(self):
        return self.trajectory

    def load_map(self, path: str):
        """System::LoadMap: load a checkpoint onto this system's device and
        enter localization-only tracking, LOST until the first
        relocalization."""
        self.map = checkpoint.load_map(path, self.device)
        self.state = TrackingState.LOST
        self.localization_only = True
        self.last_frame = None
        self.last_obs = None
        self.last_pose = None
        self.vel = None
