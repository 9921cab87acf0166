"""System facade, localization subset: the host-side per-frame loop.

Port of orb_slam2_aruco_tpu/pipeline/system.py for localization against a
saved map — the reference's two-pass workflow, pass 2
(mono_cvcam.cc:183-235): `load_map` enters LOST + localization-only mode,
the first frame relocalizes by markers, every later frame runs the tracking
cascade (`tracking.track_full`) and reads one control vector. The chunked
serving form tracks a chunk of frames per `tracking.track_batch` call and
reads one control vector per chunk: `track_monocular_batch` and
`localize_stream` (chunks dispatched speculatively, `depth` in flight).

Not ported yet: SLAM mode (initializer, mapping, BA, loop closing —
ROADMAP.md slices 2-3) and the BoW-PnP relocalization fallback (slice 3; a
frame whose marker relocalization fails stays LOST).
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

    def __init__(self, cfg: SlamConfig, device="cuda"):
        self.cfg = cfg
        self.device = require_device(device)
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
        self.stats = {"reloc": 0, "aruco_seeded": 0, "chunks": 0,
                      "rewinds": 0}

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
        frame = make_frame(self._on_device(img), self.cam, self.cfg)
        return self._step_frame(frame, fid, ts)

    def _on_device(self, img):
        if not isinstance(img, torch.Tensor):
            img = torch.as_tensor(np.asarray(img))
        return img.to(self.device)

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
    def _serving(self) -> bool:
        return (self.localization_only and self.state is TrackingState.OK
                and self.last_frame is not None)

    def _run_chunk(self, stack):
        """tracking.track_batch on the frames [B, H, W] after the last
        tracked one: (ctrls [B, 20], carry), both still on the device."""
        if self.vel is not None:
            vR, vt = self.vel
            hv = torch.tensor(True, device=self.device)
        else:
            vR = torch.eye(3, dtype=torch.float32, device=self.device)
            vt = torch.zeros(3, dtype=torch.float32, device=self.device)
            hv = torch.tensor(False, device=self.device)
        lf = self.last_frame
        self.stats["chunks"] += 1
        return tracking.track_batch(
            self.map, stack, self.last_pose[0], self.last_pose[1], vR, vt,
            hv, lf.kp_uv, lf.desc, self.last_obs, lf.kp_valid, lf.kp_octave,
            lf.kp_angle, torch.tensor(self.ref_kf, device=self.device),
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
