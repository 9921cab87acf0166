"""Monocular SLAM on real footage, a video file or an image directory, on the
card.

Port of examples/mono_video.py, the equivalent of the reference's
mono_cvcam (video entry point, Examples/Monocular/mono_cvcam.cc:115-181)
and mono_marker (image folder + timestamps, mono_marker.cc:191-376) in one
CLI:

  pass 1  SLAM over the sequence (map building)
  pass 2  optional localization-only re-run (the ActivateLocalizationMode
          two-pass scheme, mono_cvcam.cc:152-235), in chunks
  output  per-frame TUM trajectory + keyframe trajectory + median / mean
          tracking time (mono_marker.cc:279-287)

Camera intrinsics come from an OpenCV calibration yml (camera_matrix /
distortion_coefficients, rescaled to --width/--height as
createYMLfromOpencvCamera does, mono_cvcam.cc:31-95) or an ORB-SLAM-style
yml (Camera.fx: ...). Decoding files needs cv2; `run` takes any iterable
of (gray uint8 [H, W], ts) and needs none.

    python -m orb_slam2_aruco_tpu_torch.examples.mono_video \\
        --video seq.mp4 --camera calib.yml --dict ARUCO --marker-size 0.165 \\
        --out traj.tum [--two-pass] [--viewer 0] [--device cpu | --cpu]
    python -m orb_slam2_aruco_tpu_torch.examples.mono_video \\
        --images dir/ --times times.txt --camera calib.yml \\
        --dict ARUCO_MIP_36h12 --width 1280 --height 720
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def _viewer_tick(viewer, slam, img, publish_frame=True):
    """Publish frame + map to the live viewer and apply UI commands (the
    Viewer->Tracking menu flag protocol, reference Viewer.cc:71-78).

    `publish_frame` gates the expensive part: the keypoint overlay reads
    the frame's keypoints from the card and draws at full resolution in
    numpy, so the caller decimates it; browsers poll at ~4 Hz."""
    from orb_slam2_aruco_tpu_torch.pipeline.system import TrackingState
    from orb_slam2_aruco_tpu_torch.viz import framedrawer

    rgb = None
    if publish_frame:
        if slam.last_frame is not None and slam.state is TrackingState.OK:
            uv = framedrawer.host(slam.last_frame.kp_uv)
            valid = framedrawer.host(slam.last_frame.kp_valid)
            tracked = ((framedrawer.host(slam.last_obs) >= 0) & valid
                       if slam.last_obs is not None else valid)
            rgb, _ = framedrawer.draw_frame(img, uv, tracked)
        else:
            # LOST / uninitialized: the retained last_frame keypoints are
            # stale, so publish the raw frame instead of an overlay
            rgb = np.repeat(np.clip(framedrawer.host(img), 0, 255).astype(
                np.uint8)[..., None], 3, axis=-1)
    viewer.update(slam, frame_rgb=rgb)
    for cmd, val in viewer.poll_controls().items():
        if cmd == "reset" and val:
            slam.reset()
        elif cmd == "localization":
            if val:
                slam.activate_localization_mode()
            else:
                slam.deactivate_localization_mode()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--video", type=str, help="video file (any cv2 codec)")
    src.add_argument("--images", type=str, help="image directory")
    ap.add_argument("--times", type=str, default="",
                    help="timestamps file for --images (reference LoadImages "
                         "format: one stem per line, ts = stem/1e6)")
    ap.add_argument("--camera", type=str, required=True,
                    help="OpenCV calibration yml or ORB-SLAM yml")
    ap.add_argument("--out", type=str, default="/tmp/trajectory.tum")
    ap.add_argument("--kf-out", type=str, default="",
                    help="keyframe trajectory TUM path")
    ap.add_argument("--dict", type=str, default="ARUCO")
    ap.add_argument("--marker-size", type=float, default=0.165)
    ap.add_argument("--width", type=int, default=0,
                    help="processing width (0 = calibration size)")
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--two-pass", action="store_true")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--pipeline", type=int, default=2,
                    help="SLAM-mode pipelining depth (frames in flight "
                         "before a control read; 0 = synchronous "
                         "decisions)")
    ap.add_argument("--no-stage", action="store_true",
                    help="disable the double-buffered host->device frame "
                         "staging thread")
    ap.add_argument("--save-map", type=str, default="")
    ap.add_argument("--viewer", type=int, default=-1, metavar="PORT",
                    help="serve the live map viewer on this port "
                         "(0 = auto-pick; open http://127.0.0.1:PORT)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (the card unless told otherwise)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the same as --device cpu)")
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def load_camera(args):
    """The CameraConfig of --camera: an OpenCV calibration file (rescaled
    to --width/--height when both are given), else an ORB-SLAM yml."""
    from orb_slam2_aruco_tpu_torch.io import ingest

    out_size = ((args.width, args.height)
                if args.width and args.height else None)
    try:
        return ingest.camera_from_opencv_yaml(args.camera, out_size=out_size)
    except Exception as e:  # noqa: BLE001 — try the ORB-SLAM yml format
        try:
            return ingest.camera_from_slam_yaml(args.camera)
        except Exception:
            raise SystemExit(f"cannot parse camera file {args.camera}: {e}")


def make_config(camc, args):
    from orb_slam2_aruco_tpu_torch.config import SlamConfig

    cfg = SlamConfig().replace(camera=camc)
    return cfg.replace(
        orb=cfg.orb.__class__(num_features=args.features),
        aruco=cfg.aruco.__class__(dictionary=args.dict,
                                  marker_size=args.marker_size),
        tracking=dataclasses.replace(
            SlamConfig().tracking, pipeline_depth=max(0, args.pipeline)))


def run(cfg, source, args):
    """Both passes over `source`, an iterable of (gray uint8 [H, W], ts),
    then the writers. Returns {"system", "frames" (pass 1's count),
    "pass2" (the second pass's poses, None where not tracked), "viewer"
    (the MapViewer, still serving, or None)}."""
    from orb_slam2_aruco_tpu_torch.io import ingest, trajectory
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )
    from orb_slam2_aruco_tpu_torch.utils import FrameTimer

    slam = SlamSystem(cfg, device=args.device)
    viewer = None
    if args.viewer >= 0:
        from orb_slam2_aruco_tpu_torch.viz.viewer import MapViewer

        viewer = MapViewer(port=args.viewer, snapshot_every=4)
        print(f"viewer: http://127.0.0.1:{viewer.port}")
    timer = FrameTimer(warmup=5)
    frames_kept = []      # for the optional second pass
    n = 0
    feed = (source if args.no_stage
            else ingest.StagedSource(source, device=args.device))
    for img, ts in feed:
        with timer.frame():
            slam.track_monocular(img, ts=ts)
        if args.two_pass:
            frames_kept.append((img, ts))
        n += 1
        if viewer is not None:
            # controls every frame (cheap); the frame overlay and the map
            # snapshot at ~4 publishes/s worth of frames
            _viewer_tick(viewer, slam, img, publish_frame=(
                n % max(1, int(cfg.camera.fps // 4)) == 0))
        print(f"\rframe {n} [{slam.state.name}] kf={slam.n_keyframes}",
              end="")
        if args.max_frames and n >= args.max_frames:
            break
    print()
    slam.flush()          # drain the frames in flight and the global BA
    print(timer)
    print(f"keyframes: {slam.n_keyframes}  points: "
          f"{int(slam.map.num_points())}  markers: "
          f"{int(slam.map.num_markers())}")
    print(f"stats: {slam.stats}")

    records = [r for r in slam.get_trajectory() if r.state is TrackingState.OK]
    pass1_out = args.out + ".pass1.tum" if args.two_pass else args.out
    trajectory.save_tum(pass1_out, [r.ts for r in records],
                        [r.Rcw for r in records], [r.tcw for r in records])
    print(f"pass-1 trajectory ({len(records)} poses) -> {pass1_out}")
    if args.kf_out:
        _, tss, Rs, ts_ = slam.keyframe_trajectory()
        trajectory.save_tum(args.kf_out, tss, Rs, ts_)
        print(f"keyframe trajectory -> {args.kf_out}")

    out2 = []
    if args.two_pass and frames_kept:
        # localization-only re-run against the final map: every frame's pose
        # is consistent with all loop / GBA corrections, the trajectory the
        # reference's two-pass scheme writes (mono_cvcam.cc:183-266)
        slam.activate_localization_mode()
        timer2 = FrameTimer(warmup=args.chunk)
        B = max(1, args.chunk)
        for i in range(0, len(frames_kept), B):
            ch = frames_kept[i:i + B]
            with timer2.frame(n=len(ch)):
                out2.extend(slam.track_monocular_batch(
                    [c[0] for c in ch], [c[1] for c in ch]))
        ok2 = sum(p is not None for p in out2)
        print(f"second pass (localization-only x{B}): {ok2}/"
              f"{len(frames_kept)} tracked | {timer2}")
        kept = [(ts, p) for (_, ts), p in zip(frames_kept, out2)
                if p is not None]
        trajectory.save_tum(args.out, [ts for ts, _ in kept],
                            [p[0] for _, p in kept], [p[1] for _, p in kept])
        print(f"pass-2 trajectory ({len(kept)} poses) -> {args.out}")

    if args.save_map:
        slam.save_map(args.save_map)
        print(f"map checkpoint -> {args.save_map}")
    return {"system": slam, "frames": n, "pass2": out2, "viewer": viewer}


def main(argv=None):
    from orb_slam2_aruco_tpu_torch.io import ingest

    args = parse_args(argv)
    camc = load_camera(args)
    print(f"camera: fx={camc.fx:.1f} fy={camc.fy:.1f} "
          f"cx={camc.cx:.1f} cy={camc.cy:.1f} {camc.width}x{camc.height} "
          f"dist={camc.dist}")
    source = (ingest.VideoSource(args.video, camc) if args.video else
              ingest.ImageFolderSource(args.images, camc,
                                       times_file=args.times or None))
    out = run(make_config(camc, args), source, args)
    if out["viewer"] is not None:
        out["viewer"].close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
