"""Monocular SLAM demo on a synthetic marker sequence, on the card.

Port of examples/mono_synthetic.py, the equivalent of the reference's
example binaries (Examples/Monocular/mono_cvcam.cc and mono_marker.cc): run
SLAM over a rendered marker wall, print per-frame timing statistics
(median / mean, as mono_marker.cc:279-287), optionally run a second
localization-only pass (the ActivateLocalizationMode two-pass scheme,
mono_cvcam.cc:152-176), save the trajectory in TUM format and the map as a
checkpoint, and report the ATE against the ground truth.

    python -m orb_slam2_aruco_tpu_torch.examples.mono_synthetic \\
        --frames 40 --out traj.tum [--two-pass] [--save-map map.npz] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="The JAX example's --save-views (frame and map overlay PNGs) "
               "is not ported: it needs the viewer, ROADMAP.md item 10.")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", type=str, default="trajectory.tum")
    ap.add_argument("--dict", type=str, default="ARUCO")
    ap.add_argument("--marker-size", type=float, default=0.165)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--two-pass", action="store_true",
                    help="second localization-only pass like mono_cvcam")
    ap.add_argument("--save-map", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (the card unless told otherwise)")
    ap.add_argument("--trace", type=str, default="",
                    help="torch.profiler trace dir (Chrome trace, Perfetto)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames per track_batch call in the second pass")
    args = ap.parse_args(argv)

    from orb_slam2_aruco_tpu_torch.config import CameraConfig, SlamConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic, trajectory
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )
    from orb_slam2_aruco_tpu_torch.utils import FrameTimer, device_trace

    camc = CameraConfig(
        fx=args.width * 0.52, fy=args.width * 0.52,
        cx=args.width / 2.0, cy=args.height / 2.0,
        dist=(0, 0, 0, 0, 0), width=args.width, height=args.height,
    )
    cfg = SlamConfig().replace(camera=camc)
    cfg = cfg.replace(
        orb=cfg.orb.__class__(num_features=args.features),
        aruco=cfg.aruco.__class__(dictionary=args.dict,
                                  marker_size=args.marker_size),
    )

    print(f"rendering {args.frames} frames ...")
    world = synthetic.build_world(
        [3, 17, 42, 99, 7, 23, 55, 88], dict_name=args.dict,
        marker_size=args.marker_size, px_per_m=500.0, spacing=0.6, grid_cols=4,
    )
    poses = []
    for i in range(args.frames):
        x = 0.5 + 0.8 * i / args.frames
        yaw = 0.1 * np.sin(2 * np.pi * i / args.frames)
        poses.append(
            synthetic.look_at_plane_pose((x, 0.3), 2.0, yaw=yaw, pitch=0.04))
    frames = [synthetic.render_view(world, camc, R, t) for R, t in poses]

    slam = SlamSystem(cfg, device=args.device)
    timer = FrameTimer(warmup=5)
    with device_trace(args.trace or None):
        for i, img in enumerate(frames):
            with timer.frame():
                slam.track_monocular(img, ts=i / 30.0)
            print(f"\rframe {i + 1}/{len(frames)} [{slam.state.name}]", end="")
    print()

    print(timer)
    print(f"keyframes: {slam.n_keyframes}  map points: "
          f"{int(slam.map.num_points())}  markers: "
          f"{int(slam.map.num_markers())}")
    print(f"stats: {slam.stats}")
    if args.trace:
        print(f"profiler trace -> {args.trace}")

    records = [r for r in slam.get_trajectory() if r.state is TrackingState.OK]
    if args.two_pass:
        slam.activate_localization_mode()
        timer2 = FrameTimer(warmup=args.chunk)
        reloc = []
        B = max(1, args.chunk)
        for i in range(0, len(frames), B):
            ch = frames[i:i + B]
            with timer2.frame(n=len(ch)):
                reloc.extend(slam.track_monocular_batch(
                    ch, [j / 30.0 for j in range(i, i + len(ch))]))
        n_ok = sum(p is not None for p in reloc)
        print(f"second pass (localization-only, chunked x{B}): "
              f"{n_ok}/{len(frames)} tracked | {timer2}")

    trajectory.save_tum(args.out, [r.ts for r in records],
                        [r.Rcw for r in records], [r.tcw for r in records])
    print(f"trajectory ({len(records)} poses) -> {args.out}")

    # ATE against ground truth (SE3 alignment: marker scale is metric)
    ids = [r.frame_id for r in records]
    est_c = trajectory.camera_centers([r.Rcw for r in records],
                                      [r.tcw for r in records])
    gt_c = trajectory.camera_centers([poses[i][0] for i in ids],
                                     [poses[i][1] for i in ids])
    ate = trajectory.ate_rmse(est_c, gt_c, align=True, with_scale=False)
    print(f"ATE RMSE vs ground truth: {ate * 100:.2f} cm")

    if args.save_map:
        slam.save_map(args.save_map)
        print(f"map checkpoint -> {args.save_map}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
