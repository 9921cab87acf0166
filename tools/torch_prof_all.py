#!/usr/bin/env python3
"""Every stage of the per-frame path and of the keyframe insert, timed on
the card in one process: the port of tools/prof_tpu_all.py (which times
the JAX package on a TPU; this tool runs no TPU).

    python3 tools/torch_prof_all.py [--reps R] [--b B] [--out PATH]
                                    [--map BASE] [--device cpu] [--small]

Against the bench map (data/ref_full.npz, the JAX package's run of
bench.py's SLAM pass; or BASE.npz and its frames from
tools/torch_build_bench_map.py) and the bench sweep's frames at bench.py's
configuration (960x540, 1000 features, detect_downsample 2), times in
prof_tpu_all.py's order (:98-236):

  null launch                        one reduction over a frame
  frontend stages (one frame)        pyramid; + K1 and the corner
                                     selection; + blur, K2, angles and
                                     BRIEF; the ArUco detector with
                                     refinement (K3 route); all of
                                     make_frame (+ BoW)
  track_full                         the tracking cascade on a frame made
                                     beforehand, from the warm system's
                                     last frame and pose
  frame step                         make_frame + track_full
                                     (tracking.track_full_img)
  track_batch chunk=B                the localization chunk (B = 16; 2
                                     with --small) from that last frame,
                                     no velocity; and per frame
  mapping and loop stages            at prof_tpu_all.py's sizes, on the
                                     map's newest keyframe:
                                     triangulate_vs_covisible (top-20),
                                     cull_points, fuse_duplicates,
                                     update_point_stats,
                                     distinctive_descriptors, aruco_plane_
                                     update, the local BA (8 cameras + 8
                                     fixed, 2048 points, 10 iterations),
                                     cull_keyframes, detect_loop_by_marker,
                                     detect_loop_by_bow

The warm system is the map loaded in localization mode after one tracked
frame. Each stage: the
least ms between CUDA events around one call over R runs (10; 1 with
--small) after a warm-up, with the host's wall ms beside it; rows are not
net of the null launch (its row is the floor every call pays). Prints the
card's name and power limit first, then the table as Markdown and one
JSON object last; with --out, writes the Markdown table to PATH (no
file by default). Needs a CUDA GPU unless given --device cpu.
"""

from __future__ import annotations

import os

from torch_prof_common import (
    HERE,
    chunk,
    columns,
    counts,
    detect,
    measure,
    null_call,
    orb_upto,
    parser,
    report,
    scene,
    start,
    track_batch_call,
    warm_system,
)

REPS, CHUNK = 10, 16


def newest_keyframe(state) -> int:
    """The valid keyframe slot inserted last (the largest kf_seq)."""
    import torch

    return int(torch.where(state.kf_valid, state.kf_seq, -1).argmax())


def stages(system, cfg, frames, dev, b):
    """{row name: zero-argument call} in prof_tpu_all.py's order."""
    import torch

    from orb_slam2_aruco_tpu_torch.pipeline import (
        loop_closing,
        mapping,
        tracking,
    )
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    st, cam, m = system.map, system.cam, cfg.map
    img = chunk(frames, 1, dev)[0]
    gray = img.float()
    f0 = make_frame(torch.as_tensor(frames[8 % len(frames)]).to(dev), cam,
                    cfg)
    lf, (Rl, tl), lobs = system.last_frame, system.last_pose, system.last_obs
    ref = torch.as_tensor(system.ref_kf, device=dev)
    last = (Rl, tl, Rl, tl, lf.kp_uv, lf.desc, lobs, lf.kp_valid,
            lf.kp_octave, lf.kp_angle, ref, cam, cfg)
    k = newest_keyframe(st)
    gap = cfg.loop.min_kfs_between_loops
    return {
        "null launch": null_call(img),
        "frontend: pyramid": lambda: orb_upto(img, cfg, "pyramid"),
        "frontend: pyramid+FAST": lambda: orb_upto(img, cfg, "fast"),
        "frontend: pyramid+FAST+blur+BRIEF": lambda: orb_upto(
            img, cfg, "describe"),
        "frontend: aruco detect (full, refine)": lambda: detect(
            gray, cfg.aruco, refine=True),
        "frontend: make_frame (all of the above + BoW)": lambda: make_frame(
            img, cam, cfg),
        "track_full (cascade, pre-made frame)": lambda: tracking.track_full(
            st, f0, *last),
        "frame step: make_frame + track_full": lambda: (
            tracking.track_full_img(st, img, *last)),
        f"track_batch chunk={b} (localization)": track_batch_call(
            st, chunk(frames, b, dev), Rl, tl, lf, lobs, system.ref_kf, cam,
            cfg),
        "mapping: triangulate_vs_covisible (top-20)": lambda: (
            mapping.triangulate_vs_covisible(
                st, k, cam, cfg, n_neighbors=m.triangulation_neighbors,
                max_new=256)),
        "mapping: cull_points": lambda: mapping.cull_points(
            st, m.cull_found_ratio),
        "mapping: fuse_duplicates": lambda: mapping.fuse_duplicates(
            st, k, cam, cfg),
        "mapping: update_point_stats": lambda: mapping.update_point_stats(
            st, cfg),
        "mapping: distinctive_descriptors": lambda: (
            mapping.distinctive_descriptors(st, cfg)),
        "mapping: aruco_plane_update": lambda: mapping.aruco_plane_update(
            st, k, cam, cfg),
        "mapping: local BA (8 cams + 8 fixed ring, 2048 pts, 10 it)": (
            lambda: mapping.bundle_adjust(
                st, k, cam, cfg, max_cams=m.local_ba_window,
                max_pts=min(2048, m.max_points),
                iters=cfg.optim.local_ba_iters_second,
                max_fixed=m.local_ba_fixed_ring)),
        "mapping: cull_keyframes": lambda: mapping.cull_keyframes(st, k, cfg),
        "loop: detect_loop_by_marker": lambda: (
            loop_closing.detect_loop_by_marker(st, k, min_gap=gap)),
        "loop: detect_loop_by_bow": lambda: loop_closing.detect_loop_by_bow(
            st, k, min_gap=gap),
    }


def markdown(rows, cfg, card, source):
    """prof_tpu_all.py's table (:240-259) with the card in its header."""
    lines = [
        "# torch_prof_all: per-stage timings (flagship "
        f"{cfg.camera.width}x{cfg.camera.height} / {cfg.orb.num_features} "
        f"feats / {cfg.map.max_keyframes} KF map)",
        "",
        f"Device: {card}. Measured by `tools/torch_prof_all.py` against "
        f"{source}: each row is the least time between CUDA events around "
        "one call (the host's gaps between the call's many launches "
        "included), with the host's wall time to the call's last event "
        "beside it; the `null launch` row is the floor every call pays. "
        "The mapping rows are what one keyframe insert runs.",
        "",
        "| stage | ms/call (events) | wall ms |",
        "|---|---|---|",
    ]
    lines += [f"| {name} | {ev:.3f} | {wall:.3f} |"
              for name, (ev, wall) in rows.items()]
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    ap = parser(__doc__, map_arg=True, counts=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev, card = start(args.device)
    cfg, frames, path = scene(dev, args.small, args.map)
    b, reps = counts(args, CHUNK, REPS)
    system = warm_system(cfg, frames, path, dev)
    source = f"`{os.path.relpath(path, HERE)}`"
    rows = {}
    for name, (ev, wall) in measure(stages(system, cfg, frames, dev, b),
                                    dev, reps).items():
        rows[name] = (ev, wall)
        if name.startswith("track_batch chunk"):
            rows["track_batch per frame"] = (ev / b, wall / b)
    table = markdown(rows, cfg, card, source)
    print(table, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table)
    ms, wall = columns(rows)
    st = system.map
    return report({}, {"card": card, "small": args.small, "b": b,
                         "reps": reps, "out": args.out,
                         "keyframes": int(st.kf_valid.sum()),
                         "points": int(st.pt_valid.sum()), "ms": ms,
                         "wall_ms": wall})


if __name__ == "__main__":
    main()
