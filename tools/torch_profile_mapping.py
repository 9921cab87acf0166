#!/usr/bin/env python3
"""Per-stage timing of the keyframe insert (mapping + loop detection) on the
card: the port of tools/profile_mapping.py.

    python3 tools/torch_profile_mapping.py [--device cpu] [--small]

Builds the bench map with bench_torch's scene and SLAM pass (bench.py's
configuration, its 32-frame sweep at pipeline depth 4), then times, on
that map and its last keyframe, each program the insert path runs
(pipeline/system.py's _insert_keyframe, in profile_mapping.py:77-98's
order): triangulate_vs_covisible, cull_points, fuse_duplicates,
update_point_stats, distinctive_descriptors for the keyframe,
aruco_plane_update, the local BA (window, fixed ring, the second pass's
iterations), cull_keyframes and detect_loops, with their total per insert;
then the two global-BA programs of profile_mapping.py:101-107: 2
iterations over every keyframe slot with 8192 points, and over 32 slots
with 2048 points (each capped at the map's capacity).

Each program: the least ms between CUDA events around one call over REPS
runs after a warm-up (host gaps included: the port's programs are many
small launches, some with host reads), less a null launch's. Prints the
card's name and power limit first and one JSON object last. Needs a CUDA
GPU unless given --device cpu.
"""

from __future__ import annotations

from torch_prof_common import event_ms, null_ms, parser, report, scene, start

REPS = 8


def stages(system, cfg):
    """{name: zero-argument callable} of the insert's programs in order,
    then the two global-BA programs, on the system's map."""
    from orb_slam2_aruco_tpu_torch.pipeline import loop_closing, mapping

    st, cam, k = system.map, system.cam, system.last_kf_slot
    m = cfg.map
    insert = {
        "triangulate_vs_covisible": lambda: mapping.triangulate_vs_covisible(
            st, k, cam, cfg, n_neighbors=m.triangulation_neighbors,
            max_new=256),
        "cull_points": lambda: mapping.cull_points(st, m.cull_found_ratio),
        "fuse_duplicates": lambda: mapping.fuse_duplicates(st, k, cam, cfg),
        "update_point_stats": lambda: mapping.update_point_stats(st, cfg),
        "distinctive_descriptors[kf]": lambda: mapping.distinctive_descriptors(
            st, cfg, kf=k),
        "aruco_plane_update": lambda: mapping.aruco_plane_update(st, k, cam,
                                                                 cfg),
        "local BA (window)": lambda: mapping.bundle_adjust(
            st, k, cam, cfg, max_cams=m.local_ba_window,
            max_pts=min(2048, m.max_points),
            iters=cfg.optim.local_ba_iters_second,
            max_fixed=m.local_ba_fixed_ring),
        "cull_keyframes": lambda: mapping.cull_keyframes(st, k, cfg),
        "detect_loops": lambda: loop_closing.detect_loops(
            st, k, min_gap=cfg.loop.min_kfs_between_loops),
    }
    gba = {}
    for what, cams, pts in (("every slot", m.max_keyframes, 8192),
                            ("32 slots", 32, 2048)):
        cams, pts = min(cams, m.max_keyframes), min(pts, m.max_points)
        gba[f"GBA 2 iters, {what}: K={cams} pts={pts}"] = (
            lambda c=cams, p=pts: mapping.bundle_adjust(
                st, k, cam, cfg, max_cams=c, max_pts=p, iters=2,
                window_all=True))
    return insert, gba


def main(argv=None) -> dict:
    import torch

    import bench_torch

    args = parser(__doc__).parse_args(argv)
    dev, card = start(args.device)
    cfg, frames, _ = scene(dev, args.small)
    system = bench_torch.slam_pass(cfg, frames, dev)[0]
    reps = 1 if args.small else REPS
    null = null_ms(torch.as_tensor(frames[0], device=dev), dev, reps)
    insert, gba = stages(system, cfg)
    rows = {name: event_ms(fn, dev, reps) - null
            for name, fn in {**insert, **gba}.items()}
    total = sum(rows[name] for name in insert)
    rows = {**{n: rows[n] for n in insert}, "TOTAL per insert": total,
            **{n: rows[n] for n in gba}}
    print(f"map: {int(system.map.kf_valid.sum())} keyframes, "
          f"{int(system.map.pt_valid.sum())} points, last keyframe slot "
          f"{system.last_kf_slot}; null {null:.3f} ms subtracted",
          flush=True)
    return report(rows, {"card": card, "small": args.small,
                         "null_ms": null, "keyframes":
                         int(system.map.kf_valid.sum()),
                         "ms": rows})


if __name__ == "__main__":
    main()
