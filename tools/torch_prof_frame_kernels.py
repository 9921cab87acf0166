#!/usr/bin/env python3
"""Per-launch device times of the port's kernels in one make_frame, on the
card, from torch.profiler.

    python3 tools/torch_prof_frame_kernels.py [--root DIR] [--downsample N]

Builds frame 0 of the bench reference (data/ref_full.npz) with
orb_slam2_aruco_tpu_torch.pipeline.frontend.make_frame: once to warm up,
WALL_FRAMES times on the host clock (each ending in a synchronize; prints
the median and quartiles), then FRAMES times under the profiler. Prints
the device kernels and copies per frame in all and, for each of the port's
kernels (K1 fast, K2 patches, K3 cc_fused), the launches per frame and the
mean device microseconds of each launch in launch order. It also times K1's
wrapper on the frame's 8 pyramid levels (CUDA events, host time included):
one fast_score_nms_levels call, or, in a package from before it, one
fast_score_nms_cuda call per level. --root imports the package from
another checkout (for example a copy of an earlier commit), so two versions
of the kernels can be compared; the reference data is this checkout's.
--downsample sets
aruco.detect_downsample (the bench's 2, the default configuration's 1).
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import re
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 5
WALL_FRAMES = 20
KERNELS = {"K1": "fast_score_nms_kernel", "K2": "extract_patches_kernel",
           "K3": "cc_"}


def short(name):
    """A kernel's name without its namespace and parameters."""
    m = re.search(r"::(\w+)\(", name)
    return m.group(1) if m else name


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--downsample", type=int, default=2)
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), HERE]
    import chip_smoke
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.ops import fast, image
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    chip_smoke.device_phase()
    print(f"make_frame from {sys.modules[make_frame.__module__].__file__}")
    _, cfg, _, imgs = chip_smoke.load_reference()
    cfg = cfg.replace(aruco=dataclasses.replace(
        cfg.aruco, detect_downsample=args.downsample))
    cam = camera_from_config(cfg.camera)
    img = torch.as_tensor(imgs[0]).to("cuda")
    make_frame(img, cam, cfg)
    torch.cuda.synchronize()
    wall = []
    for _ in range(WALL_FRAMES):
        t0 = time.perf_counter()
        make_frame(img, cam, cfg)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    print(f"make_frame wall time: median {statistics.median(wall) * 1e3:.2f} "
          f"ms, quartiles {statistics.quantiles(wall)[0] * 1e3:.2f}-"
          f"{statistics.quantiles(wall)[2] * 1e3:.2f} ms over {WALL_FRAMES} "
          f"frames (host clock, synchronized)")
    ocfg = cfg.orb
    levels = image.build_pyramid(img.to(torch.float32), ocfg.num_levels,
                                 ocfg.scale_factor)
    t = (ocfg.fast_threshold, ocfg.fast_min_threshold)
    if hasattr(fast, "fast_score_nms_levels"):
        def k1():
            return fast.fast_score_nms_levels(levels, *t)
    else:
        def k1():
            return [fast.fast_score_nms_cuda(lvl, *t) for lvl in levels]
    print(f"K1 wrapper per frame ({len(levels)} levels): "
          f"{chip_smoke.cuda_ms(k1, reps=WALL_FRAMES * 5):.4f} ms (CUDA "
          f"events, median of {WALL_FRAMES * 5} calls)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(FRAMES):
            make_frame(img, cam, cfg)
            torch.cuda.synchronize()
    # make_frame's spans are drawn on the device's timeline too; they are
    # no device work
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    print(f"detect_downsample={args.downsample}: {len(evs) / FRAMES:.1f} "
          f"device kernels and copies per frame")
    for label, key in KERNELS.items():
        mine = [(e.name, e.time_range.end - e.time_range.start)
                for e in evs if key in e.name]
        per = len(mine) // FRAMES
        print(f"{label}: {len(mine)} launches over {FRAMES} frames ({per} "
              f"per frame); {sum(us for _, us in mine) / FRAMES:.2f} device "
              f"us per frame")
        print(f"  kernels {dict(collections.Counter(short(n) for n, _ in mine))}")
        for i in range(per):
            us = [mine[f * per + i][1] for f in range(FRAMES)]
            print(f"  launch {i:2d} {short(mine[i][0]):28s} "
                  f"{statistics.mean(us):9.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
