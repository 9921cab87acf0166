#!/usr/bin/env python3
"""Chunk-level ablation of the localization hot path on the card: the port
of tools/profile_chunk.py.

    python3 tools/torch_profile_chunk.py [--device cpu] [--small]

On the bench map (data/ref_full.npz) and a chunk of CHUNK frames of the
bench sweep (bench.py's configuration, detect_downsample 2), times, in ms
per frame:

  null                  one reduction over the chunk (subtracted from the
                        rest)
  track_batch           SlamSystem._run_chunk from the warm system's
                        state: every frame's make_frame and its tracking
                        cascade
  frontend              make_frame for every frame of the chunk (ORB
                        pyramid + ArUco + BoW), the K3 route
  frontend, plain CC    the same with aruco.use_pallas_cc=False (plain
                        connected components and quad_candidates)
  detector              ops/aruco/detector.detect_markers for every frame,
                        as make_frame calls it (the K3 route)

then the differences: the cascade (track_batch - frontend), ORB + BoW
(frontend - detector) and what the K3 route saves (plain CC - frontend).
Each: the least ms between CUDA events around the chunk's calls over REPS
runs after a warm-up. Prints the card's name and power limit first and
one JSON object last. Needs a CUDA GPU unless given --device cpu.
"""

from __future__ import annotations

import dataclasses

from torch_prof_common import (
    event_ms,
    null_ms,
    parser,
    report,
    scene,
    start,
    warm_system,
)

CHUNK, REPS = 16, 6


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch.ops.aruco import detector
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    args = parser(__doc__).parse_args(argv)
    dev, card = start(args.device)
    cfg, frames, path = scene(dev, args.small)
    chunk, reps = (2, 1) if args.small else (CHUNK, REPS)
    system = warm_system(cfg, frames, path, dev)
    imgs = torch.as_tensor(np.stack(frames[:chunk])).to(dev)
    cam, a = system.cam, cfg.aruco
    plain = cfg.replace(aruco=dataclasses.replace(a, use_pallas_cc=False))

    def detect():
        return [detector.detect_markers(
            im.float(), a.dictionary, max_quads=a.max_quad_candidates,
            adaptive_win=a.adaptive_thresh_win,
            adaptive_c=a.adaptive_thresh_c, min_area=a.min_quad_side_px**2,
            cell_px=a.warp_cell_px, cc_iters=a.cc_iters,
            downsample=a.detect_downsample, refine=False,
            use_pallas_cc=a.use_pallas_cc) for im in imgs]

    null = null_ms(imgs, dev, reps)
    calls = {
        "track_batch (frontend + cascade)": lambda: system._run_chunk(imgs),
        "frontend (K3 route)": lambda: [make_frame(im, cam, cfg)
                                        for im in imgs],
        "frontend (plain CC)": lambda: [make_frame(im, cam, plain)
                                        for im in imgs],
        "detector (K3 route)": detect,
    }
    rows = {name: (event_ms(fn, dev, reps) - null) / chunk
            for name, fn in calls.items()}
    full, fe, fe_plain, det = rows.values()
    rows.update({"cascade (track_batch - frontend)": full - fe,
                 "ORB + BoW (frontend - detector)": fe - det,
                 "K3 route saves (plain - K3)": fe_plain - fe})
    print(f"ms per frame over a chunk of {chunk}; null {null:.3f} ms per "
          f"chunk subtracted", flush=True)
    return report(rows, {"card": card, "small": args.small, "chunk": chunk,
                         "null_ms": null, "ms_per_frame": rows})


if __name__ == "__main__":
    main()
