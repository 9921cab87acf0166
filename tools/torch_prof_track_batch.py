#!/usr/bin/env python3
"""track_batch's variants on the card, chunk by chunk, a null launch
subtracted: the port of tools/prof_track_batch.py.

    python3 tools/torch_prof_track_batch.py [--b B] [--reps R] [--map BASE]
                                            [--device cpu] [--small]

On the bench map (data/ref_full.npz, or BASE.npz and its frames from
tools/torch_build_bench_map.py) and a chunk of B frames of the bench
sweep (B = 16; 2 with --small), times

  null                    one reduction over the chunk
  frontend                make_frame for every frame of the chunk (a
                          Python loop: the port's chunk path builds its
                          frames one by one, pipeline/tracking.py:592)
  track_batch scan        tracking.track_batch in the configuration's
                          mode (scan two-stage), from the map's keyframe 0
                          pose with no velocity, frame 0's make_frame as
                          the last frame and no observed points
                          (prof_track_batch.py:64-76)
  track_batch extrap p2   the same with loc_seed_mode "extrapolate"
  track_batch extrap p1   and with loc_extrap_passes 1

Each: the least ms per chunk between CUDA events over R reps (20; 1
with --small) after a warm-up, the host's wall ms beside it, ms per
frame, and ms per frame less the null launch's. Prints the card's name
and power limit first and one JSON object last. Needs a CUDA GPU unless
given --device cpu.
"""

from __future__ import annotations

import dataclasses

from torch_prof_common import (
    chunk,
    counts,
    event_wall_ms,
    measure,
    null_call,
    parser,
    report_chunk,
    scene,
    start,
    track_batch_call,
)

B, REPS = 16, 20
MODES = {
    "scan": {},
    "extrap p2": dict(loc_seed_mode="extrapolate"),
    "extrap p1": dict(loc_seed_mode="extrapolate", loc_extrap_passes=1),
}


def main(argv=None) -> dict:
    import torch

    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.io import checkpoint
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    args = parser(__doc__, map_arg=True, counts=True).parse_args(argv)
    dev, card = start(args.device)
    cfg0, frames, path = scene(dev, args.small, args.map)
    b, reps = counts(args, B, REPS)
    cam = camera_from_config(cfg0.camera, dev)
    state = checkpoint.load_map(path, dev)
    imgs = chunk(frames, b, dev)
    calls = {"frontend": lambda: [make_frame(im, cam, cfg0) for im in imgs]}
    for name, tweaks in MODES.items():
        cfg = cfg0.replace(tracking=dataclasses.replace(cfg0.tracking,
                                                        **tweaks))
        last = make_frame(imgs[0], cam, cfg)
        calls[f"track_batch {name}"] = track_batch_call(
            state, imgs, state.kf_Rcw[0], state.kf_tcw[0], last,
            torch.full_like(last.kp_octave, -1), 0, cam, cfg)
    null = event_wall_ms(null_call(imgs), dev, reps)
    rows = measure(calls, dev, reps)
    minus_null = {k: (v[0] - null[0]) / b for k, v in rows.items()}
    print(f"null {null[0]:.3f} ms; ms per chunk of {b} last (wall beside)",
          flush=True)
    for k, v in minus_null.items():
        print(f"{k:30s}: {v:9.3f} ms/frame minus null", flush=True)
    return report_chunk(rows, b, {"card": card, "small": args.small,
                                  "null_ms": null[0],
                                  "ms_per_frame_minus_null": minus_null})


if __name__ == "__main__":
    main()
