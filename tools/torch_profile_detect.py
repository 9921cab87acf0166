#!/usr/bin/env python3
"""The ArUco detector's sub-stages on the card with the fused CC route
(K3), cumulative: the port of tools/profile_detect.py.

    python3 tools/torch_profile_detect.py [--b B] [--reps R] [--device cpu]
                                          [--small]

On the 16 frames (B) profile_detect.py renders (bench.py's 960x540 camera and
8-marker world, a 5 cm pan a frame; with --small 2 of ref_small's map
frames, at its configuration), times the detector up to each step
(profile_detect.py:35-77):

  thresh                 the adaptive threshold
  thresh+K3 CC+quads     + the majority downsample by detect_downsample and
                         quad_candidates_fused (K3, one launch per frame)
  +decode                + decode_quads
  +refine (full)         + refine_corners_lines of every quad

Each is a Python loop over the frames: the median ms per chunk between
CUDA events of R runs (6; 1 with --small) after a warm-up, as the JAX tool
takes the median, with the host's wall ms beside it, and ms per frame.
Prints the card's name and power limit first and one JSON object last.
Needs a CUDA GPU unless given --device cpu.
"""

from __future__ import annotations

import statistics

from torch_prof_common import (
    DETECT_STAGES,
    chunk,
    counts,
    detect_upto,
    measure,
    pan_frames,
    parser,
    report_chunk,
    scene,
    start,
)

B, REPS = 16, 6
NAMES = dict(zip(DETECT_STAGES, ("thresh", "thresh+K3 CC+quads", "+decode",
                                 "+refine (full)")))


def main(argv=None) -> dict:
    args = parser(__doc__, counts=True).parse_args(argv)
    dev, card = start(args.device)
    cfg, frames, _ = scene(dev, args.small)
    b, reps = counts(args, B, REPS)
    if not args.small:
        frames = pan_frames(cfg, 8, b)
    grays = [im.float() for im in chunk(frames, b, dev)]
    calls = {NAMES[s]: (lambda s=s: [detect_upto(g, cfg.aruco, s)
                                     for g in grays]) for s in DETECT_STAGES}
    print(f"median ms per chunk of {b} last (wall beside)", flush=True)
    return report_chunk(measure(calls, dev, reps, agg=statistics.median), b,
                        {"card": card, "small": args.small})


if __name__ == "__main__":
    main()
