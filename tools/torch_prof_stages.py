#!/usr/bin/env python3
"""The frontend's stages one at a time on the card: the port of
tools/prof_stages.py.

    python3 tools/torch_prof_stages.py [--b B] [--reps R] [--device cpu]
                                       [--small]

On the 8 frames (B) prof_stages.py renders (bench.py's 960x540 camera, 4
markers of the bench world, a 5 cm pan a frame; with --small 2 of
ref_small's map frames, at its configuration), times per frame:

  pyramid                           the 8-level pyramid
  pyramid+FAST                      + K1 over every level and the
                                    per-level corner selection
  pyramid+FAST+blur+angles+BRIEF    + the blur, K2 and the descriptors,
                                    as make_frame runs them
  aruco adaptive_threshold          the detector's threshold
  aruco thresh+CC+quads             + the quad proposal with the plain
                                    connected components
                                    (quad_candidates, prof_stages.py:89)
  aruco full detect (no refine)     detect_markers as make_frame calls
                                    it (the K3 route)

Each: the least ms between CUDA events around the frames' calls over the
R reps (8; 1 with --small) after a warm-up, less a null launch's, per
frame; the host's wall ms beside it. Prints the card's name and power
limit first and one JSON object last. Needs a CUDA GPU unless given
--device cpu.
"""

from __future__ import annotations

from torch_prof_common import (
    chunk,
    columns,
    counts,
    detect,
    detect_upto,
    event_wall_ms,
    measure,
    null_call,
    orb_upto,
    pan_frames,
    parser,
    report,
    scene,
    start,
)

FRAMES, REPS = 8, 8


def main(argv=None) -> dict:
    args = parser(__doc__, counts=True).parse_args(argv)
    dev, card = start(args.device)
    cfg, frames, _ = scene(dev, args.small)
    n, reps = counts(args, FRAMES, REPS)
    if not args.small:
        frames = pan_frames(cfg, 4, n)
    imgs = chunk(frames, n, dev)
    grays = [im.float() for im in imgs]
    a = cfg.aruco
    calls = {
        "pyramid": lambda: [orb_upto(im, cfg, "pyramid") for im in imgs],
        "pyramid+FAST": lambda: [orb_upto(im, cfg, "fast") for im in imgs],
        "pyramid+FAST+blur+angles+BRIEF": lambda: [
            orb_upto(im, cfg, "describe") for im in imgs],
        "aruco adaptive_threshold": lambda: [
            detect_upto(g, a, "thresh") for g in grays],
        "aruco thresh+CC+quads": lambda: [
            detect_upto(g, a, "quads", fused=False) for g in grays],
        "aruco full detect (no refine)": lambda: [
            detect(g, a, refine=False) for g in grays],
    }
    null = event_wall_ms(null_call(imgs), dev, reps)
    rows = measure(calls, dev, reps, null, per=n)
    ms, wall = columns(rows)
    print(f"ms per frame over {n} frames; null {null[0]:.3f} ms subtracted",
          flush=True)
    return report(rows, {"card": card, "small": args.small, "frames": n,
                         "null_ms": null[0], "ms_per_frame": ms,
                         "wall_ms_per_frame": wall})


if __name__ == "__main__":
    main()
