#!/usr/bin/env python3
"""The ORB pipeline's sub-stages on the card, cumulative: the port of
tools/prof_orb_split.py.

    python3 tools/torch_prof_orb_split.py [--b B] [--reps R] [--device cpu]
                                          [--small]

On B = 16 frames of the bench sweep (bench.py's configuration; with
--small 2 of ref_small's map frames, at its configuration), times make_frame's
ORB part up to each step in prof_orb_split.py's order (:43-82):

  upto pyramid    the 8-level pyramid
  upto blur       + the Gaussian blur of every level
  upto fast       + K1 over every level and the per-level corner selection
  upto patches    + K2: the 32x32 patches of every level in one launch
  upto angles     + the IC angles from the patches
  upto describe   + the steered BRIEF descriptors

Each is a Python loop over the frames: the least ms per chunk between
CUDA events over R reps (15; 1 with --small) after a warm-up, less a
null launch's, with the host's wall ms beside it, and ms per frame.
Prints the card's name and power limit first and one JSON object last.
Needs a CUDA GPU unless given --device cpu.
"""

from __future__ import annotations

from torch_prof_common import (
    chunk,
    counts,
    event_wall_ms,
    measure,
    null_call,
    orb_upto,
    parser,
    report_chunk,
    scene,
    start,
)

B, REPS = 16, 15
ORDER = ("pyramid", "blur", "fast", "patches", "angles", "describe")


def main(argv=None) -> dict:
    args = parser(__doc__, counts=True).parse_args(argv)
    dev, card = start(args.device)
    cfg, frames, _ = scene(dev, args.small)
    b, reps = counts(args, B, REPS)
    imgs = chunk(frames, b, dev)
    calls = {f"upto {stage}": (lambda s=stage: [
        orb_upto(im, cfg, s, order=ORDER) for im in imgs]) for stage in ORDER}
    null = event_wall_ms(null_call(imgs), dev, reps)
    print(f"null {null[0]:.3f} ms subtracted; ms per chunk of {b} last "
          f"(wall beside)", flush=True)
    return report_chunk(measure(calls, dev, reps, null), b, {
        "card": card, "small": args.small, "null_ms": null[0]})


if __name__ == "__main__":
    main()
