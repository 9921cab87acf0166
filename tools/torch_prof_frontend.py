#!/usr/bin/env python3
"""The frontend as separate pieces on the card: the port of
tools/prof_frontend.py.

    python3 tools/torch_prof_frontend.py [--b B] [--reps R] [--device cpu]
                                         [--small]

On B = 16 frames of the bench sweep (bench.py's configuration; with
--small 2 of ref_small's map frames, at its configuration), times per
chunk and per frame:

  full make_frame            pipeline/frontend.make_frame of every frame
  ORB pyramid+descr only     its ORB part: pyramid, K1 and the corner
                             selection, blur, K2, angles, descriptors
  BoW only                   worldmap/retrieval.bow_vector of those
                             descriptors
  ArUco detect (no refine)   detect_markers as make_frame calls it (the
                             K3 route)
  refine top-16              refine_corners_lines of the first
                             max_markers_per_frame quads of that detection

Each is a Python loop over the frames (the port's chunk path builds its
frames one by one): the least ms between CUDA events over R reps (20;
1 with --small) after a warm-up, less a null launch's, with the host's
wall ms beside it. Prints the card's name and power limit first and one
JSON object last. Needs a CUDA GPU unless given --device cpu.
"""

from __future__ import annotations

from torch_prof_common import (
    chunk,
    counts,
    detect,
    event_wall_ms,
    measure,
    null_call,
    orb_upto,
    parser,
    report_chunk,
    scene,
    start,
)

B, REPS = 16, 20


def main(argv=None) -> dict:
    import torch

    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.ops import image
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame
    from orb_slam2_aruco_tpu_torch.worldmap.retrieval import bow_vector

    args = parser(__doc__, counts=True).parse_args(argv)
    dev, card = start(args.device)
    cfg, frames, _ = scene(dev, args.small)
    b, reps = counts(args, B, REPS)
    imgs = chunk(frames, b, dev)
    cam = camera_from_config(cfg.camera, dev)
    a, r = cfg.aruco, cfg.retrieval

    def orb_only(im):
        have = orb_upto(im, cfg, "describe")
        return (torch.cat(have["describe"]),
                torch.cat([kp.valid for kp in have["fast"]]))

    def det_only(im):
        return detect(image.to_gray(im), a, refine=False)

    desc_valid = [orb_only(im) for im in imgs]
    top = [det_only(im).corners[:a.max_markers_per_frame] for im in imgs]
    calls = {
        "full make_frame": lambda: [make_frame(im, cam, cfg) for im in imgs],
        "ORB pyramid+descr only": lambda: [orb_only(im) for im in imgs],
        "BoW only": lambda: [bow_vector(d, v, r.num_words, r.proto_seed)
                             for d, v in desc_valid],
        "ArUco detect (no refine)": lambda: [det_only(im) for im in imgs],
        "refine top-16": lambda: [detector.refine_corners_lines(
            image.to_gray(im), c, n_samples=a.refine_samples,
            search_r=a.refine_radius, n_search=a.refine_search)
            for im, c in zip(imgs, top)],
    }
    null = event_wall_ms(null_call(imgs), dev, reps)
    print(f"null {null[0]:.3f} ms subtracted; ms per chunk of {b} last "
          f"(wall beside)", flush=True)
    return report_chunk(measure(calls, dev, reps, null), b, {
        "card": card, "small": args.small, "null_ms": null[0]})


if __name__ == "__main__":
    main()
