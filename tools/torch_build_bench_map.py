#!/usr/bin/env python3
"""Build the bench scene's map on the card and save it with its frames: the
port of tools/build_bench_map.py.

    python3 tools/torch_build_bench_map.py [--out BASE] [--device cpu]
                                           [--small]

Runs bench.py's SLAM pass (bench_torch.bench_scene's 32-frame sweep at
960x540, pipeline depth 4, through bench_torch.slam_pass) and writes
BASE.npz (SlamSystem.save_map: the format-4 checkpoint the JAX package's
loader reads) and BASE_frames.npz (the uint8 frames under the key
`frames`). BASE defaults to bench_map in the temporary directory. The
localization profilers take it as `--map BASE`; without it they read
data/ref_full.npz, the JAX package's run of the same pass. With --small:
ref_small's configuration and its 12 map frames.

Prints the card's name and power limit first and one JSON object last
(the map's keyframes, points and markers, the pass's slam_fps and
seconds, and the sha256 of the saved map's arrays, which map_digest of
the reloaded map must equal). Needs a CUDA GPU unless given --device cpu.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time

from torch_prof_common import parser, report, scene, start, sync


def map_digest(state) -> str:
    """sha256 over every MapState field's name, dtype, shape and bytes."""
    from orb_slam2_aruco_tpu_torch.worldmap.state import state_to_numpy

    h = hashlib.sha256()
    for name, a in state_to_numpy(state).items():
        h.update(f"{name} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def main(argv=None) -> dict:
    import numpy as np

    import bench_torch

    ap = parser(__doc__)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "bench_map"))
    args = ap.parse_args(argv)
    dev, card = start(args.device)
    cfg, frames, _ = scene(dev, args.small)
    t0 = time.perf_counter()
    system, _, _, _, stats = bench_torch.slam_pass(cfg, frames, dev)
    sync(dev)
    seconds = time.perf_counter() - t0
    system.save_map(args.out + ".npz")
    np.savez_compressed(args.out + "_frames.npz", frames=np.stack(frames))
    st = system.map
    kfs, pts = int(st.kf_valid.sum()), int(st.pt_valid.sum())
    markers = int(st.mk_valid.sum())
    print(f"{args.out}.npz: {kfs} KFs, {pts} points, {markers} markers",
          flush=True)
    return report({}, {"card": card, "small": args.small, "out": args.out,
                       "frames": len(frames), "keyframes": kfs,
                       "points": pts, "markers": markers,
                       "slam_fps": stats["slam_fps"], "seconds": seconds,
                       "digest": map_digest(st)})


if __name__ == "__main__":
    main()
