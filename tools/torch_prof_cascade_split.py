#!/usr/bin/env python3
"""Stage-level split of the port's tracking cascade on the card: the port of
tools/prof_cascade_split.py.

    python3 tools/torch_prof_cascade_split.py

Times, over one chunk of CHUNK frames of bench_torch's scene (the bench's
960x540 sweep, frames 0 to CHUNK - 1) against data/ref_full.npz's map (the
JAX depth-4 map of that sweep): the frontend (make_frame per frame), stage 1
(`pipeline/tracking._cascade_seed` per frame, each seeded with the previous
frame's pose, the last frame fixed at frame 0 as the JAX tool fixes it,
branch reads included), stage 2 (`_cascade_refine` per frame on stage 1's
results) and stage 2's parts: `local_point_mask`, `track_local_map` (on
local_point_mask's candidates) and the 4x10 pose LM `_optimize`. Each
stage is a run of Python calls over the chunk, as the port's per-frame and
chunked paths issue them.

For each stage: ms per chunk and per frame from CUDA events around the
stage (the minimum of REPS runs after a warm-up, less the same measurement
of a null launch), and, from one torch.profiler trace of the device during
one more run of the stage, the device kernels and copies per frame and
their summed device ms per frame.
Prints the card's name and power limit first and one JSON object last.
Needs a CUDA GPU.
"""

from __future__ import annotations

import collections
import json
import os
import sys

from torch_prof_common import HERE, event_ms, start

CHUNK = 16
REPS = 8


def stages(state, imgs, cam, cfg, ref_kf):
    """{name: zero-argument callable} of the stages in order, each on the
    inputs the stage before it produced (computed here once)."""
    import torch

    from orb_slam2_aruco_tpu_torch.pipeline import tracking
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    frames = [make_frame(im, cam, cfg) for im in imgs]
    lastf = frames[0]
    last_obs = torch.full_like(lastf.kp_octave, -1)
    R0, t0 = state.kf_Rcw[0], state.kf_tcw[0]

    def stage1():
        out, (Rl, tl) = [], (R0, t0)
        for frame in frames:
            seed = tracking._cascade_seed(
                state, frame, Rl, tl, Rl, tl, lastf.kp_uv, lastf.desc,
                last_obs, lastf.kp_valid, lastf.kp_octave, lastf.kp_angle,
                ref_kf, cam, cfg, seed_budget=True)
            Rl, tl = seed[0].Rcw, seed[0].tcw
            out.append(seed)
        return out

    seeds = stage1()
    kmax = cfg.tracking.max_local_keyframes
    masks = [tracking.local_point_mask(state, s[0].obs_point, kmax)[0]
             for s in seeds]
    return collections.OrderedDict([
        ("null", lambda: imgs.float().sum()),
        ("frontend (make_frame)",
         lambda: [make_frame(im, cam, cfg) for im in imgs]),
        ("stage 1 _cascade_seed", stage1),
        ("stage 2 _cascade_refine", lambda: [
            tracking._cascade_refine(state, f, *s, ref_kf, cam, cfg)
            for f, s in zip(frames, seeds)]),
        ("  local_point_mask", lambda: [
            tracking.local_point_mask(state, s[0].obs_point, kmax)
            for s in seeds]),
        ("  track_local_map", lambda: [
            tracking.track_local_map(state, f, s[1], s[0].Rcw, s[0].tcw,
                                     s[0].obs_point, cam, cfg, old=s[2],
                                     pt_candidates=m)
            for f, s, m in zip(frames, seeds, masks)]),
        ("    _optimize (4x10 LM)", lambda: [
            tracking._optimize(state, f, s[1], s[0].Rcw, s[0].tcw,
                               s[0].obs_point, cam, cfg, old=s[2])
            for f, s in zip(frames, seeds)]),
    ])


def device_work(fn):
    """(device kernels and copies, their summed device ms) of one fn(),
    from bench_torch.device_spans (a torch.profiler trace of the device,
    read raw); (None, None) when the trace holds no device work."""
    import bench_torch

    _, spans, _ = bench_torch.device_spans(fn, "cuda")
    if not spans:
        return None, None
    return len(spans), sum(b - a for a, b in spans) / 1e6


def main() -> int:
    import numpy as np
    import torch

    import bench_torch
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.io import checkpoint

    dev, smi = start("cuda")
    cfg, frames = bench_torch.bench_scene(dev)
    state = checkpoint.load_map(
        os.path.join(HERE, "orb_slam2_aruco_tpu_torch", "data",
                     "ref_full.npz"), dev)
    cam = camera_from_config(cfg.camera, dev)
    imgs = torch.as_tensor(np.stack(frames[:CHUNK])).to(dev)
    ref_kf = torch.zeros((), dtype=torch.int64, device=dev)
    rows = {}
    for name, fn in stages(state, imgs, cam, cfg, ref_kf).items():
        ms = event_ms(fn, dev, REPS)
        n, dev_ms = device_work(fn)
        rows[name] = dict(ms=ms, kernels=n, device_ms=dev_ms)
    null = rows.pop("null")
    print(f"{'stage':28s} {'ms/chunk':>9s} {'ms/frame':>9s} "
          f"{'kernels/frame':>14s} {'device ms/frame':>16s}   (null "
          f"{null['ms']:.3f} ms subtracted)", flush=True)
    for name, r in rows.items():
        r["ms"] -= null["ms"]
        kf = "not measured" if r["kernels"] is None else (
            f"{r['kernels'] / CHUNK:.1f}")
        dm = "not measured" if r["device_ms"] is None else (
            f"{r['device_ms'] / CHUNK:.3f}")
        print(f"{name:28s} {r['ms']:9.2f} {r['ms'] / CHUNK:9.3f} "
              f"{kf:>14s} {dm:>16s}", flush=True)
    print(json.dumps({"card": smi, "chunk": CHUNK, "null_ms": null["ms"],
                      "stages": {k.strip(): v for k, v in rows.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
