#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives orb_slam2_aruco_tpu_torch's paths — localization against a saved map
and SLAM mode — at the bench configuration (960x540, 1000 ORB features, 8
levels, detect_downsample=2, 256-keyframe / 20000-point / 64-marker map
capacity), in phases:

  1. device   CUDA must be available (no CPU fallback); prints the card's
              name and power limit as nvidia-smi reports them.
  2. build    compiles the four CUDA kernels from kernels/csrc (one nvcc
              per source, all at once).
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes its path gives it on a rendered 960x540 frame: K1
              FAST on the 8 pyramid levels (one launch), K2 patches of all
              8 levels at their keypoint quotas (one launch), K3 connected
              components on the 270x480 half-resolution binary and on the
              540x960 full-resolution one (the default
              detect_downsample=1), K4 one label sweep at both sizes
              (initial labels, and at 270x480 also labels after one
              round). Outputs must be equal (K1: in the unmasked
              interior). Median times from CUDA events, beside each
              kernel's bound and, where one PyTorch call computes the same
              function, that call's time; for each kernel also the kernel
              alone (events around the bare launch), and a torch.profiler
              count that must show one device kernel per K1 frame, K2
              frame, K3 call and K4 sweep.
  4. slice    per-frame localization: SlamSystem.load_map(data/ref_full.npz)
              + track_monocular on the 32 recorded frames (rendered here by
              the port's io/synthetic). States must equal the JAX package's,
              poses within 0.2 deg / 1 cm of its poses, the ATE at most
              max(1.5 x, +5 mm) of its ATE.
  5. quads    the K4 route of the quad proposal,
              quad_candidates(use_pallas_cc=True), on the half-resolution
              binaries of the frames the reference file records: valid and
              score equal to the JAX package's, valid quads equal.
  6. stream   the chunked serving form bench.py times: after one
              relocalizing track_monocular, localize_stream(StagedSource(
              frames, batch=64), chunk=64) in extrapolate mode, two chunks in
              flight, over 128 frames (frame k = recorded frame k % 32).
              Emitted frame ids and OK/None states must equal the JAX
              package's recorded stream, poses within 0.2 deg / 1 cm. Prints
              fps, the median per-chunk latency (bench.py:205-208), host
              syncs per chunk and rewinds; then one more chunk, of
              DEBUG_FRAMES frames, under torch's sync debug mode counts
              every synchronizing call the port makes: at most
              MAX_DEBUG_SYNCS.
  7. slam     SLAM mode (tracking.pipeline_depth 0) from an empty map over
              the 32 frames of the sweep (SlamSystem.track_monocular: two-
              view initialization, tracking, keyframe inserts with the
              whole mapping phase and local BA). Every frame's state, the
              keyframe-insert frames and count equal to the JAX package's
              recorded depth-0 run, poses within 0.5 deg / 2 cm of its
              poses, the valid point count within 5 %, the ATE at most
              max(1.5 x, +5 mm) of its ATE; then the 32 mid-point frames
              localized against the port-built map: states equal to the
              JAX localization against its own map, poses within the same
              limits. Prints SLAM fps after initialization, the per-frame
              frontend / tracking / mapping split, host syncs per frame,
              keyframes, points and BA runs. Then the 32 frames once more
              on a fresh system under torch's sync debug mode, and one
              classic (marker-free) two-view initialization: every
              synchronizing call by site, at most MAX_SLAM_SYNCS and
              MAX_CLASSIC_INIT_SYNCS.
  8. pipe     pipelined SLAM mode at the bench's depth (pipeline_depth 4,
              data/ref_full.npz's own configuration): bench.py's SLAM pass
              (bench.py:128-164) — a warm-up pass, then a timed pass over
              the 32 map frames through StagedSource(batch=4), per-call
              latency, flush and a device synchronize; slam_fps =
              (n - drop) / (sum of latencies + flush), p50, p90 — and the
              same pass at depth 0 on the same frames. The depth-4 run's
              trajectory records (states, poses), the frames whose
              processing created keyframes, the keyframes and their poses,
              the valid points and the ATE held to the JAX package's
              depth-4 run (ref_pipe_*, whose map is the file's map) within
              the SLAM limits; the depth-0 run to ref_slam_* as the slam
              phase holds it. Then save_map, load_map into a new system and
              the 32 mid-point frames localized against it: states equal to
              ref_ok, poses within 0.5 deg / 2 cm of ref_R / ref_t. Then the
              32 frames at depth 4 under the sync debug mode: at most
              MAX_PIPE_SYNCS, printed by site. Last, the port's two-pass
              example (examples/mono_synthetic.py: 40 frames, --two-pass,
              --save-map) must exit 0, write its TUM file and its map and
              print an ATE.
  9. loop     SLAM mode with loop closing and relocalization at the same
              widths and capacities (data/ref_full.npz, ref_loop_*): the
              bench world's markers at the left of a long wall, a pan away
              and back with the map built after frame 18 rigidly displaced
              at frame 32 (synthetic.inject_drift), so the return closes a
              loop by marker: Sim3, essential graph, whole-map fuse and the
              post-loop global BA in slices over more than 32 keyframes
              (the BA's CG branch), drained by keyframe_trajectory(); then
              two black frames, a noise frame, a marker-free frame of the
              away leg (BoW-PnP relocalization), two black frames and a
              start-area frame (marker relocalization). Every state, the
              insert frames, keyframe count, loops (frame, keyframe pair,
              marker or BoW) and the BoW-PnP relocalization equal to the
              JAX package's recorded run, loop Sim3s within 0.5 deg / 2 cm;
              keyframe poses after the drain within 1.7 deg / 17.7 cm and
              the BoW-PnP pose within 0.6 deg / 14.8 cm (twice what one
              float32 ulp moves JAX itself there); valid points within
              5 %; the start <-> end seam error at most max(1.5 x, +5 mm)
              of JAX's and below 0.25 m; the start-area frame relocalized
              by marker (JAX's recorded run loses it, JAX one ulp up
              relocalizes it by marker). Prints fps,
              ms per insert, per GBA slice and per loop correction, and the
              loop frame's ms; then the scene once more under the sync
              debug mode: at most MAX_LOOP_SYNCS calls, printed by site.
 10. report   one {"kernels": [...]} JSON line, the nvidia-smi line, and as
              the last line {"ok": true, "device": {...}}.

Launch counts are zeroed just before each of slice, quads, stream, slam,
pipe (its timed depth-4 pass) and loop and read just after: each must have
launched the kernels of its path (K1-K3 on slice, stream, slam, pipe and
loop, K4 on quads), and K1, K2 and K3 once per frame built.
Any failed phase exits non-zero before the last line is printed.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import linecache
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "orb_slam2_aruco_tpu_torch"
DEVICE = "cuda"

# tolerance of the port against the JAX package's recorded localization
ROT_TOL_DEG = 0.2
TRANS_TOL_M = 0.01
# and against its recorded SLAM run: poses, and the valid point count
SLAM_ROT_TOL_DEG = 0.5
SLAM_TRANS_TOL_M = 0.02
SLAM_POINTS_TOL = 0.05
# the loop scene's drift (tests/test_torch_slice.py LOOP_*): the map built
# after frame LOOP_CUTOFF moved by (so3_exp(LOOP_DRIFT_W), LOOP_DRIFT_T)
# once frame LOOP_INJECT is tracked
LOOP_DRIFT_W = (0.0, -0.06, 0.0)
LOOP_DRIFT_T = (0.65, 0.0, 0.2)
LOOP_INJECT, LOOP_CUTOFF = 32, 18
# and the loop scene's keyframe poses after the global BA's drain and its
# BoW-PnP pose: twice what one float32 ulp moves JAX itself there
# (tools/torch_loop_sensitivity.py: 0.85 deg / 8.85 cm, 0.30 deg / 7.40 cm)
LOOP_KF_ROT_TOL_DEG, LOOP_KF_TRANS_TOL_M = 1.7, 0.177
LOOP_RELOC_ROT_TOL_DEG, LOOP_RELOC_TRANS_TOL_M = 0.6, 0.148

# frames of the two untimed measurements, kept short for the script's time:
# the slice's frontend / tracking split and the stream's sync-debug chunk
SPLIT_FRAMES = 12
DEBUG_FRAMES = 16
# frames of the SLAM split run: the initialization (frame 6) and the
# second insert (frame 13) of the recorded run
SLAM_SPLIT_FRAMES = 16
# synchronizing calls the debug chunk may make: the count when this limit
# was set (a change may remove such calls, never add them). 660 until the
# constants of the per-frame path were made once per device; since then
# the chunk's one control read. Calls the debug mode's own switching
# reports (measured around an empty window) are not the port's.
MAX_DEBUG_SYNCS = 1
# the same for the SLAM run's 32 frames under the debug mode: its 92
# deliberate host reads (tracking.SYNCS) and the plane update's eigh, which
# checks cuSOLVER's error code on the host; and for one classic
# initialization: its 10 SVDs, which do the same
MAX_SLAM_SYNCS = 93
MAX_CLASSIC_INIT_SYNCS = 10
# and for the loop scene's 69 steps under the debug mode: the deliberate
# reads of tracking.SYNCS (the cascade's branch reads, the insert and loop
# detection reads, the Sim3 verdicts, the relocalization candidates and
# gates), the control vectors and the relocalized poses, the plane
# updates' eigh, the RANSAC PnP's SVDs and eigh and the classic Sim3's
# Horn eigh (PERF.md section 5); 777 before the loop closing's element
# writes of Python numbers became masks
MAX_LOOP_SYNCS = 419
# and for the pipelined SLAM run's 32 frames (depth 4) and its flush: the
# cascade's branch reads (50), the initialization's reads (14), the
# deferred point count read at the flush and the plane update's eigh. The
# deferred reads (the control vectors, the cull victim, the loop
# detections) are tracking.HostCopy's event waits, which the debug mode
# does not report; tracking.SYNCS counts them (PERF.md section 5)
MAX_PIPE_SYNCS = 66
# the bench's SLAM pass: depth, frames per staged batch; the example's
# frames
PIPE_DEPTH, PIPE_BATCH = 4, 4
EXAMPLE_FRAMES = 40

KERNEL_META = {
    "fast": ("orb_slam2_aruco_tpu_torch/kernels/csrc/fast.cu",
             "orb_slam2_aruco_tpu/ops/pallas_fast.py:119"),
    "patches": ("orb_slam2_aruco_tpu_torch/kernels/csrc/patches.cu",
                "orb_slam2_aruco_tpu/ops/pallas_patches.py:61"),
    "cc_fused": ("orb_slam2_aruco_tpu_torch/kernels/csrc/cc_fused.cu",
                 "orb_slam2_aruco_tpu/ops/pallas_cc_fused.py:185"),
    "cc_propagate": ("orb_slam2_aruco_tpu_torch/kernels/csrc/cc_propagate.cu",
                     "orb_slam2_aruco_tpu/ops/pallas_cc.py:103"),
}

# the kernels each path must launch
PATH_KERNELS = {
    "slice": ("fast", "patches", "cc_fused"),
    "quads": ("cc_propagate",),
    "stream": ("fast", "patches", "cc_fused"),
    "slam": ("fast", "patches", "cc_fused"),
    "pipe": ("fast", "patches", "cc_fused"),
    "loop": ("fast", "patches", "cc_fused"),
}

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, and float32
# operations/s outside the tensor cores, taken as the 32-bit scalar rate;
# the int32 compares and min/max of K3 and K4 are counted at it too
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# K1 operations per pixel: 16 circle terms x 12 (difference, negation, four
# threshold compares, two subtract-clamp-add chains), four arc-of-9 tests x
# 17 bit operations, the 3x3 NMS and bonus (11)
FAST_OPS_PER_PX = 16 * 12 + 4 * 17 + 11


class PhaseError(Exception):
    pass


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of fn() on the current stream, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_alone_ms(fn, reps=20, warmup=3):
    """Median device milliseconds of the work fn() enqueues, without its
    host time: a device-side sleep keeps the stream busy while the host
    records the first event and enqueues fn, so the events bracket only
    fn's device work. fn should be a bare launch (no allocation)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def one_kernel_per_call(calls, reps=3):
    """One torch.profiler session over `reps` calls of each (label, kernel,
    fn) in `calls`, in turn. Fails unless each call ran exactly one device
    kernel, its `kernel`. Returns {label: mean device microseconds}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _, _, fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, _, fn in calls:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    seen = [(e.name, e.time_range.end - e.time_range.start) for e in evs]
    out = {}
    for k, (label, kernel, _) in enumerate(calls):
        mine = seen[k * reps:(k + 1) * reps]
        if len(seen) != len(calls) * reps or not all(kernel in n
                                                     for n, _ in mine):
            raise PhaseError(
                f"{label}: expected one device kernel '{kernel}' per call; "
                f"the profiler saw {collections.Counter(n for n, _ in seen)} "
                f"over {reps} calls each of {[c[0] for c in calls]}")
        out[label] = statistics.mean(us for _, us in mine)
    return out


def bound(nbytes, ops):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over HBM bandwidth and the operations over the scalar rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_launches(path, counts):
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise PhaseError(f"kernels never launched by the {path} path: "
                         f"{missing} (counts {counts})")


def check_frames_built(path, counts, frames):
    """Each frame built launches K1 once (all 8 levels), K2 once (all 8
    levels) and K3 once."""
    if not counts["fast"] == counts["patches"] == counts["cc_fused"] == frames:
        raise PhaseError(f"the {path} path built {frames} frames but "
                         f"launched K1 {counts['fast']}, K2 "
                         f"{counts['patches']} and K3 {counts['cc_fused']} "
                         f"times (one each per frame)")


def rot_err_deg(Ra, Rb):
    import numpy as np

    # chordal distance |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2)
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, d / (2.0 * np.sqrt(2.0))))))


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false: this smoke "
                         "run needs a CUDA GPU (there is no CPU fallback)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


def build_phase():
    from orb_slam2_aruco_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    for name in build.SIGNATURES:
        build.library(name)
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                phase("build", f"{name}: {line.strip()}")
    phase("build", f"built {sorted(logs)} and loaded all kernels in "
          f"{dt:.1f} s")


def load_reference():
    import numpy as np

    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic

    path = os.path.join(HERE, PKG, "data", "ref_full.npz")
    z = np.load(path)
    ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    cfg = SlamConfig.from_dict(json.loads(str(ref["ref_cfg"])))
    return path, cfg, ref, render(cfg, ref, "ref_loc_params")


def render(cfg, ref, key):
    """uint8 frames of the recorded world at the render parameters
    ref[key] (x, y, distance, yaw, pitch), by the port's io/synthetic."""
    import numpy as np

    from orb_slam2_aruco_tpu_torch.io import synthetic

    w = json.loads(str(ref["ref_world"]))
    world = synthetic.build_world(
        w["marker_ids"], dict_name=cfg.aruco.dictionary,
        marker_size=w["marker_size"], grid_cols=w["grid_cols"],
        spacing=w["spacing"], px_per_m=w["px_per_m"])
    imgs = []
    for x, y, d, yaw, pitch in ref[key]:
        R, t = synthetic.look_at_plane_pose((x, y), d, yaw=yaw, pitch=pitch)
        imgs.append(np.clip(synthetic.render_view(world, cfg.camera, R, t),
                            0, 255).astype(np.uint8))
    return imgs


def quad_binary(img_np, cfg, ds):
    """The quad proposal's input: adaptive threshold + majority downsample
    by ds of a frame, on the card."""
    import torch

    from orb_slam2_aruco_tpu_torch.ops.aruco import detector

    acfg = cfg.aruco
    gray = torch.as_tensor(img_np).to(DEVICE).float()
    binary = detector.adaptive_threshold(gray, acfg.adaptive_thresh_win,
                                         acfg.adaptive_thresh_c)
    return detector.downsample_majority(binary, ds)


def window_union_px(shape, y0, x0, size=32):
    """Pixels covered by the union of size x size windows at (y0, x0)."""
    import numpy as np

    diff = np.zeros((shape[0] + 1, shape[1] + 1), np.int32)
    for y, x in zip(y0, x0):
        diff[y, x] += 1
        diff[y, x + size] -= 1
        diff[y + size, x] -= 1
        diff[y + size, x + size] += 1
    return int((diff.cumsum(0).cumsum(1) > 0).sum())


def kernel_phase(cfg, img_np):
    """Each kernel against its plain version at its path's shapes. Returns
    {name: report dict}; K1 and K2 ms are per frame (8 pyramid levels, one
    launch), K3 per call, K4 per sweep (one launch)."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.ops import (
        cc_fused,
        cc_propagate,
        fast,
        image,
        orb,
    )
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import level_quotas

    ocfg = cfg.orb
    gray = torch.as_tensor(img_np).to(DEVICE).float()
    levels = image.build_pyramid(gray, ocfg.num_levels, ocfg.scale_factor)
    out = {}

    def report(name, err, ms, plain, nbytes, ops, library):
        b_ms, b_by = bound(nbytes, ops)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                         bound_by=b_by, library_ms=library)
        lib = "none" if library is None else f"{library:.4f} ms"
        return (f"{ms:.4f} ms (plain {plain:.4f} ms, bound {b_ms:.5f} ms by "
                f"{b_by}, library {lib})")

    # K1: FAST score + NMS on the 8 levels, one launch
    t_args = (ocfg.fast_threshold, ocfg.fast_min_threshold)
    err = 0.0
    for lvl, a in zip(levels, fast.fast_score_nms_levels(levels, *t_args)):
        b = fast.fast_score_nms_torch(lvl, *t_args)
        torch.cuda.synchronize()
        inner = (slice(3, -3), slice(3, -3))
        if not torch.equal(a[inner], b[inner]):
            n = int((a[inner] != b[inner]).sum())
            raise PhaseError(f"K1 fast differs from its plain version at "
                             f"{n} interior pixels of a {tuple(lvl.shape)} "
                             f"level")
        err = max(err, float((a - b).abs().max()))
    ms = cuda_ms(lambda: fast.fast_score_nms_levels(levels, *t_args))
    plain = cuda_ms(lambda: [fast.fast_score_nms_torch(l, *t_args)
                             for l in levels])
    # the kernel alone: the bare launcher on a prepared level table
    scores = [torch.empty_like(l) for l in levels]
    table = np.array([(l.data_ptr(), o.data_ptr(), *l.shape)
                      for l, o in zip(levels, scores)], dtype=np.int64)
    launch = kernels.build.launcher("fast")
    stream = torch.cuda.current_stream().cuda_stream
    alone = kernel_alone_ms(lambda: launch(table.ctypes.data, len(levels),
                                           *t_args, stream))
    px = sum(l.numel() for l in levels)
    msg = report("fast", err, ms, plain, 8 * px, FAST_OPS_PER_PX * px, None)
    out["fast"]["kernel_ms"] = alone
    phase("kernels", f"K1 fast: equal to plain on {len(levels)} levels "
          f"{[tuple(l.shape) for l in levels]}; per frame (one launch) "
          f"{msg}; kernel alone {alone:.4f} ms")

    # K2: patches of the 8 levels at their keypoint quotas, one launch
    quotas = level_quotas(ocfg.num_features, ocfg.num_levels,
                          ocfg.scale_factor)
    blurred, xys = [], []
    for lvl, q in zip(levels, quotas):
        kp = fast.detect_level(lvl, ocfg.fast_threshold,
                               ocfg.fast_min_threshold,
                               cell_size=ocfg.cell_size, per_cell_k=8,
                               max_kps=q, edge_margin=ocfg.patch_radius + 1)
        blurred.append(image.gaussian_blur(lvl, ocfg.blur_ksize,
                                           ocfg.blur_sigma))
        xys.append(kp.xy)
    ar = torch.arange(32, device=DEVICE)
    gathers = []      # the library yardstick: one advanced-index gather
    nbytes = 0
    for lvl, xy in zip(blurred, xys):
        y0, x0 = orb.patch_corners(lvl.shape, xy)
        yy = y0.long()[:, None, None] + ar[None, :, None]
        xx = x0.long()[:, None, None] + ar[None, None, :]
        gathers.append((lvl, yy, xx))
        nbytes += 4 * (xy.shape[0] * 32 * 32 + window_union_px(
            lvl.shape, y0.cpu().tolist(), x0.cpu().tolist()))
    a = orb.extract_patches_levels(blurred, xys)
    b = orb.extract_patches_levels_torch(blurred, xys)
    c = torch.cat([g[yy, xx] for g, yy, xx in gathers])
    torch.cuda.synchronize()
    if not (torch.equal(a, b) and torch.equal(a, c)):
        raise PhaseError("K2 patches differ from their plain version")
    ms = cuda_ms(lambda: orb.extract_patches_levels(blurred, xys))
    plain = cuda_ms(lambda: orb.extract_patches_levels_torch(blurred, xys))
    library = cuda_ms(lambda: [g[yy, xx] for g, yy, xx in gathers])
    # the kernel alone: the bare launcher on a prepared level table
    table = np.array([(lvl.data_ptr(), xy.data_ptr(), 0, 0, lvl.shape[0],
                       lvl.shape[1], xy.shape[0])
                      for lvl, xy in zip(blurred, xys)], dtype=np.int64)
    launch = kernels.build.launcher("patches")
    stream = torch.cuda.current_stream().cuda_stream
    alone = kernel_alone_ms(lambda: launch(table.ctypes.data, len(blurred),
                                           a.data_ptr(), stream))
    msg = report("patches", 0.0, ms, plain, nbytes, 0, library)
    out["patches"]["kernel_ms"] = alone
    phase("kernels", f"K2 patches: equal to plain and to the gathers for "
          f"quotas {quotas} on levels {[tuple(l.shape) for l in blurred]}; "
          f"per frame (one launch) {msg}; kernel alone {alone:.4f} ms")

    # K3: CC + bbox on the frame's binary at the bench's half resolution
    # (270x480, detect_downsample=2) and at full resolution (540x960, the
    # default detect_downsample=1); each held bit-equal to plain
    k3, binaries = {}, {}
    for ds in (cfg.aruco.detect_downsample, 1):
        binary = binaries[ds] = quad_binary(img_np, cfg, ds)
        H, W = binary.shape
        Hp, Wp = cc_fused.padded_shape(H, W)
        a = cc_fused.cc_fused_cuda(binary)
        b = cc_fused.cc_fused_torch(binary)
        torch.cuda.synchronize()
        if a[3] != b[3] or not all(torch.equal(x, y)
                                   for x, y in zip(a[:3], b[:3])):
            raise PhaseError(f"K3 cc_fused differs from its plain version "
                             f"at {H}x{W}")
        ms = cuda_ms(lambda: cc_fused.cc_fused_cuda(binary))
        plain = cuda_ms(lambda: cc_fused.cc_fused_torch(binary), reps=5)
        fields = torch.empty((2, Hp, Wp, 4), dtype=torch.int32, device=DEVICE)
        outs = torch.empty((3, H, W), dtype=torch.int32, device=DEVICE)
        launch = kernels.build.launcher("cc_fused")
        stream = torch.cuda.current_stream().cuda_stream
        alone = kernel_alone_ms(lambda: launch(
            binary.data_ptr(), H, W, Hp, Wp, fields.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), 3, 2,
            stream))
        # bytes: the binary in, three int32 outputs; operations: 3 rounds x
        # (2 steps x 8 neighbours x 4 fields + 4 scans x 4 fields)
        b_ms, b_by = bound(H * W * (1 + 3 * 4),
                           Hp * Wp * 3 * (2 * 8 * 4 + 4 * 4))
        k3[ds] = dict(ms=ms, kernel_ms=alone, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by)
        phase("kernels", f"K3 cc_fused at {H}x{W} (detect_downsample={ds}, "
              f"padded {Hp}x{Wp}): lab/bw/bh/Wp equal to plain "
              f"({int(binary.sum())} foreground px); per call {ms:.4f} ms, "
              f"kernel alone {alone:.4f} ms; plain {plain:.4f} ms; bound "
              f"{b_ms:.5f} ms by {b_by}; library none")
    out["cc_fused"] = dict(max_abs_err=0.0, library_ms=None,
                           **k3[cfg.aruco.detect_downsample])
    out["cc_fused"]["full_resolution"] = k3[1]

    # K4: one sweep (tile 128, 16 steps) at both sizes on the initial
    # labels and, at 270x480, on the labels after one round (sweep +
    # pointer jump)
    k, tile = 16, 128
    k4, first_labels = {}, {}
    for ds, binary in binaries.items():
        H, W = binary.shape
        labels0 = first_labels[ds] = detector.initial_labels(binary)
        cases = [labels0]
        if ds == cfg.aruco.detect_downsample:
            cases.append(detector.pointer_jump(
                cc_propagate.cc_propagate_torch(labels0, 1, k, tile), H * W))
        for lab in cases:
            a = cc_propagate.cc_propagate_cuda(lab, 1, k, tile)
            b = cc_propagate.cc_propagate_torch(lab, 1, k, tile)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                n = int((a != b).sum())
                raise PhaseError(f"K4 cc_propagate differs from its plain "
                                 f"version at {n} pixels at {H}x{W}")
        ms = cuda_ms(lambda: cc_propagate.cc_propagate_cuda(labels0, 1, k,
                                                            tile))
        plain = cuda_ms(lambda: cc_propagate.cc_propagate_torch(
            labels0, 1, k, tile), reps=5)
        dst = torch.empty_like(labels0)
        launch = kernels.build.launcher("cc_propagate")
        stream = torch.cuda.current_stream().cuda_stream
        g = cc_propagate.exchange_rows(tile, k)
        alone = kernel_alone_ms(lambda: launch(
            labels0.data_ptr(), dst.data_ptr(), H, W, tile, k, k, g, stream))
        tiles = -(-H // tile) * -(-W // tile)
        # bytes: the labels in, the labels out; operations: 8 mins per
        # pixel of each tile's (hb - 2)^2 inner buffer, k steps
        b_ms, b_by = bound(2 * 4 * H * W,
                           tiles * k * (tile + 2 * k - 2) ** 2 * 8)
        k4[ds] = dict(ms=ms, kernel_ms=alone, plain_ms=plain, bound_ms=b_ms,
                      bound_by=b_by)
        phase("kernels", f"K4 cc_propagate at {H}x{W}: equal to plain "
              f"({len(cases)} label sets), {tiles} tiles x 8 CTAs, ghost "
              f"rows traded every {g} steps; per "
              f"sweep {ms:.4f} ms, kernel alone {alone:.4f} ms; plain "
              f"{plain:.4f} ms; bound {b_ms:.5f} ms by {b_by}; library none")
    out["cc_propagate"] = dict(max_abs_err=0.0, library_ms=None,
                               **k4[cfg.aruco.detect_downsample])
    out["cc_propagate"]["full_resolution"] = k4[1]
    binary = binaries[cfg.aruco.detect_downsample]
    acfg = cfg.aruco
    quad_ms = cuda_ms(lambda: detector.quad_candidates(
        binary, acfg.max_quad_candidates,
        min_area=acfg.min_quad_side_px**2 / acfg.detect_downsample**2,
        cc_iters=acfg.cc_iters, use_pallas_cc=True), reps=10)
    phase("kernels", f"one whole quad_candidates(use_pallas_cc=True) at "
          f"{tuple(binary.shape)}: {quad_ms:.4f} ms")

    prof = one_kernel_per_call(
        [("K1 frame", "fast_score_nms",
          lambda: fast.fast_score_nms_levels(levels, *t_args)),
         ("K2 frame", "extract_patches_kernel",
          lambda: orb.extract_patches_levels(blurred, xys))]
        + [(f"K3 {tuple(b.shape)}", "cc_fused_kernel",
            lambda b=b: cc_fused.cc_fused_cuda(b))
           for b in binaries.values()]
        + [(f"K4 sweep {tuple(lab.shape)}", "cc_propagate",
            lambda lab=lab: cc_propagate.cc_propagate_cuda(lab, 1, k, tile))
           for lab in first_labels.values()])
    phase("kernels", f"profiler: one device kernel per K1 frame, K2 frame, "
          f"K3 call and K4 sweep; mean device us "
          f"{({name: round(us, 2) for name, us in prof.items()})}")
    return out


def slice_phase(path, cfg, ref, imgs):
    """Per-frame localization: load the map, localize the 32 frames.
    Returns the kernel launch counts of this run."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.io import trajectory
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    system = SlamSystem(cfg, device=DEVICE)
    system.load_map(path)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tracking.SYNCS["count"] = 0
    frame_s, poses, states = [], [], []
    t_all = time.perf_counter()
    for i, img in enumerate(imgs):
        t0 = time.perf_counter()
        p = system.track_monocular(img, ts=i / 30.0)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        poses.append(p)
        states.append(system.state is TrackingState.OK)
    total = time.perf_counter() - t_all
    counts = dict(kernels.launch_counts)
    syncs = tracking.SYNCS["count"]
    phase("slice", f"kernel launches in the per-frame path: {counts}")
    check_launches("slice", counts)
    check_frames_built("slice", counts, len(imgs))

    ref_ok = ref["ref_ok"].astype(bool)
    if list(ref_ok) != states:
        raise PhaseError(f"OK/LOST states differ from the JAX run: port "
                         f"{states} vs JAX {list(ref_ok)}")
    worst_r = worst_t = 0.0
    for i, p in enumerate(poses):
        if p is None:
            continue
        worst_r = max(worst_r, rot_err_deg(p[0], ref["ref_R"][i]))
        worst_t = max(worst_t, float(np.linalg.norm(
            np.asarray(p[1], np.float64) - ref["ref_t"][i])))
    if worst_r > ROT_TOL_DEG or worst_t > TRANS_TOL_M:
        raise PhaseError(f"poses off the JAX run: {worst_r:.4f} deg, "
                         f"{worst_t * 100:.4f} cm (limits {ROT_TOL_DEG} deg,"
                         f" {TRANS_TOL_M * 100} cm)")
    ok_idx = [i for i, p in enumerate(poses) if p is not None]
    est_c = trajectory.camera_centers([poses[i][0] for i in ok_idx],
                                      [poses[i][1] for i in ok_idx])
    gt_c = trajectory.camera_centers(ref["ref_gt_R"][ok_idx],
                                     ref["ref_gt_t"][ok_idx])
    ate = trajectory.ate_rmse(est_c, gt_c, align=True, with_scale=False)
    ref_ate = float(ref["ref_ate"])
    limit = max(1.5 * ref_ate, ref_ate + 0.005)
    if not np.isfinite(ate) or ate > limit:
        raise PhaseError(f"ATE {ate:.5f} m above {limit:.5f} m (JAX "
                         f"{ref_ate:.5f} m)")
    steady = frame_s[2:]
    phase("slice", f"{len(imgs)} frames, {sum(states)} OK (= JAX); poses "
          f"within {worst_r:.5f} deg / {worst_t * 100:.5f} cm of JAX; ATE "
          f"{ate * 1000:.3f} mm (JAX {ref_ate * 1000:.3f} mm, limit "
          f"{limit * 1000:.3f} mm)")
    phase("slice", f"localization: {len(imgs) / total:.2f} fps over all "
          f"{len(imgs)} frames; {len(steady) / sum(steady):.2f} fps over "
          f"frames 2-{len(imgs) - 1}; first frame (relocalization) "
          f"{frame_s[0] * 1000:.1f} ms; median frame "
          f"{statistics.median(steady) * 1000:.1f} ms; host syncs "
          f"{syncs} = {syncs / len(imgs):.2f} per frame")

    # frontend / tracking split, on a second system (not counted above)
    split = SlamSystem(cfg, device=DEVICE)
    split.load_map(path)
    fe, tr = [], []
    for i, img in enumerate(imgs[:SPLIT_FRAMES]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = make_frame(torch.as_tensor(img).to(DEVICE), split.cam, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        split._step_frame(frame, i, i / 30.0)
        torch.cuda.synchronize()
        fe.append(t1 - t0)
        tr.append(time.perf_counter() - t1)
    phase("slice", f"split over frames 2-{len(fe) - 1}: frontend "
          f"(make_frame) median {statistics.median(fe[2:]) * 1000:.2f} ms, "
          f"tracking median {statistics.median(tr[2:]) * 1000:.2f} ms per "
          f"frame")
    return counts


def quads_phase(cfg, ref, imgs):
    """The K4 route of the quad proposal on the recorded frames. Returns
    the kernel launch counts of this run."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector

    acfg = cfg.aruco
    frames = [int(i) for i in ref["ref_quad_frames"]]
    binaries = [quad_binary(imgs[i], cfg, acfg.detect_downsample)
                for i in frames]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [detector.quad_candidates(
        b, acfg.max_quad_candidates,
        min_area=acfg.min_quad_side_px**2 / acfg.detect_downsample**2,
        cc_iters=acfg.cc_iters, use_pallas_cc=True) for b in binaries]
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    phase("quads", f"kernel launches in {len(frames)} quad_candidates("
          f"use_pallas_cc=True) calls: {counts}")
    check_launches("quads", counts)
    for k, (i, (q, s, v)) in enumerate(zip(frames, outs)):
        want_v = ref["ref_quad_valid"][k]
        v, s, q = v.cpu().numpy(), s.cpu().numpy(), q.cpu().numpy()
        if not (np.array_equal(v, want_v)
                and np.array_equal(s, ref["ref_quad_score"][k])
                and np.array_equal(q[want_v], ref["ref_quad_q"][k][want_v])):
            raise PhaseError(f"K4 quad proposal of frame {i} differs from "
                             f"the JAX package's (valid {int(v.sum())} vs "
                             f"{int(want_v.sum())})")
    phase("quads", f"frames {frames}: valid, score and valid quads equal to "
          f"the JAX package's ({[int(v.sum()) for v in ref['ref_quad_valid']]}"
          f" valid); {counts['cc_propagate'] / len(frames):.0f} K4 launches "
          f"per call")
    return counts


def stream_phase(path, cfg, ref, imgs):
    """The chunked serving form against the recorded JAX stream. Returns
    the kernel launch counts of the timed run."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    spec = json.loads(str(ref["ref_stream_spec"]))
    order = [int(k) for k in ref["ref_stream_order"]]
    chunk, depth = spec["chunk"], spec["depth"]
    scfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, loc_seed_mode=spec["loc_seed_mode"],
        loc_extrap_passes=spec["loc_extrap_passes"]))
    blank = np.full(imgs[0].shape, 128, np.uint8)
    frames = [(blank if k < 0 else imgs[k], 1.0 + j / 30.0)
              for j, k in enumerate(order)]
    system = SlamSystem(scfg, device=DEVICE)
    system.load_map(path)
    system.track_monocular(imgs[0], ts=0.0)
    if system.state is not TrackingState.OK:
        raise PhaseError("the stream's first frame did not relocalize")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tracking.SYNCS["count"] = 0
    emit_t, out = [], []
    t0 = time.perf_counter()
    for fid, _, p in system.localize_stream(
            StagedSource(frames, batch=chunk, device=DEVICE), chunk=chunk,
            depth=depth):
        emit_t.append(time.perf_counter() - t0)
        out.append((fid, p))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    syncs = tracking.SYNCS["count"]
    chunks, rewinds = system.stats["chunks"], system.stats["rewinds"]
    phase("stream", f"kernel launches in the stream: {counts}")
    check_launches("stream", counts)
    if rewinds == 0:
        check_frames_built("stream", counts, len(frames))

    fids = [f for f, _ in out]
    if fids != ref["ref_stream_fid"].tolist():
        raise PhaseError(f"emitted frames differ from the JAX stream: "
                         f"{fids} vs {ref['ref_stream_fid'].tolist()}")
    ok = [p is not None for _, p in out]
    if ok != ref["ref_stream_ok"].tolist():
        raise PhaseError(f"OK/None states differ from the JAX stream at "
                         f"{[j for j, o in enumerate(ok) if o != ref['ref_stream_ok'][j]]}")
    worst_r = worst_t = 0.0
    for j, (_, p) in enumerate(out):
        if p is None:
            continue
        worst_r = max(worst_r, rot_err_deg(p[0], ref["ref_stream_R"][j]))
        worst_t = max(worst_t, float(np.linalg.norm(
            np.asarray(p[1], np.float64) - ref["ref_stream_t"][j])))
    if worst_r > ROT_TOL_DEG or worst_t > TRANS_TOL_M:
        raise PhaseError(f"stream poses off the JAX run: {worst_r:.4f} deg, "
                         f"{worst_t * 100:.4f} cm")
    n = len(out)
    bursts = [emit_t[0]] + [emit_t[k] - emit_t[k - chunk]
                            for k in range(chunk, n, chunk)]
    phase("stream", f"{n} frames emitted, {sum(ok)} OK (= JAX); poses "
          f"within {worst_r:.5f} deg / {worst_t * 100:.5f} cm of JAX")
    phase("stream", f"localize_stream chunk {chunk} depth {depth} "
          f"({spec['loc_seed_mode']}, passes {spec['loc_extrap_passes']}): "
          f"{n / dt:.2f} fps over {n} frames ({dt:.2f} s); median chunk "
          f"latency {statistics.median(bursts) * 1000:.1f} ms (bursts "
          f"{[round(b * 1000, 1) for b in bursts]} ms); host syncs {syncs} "
          f"over {chunks} chunks = {syncs / max(chunks, 1):.2f} per chunk; "
          f"rewinds {rewinds}")

    # every synchronizing call of one more chunk (not timed)
    src = StagedSource(frames[:DEBUG_FRAMES], batch=DEBUG_FRAMES,
                       device=DEVICE)
    n_sync, where = port_sync_calls(lambda: list(system.localize_stream(
        src, chunk=DEBUG_FRAMES, depth=depth)))
    phase("stream", f"sync debug mode, one chunk of {DEBUG_FRAMES}: "
          f"{n_sync} synchronizing calls ({n_sync / DEBUG_FRAMES:.2f} per "
          f"frame); by site: {sites(where)}")
    if n_sync > MAX_DEBUG_SYNCS:
        raise PhaseError(f"{n_sync} synchronizing calls in the debug chunk, "
                         f"above {MAX_DEBUG_SYNCS}")
    return counts


def sync_calls(fn):
    """The synchronizing calls torch's sync debug mode reports while fn()
    runs: Counter of (file, line) sites."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return collections.Counter((w.filename, w.lineno) for w in caught
                               if "synchroniz" in str(w.message))


def sites(where):
    """The sites of a sync_calls Counter, most frequent first."""
    return "; ".join(f"{os.path.relpath(f, HERE)}:{n} x{c} "
                     f"({linecache.getline(f, n).strip()!r})"
                     for (f, n), c in where.most_common())


def port_sync_calls(fn):
    """(count, sites) of fn's synchronizing calls. An empty window goes
    first: the first switch into the debug mode in a process reports one
    call inside torch.cuda itself, which is not the port's."""
    baseline = sync_calls(lambda: None)
    where = sync_calls(fn)
    where.subtract(baseline)
    where = +where
    return sum(where.values()), where


def pose_errors(poses, ref_R, ref_t):
    """Worst rotation (deg) and translation (m) of the non-None poses
    against the recorded ones."""
    import numpy as np

    worst_r = worst_t = 0.0
    for i, p in enumerate(poses):
        if p is None:
            continue
        worst_r = max(worst_r, rot_err_deg(p[0], ref_R[i]))
        worst_t = max(worst_t, float(np.linalg.norm(
            np.asarray(p[1], np.float64) - ref_t[i])))
    return worst_r, worst_t


def slam_phase(cfg, ref, loc_imgs):
    """SLAM mode over the 32 map frames against the recorded JAX depth-0 run,
    then localization against the port-built map. Returns the kernel launch
    counts of the SLAM run."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    scfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                    pipeline_depth=0))
    imgs = render(scfg, ref, "ref_map_params")
    system = SlamSystem(scfg, device=DEVICE)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tracking.SYNCS["count"] = 0
    states, inserts, frame_s = [], [], []
    for i, img in enumerate(imgs):
        before = system.stats["kf_inserted"]
        t0 = time.perf_counter()
        system.track_monocular(img, ts=i / 30.0)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        states.append(system.state.value)
        inserts.append(system.stats["kf_inserted"] - before)
    counts = dict(kernels.launch_counts)
    syncs = tracking.SYNCS["count"]
    n_points = int(system.map.pt_valid.sum())
    phase("slam", f"kernel launches in the SLAM run: {counts}")
    check_launches("slam", counts)
    check_frames_built("slam", counts, len(imgs))

    got_ins = np.flatnonzero(inserts).tolist()
    want_ins = np.flatnonzero(ref["ref_slam_kf_insert"]).tolist()
    if got_ins != want_ins:
        raise PhaseError(f"keyframe inserts at {got_ins} vs the JAX run's "
                         f"{want_ins}")
    summary = hold_slam_run("SLAM", system, system.get_trajectory(), ref,
                            "ref_slam_")
    first_ok = states.index(TrackingState.OK.value)
    after = frame_s[first_ok + 1:]
    phase("slam", f"{len(imgs)} frames, keyframe inserts {got_ins} (= JAX);"
          f" {summary}")
    phase("slam", f"SLAM: {len(after) / sum(after):.2f} fps over the "
          f"{len(after)} frames after initialization (frame {first_ok}); "
          f"initialization frame {frame_s[first_ok] * 1000:.1f} ms; median "
          f"frame {statistics.median(after) * 1000:.1f} ms; insert frames "
          f"{[round(frame_s[i] * 1000, 1) for i in got_ins]} ms; host syncs "
          f"{syncs} = {syncs / len(imgs):.2f} per frame; keyframes "
          f"{system.n_keyframes}, points {n_points}, BA runs "
          f"{system.stats['ba_runs']}, stats {system.stats}")

    # localization against the port-built map
    loc = SlamSystem(scfg, device=DEVICE)
    loc.set_map(system.map)
    lposes = [loc.track_monocular(img, ts=100.0 + i / 30.0)
              for i, img in enumerate(loc_imgs)]
    lok = [p is not None for p in lposes]
    if lok != ref["ref_slam_loc_ok"].tolist():
        raise PhaseError(f"localization against the port-built map: states"
                         f" {lok} vs the JAX run's "
                         f"{ref['ref_slam_loc_ok'].tolist()}")
    lr, lt = pose_errors(lposes, ref["ref_slam_loc_R"], ref["ref_slam_loc_t"])
    if lr > SLAM_ROT_TOL_DEG or lt > SLAM_TRANS_TOL_M:
        raise PhaseError(f"localization against the port-built map off the "
                         f"JAX run: {lr:.4f} deg, {lt * 100:.4f} cm")
    phase("slam", f"localization of {len(loc_imgs)} frames against the "
          f"port-built map: {sum(lok)} OK (= JAX); poses within {lr:.5f} "
          f"deg / {lt * 100:.5f} cm of JAX's against its own map")

    slam_sync_phase(scfg, imgs)

    # frontend / tracking / mapping split, on a second system (not counted)
    split = SlamSystem(scfg, device=DEVICE)
    insert = split._insert_keyframe
    map_s = []

    def timed_insert(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = insert(*a, **k)
        torch.cuda.synchronize()
        map_s.append(time.perf_counter() - t)
        return out

    split._insert_keyframe = timed_insert
    rows = []
    for i, img in enumerate(imgs[:SLAM_SPLIT_FRAMES]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = make_frame(torch.as_tensor(img).to(DEVICE), split.cam, scfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_map = len(map_s)
        split._step_frame(frame, i, i / 30.0)
        torch.cuda.synchronize()
        m = sum(map_s[n_map:])
        rows.append((i, (t1 - t0) * 1e3, (time.perf_counter() - t1 - m) * 1e3,
                     m * 1e3))
    tracked = [r for r in rows if r[0] > first_ok]
    phase("slam", "split per frame (ms): " + "; ".join(
        f"{i}: fe {a:.1f} tr {b:.1f} map {c:.1f}" for i, a, b, c in rows))
    phase("slam", f"split medians over frames {first_ok + 1}-"
          f"{SLAM_SPLIT_FRAMES - 1}: frontend "
          f"{statistics.median(r[1] for r in tracked):.2f} ms, tracking "
          f"{statistics.median(r[2] for r in tracked):.2f} ms; mapping "
          f"{[round(r[3], 1) for r in rows if r[3] > 0]} ms per insert")
    return counts


def slam_sync_phase(scfg, imgs):
    """Every synchronizing call of SLAM mode: the 32 frames on a fresh
    system under the sync debug mode (per frame, then by site), and one
    classic two-view initialization between frames 0 and 2 (the path a
    start without a common marker takes), after a first one that makes its
    constants. Not timed."""
    import torch

    from orb_slam2_aruco_tpu_torch.pipeline import initializer
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    system = SlamSystem(scfg, device=DEVICE)
    sync_calls(lambda: None)          # the debug mode's own first report
    where, per_frame = collections.Counter(), []
    for i, img in enumerate(imgs):
        got = sync_calls(lambda: system.track_monocular(img, ts=i / 30.0))
        per_frame.append(sum(got.values()))
        where.update(got)
    n_sync = sum(per_frame)
    phase("slam", f"sync debug mode, {len(imgs)} SLAM frames: {n_sync} "
          f"synchronizing calls ({n_sync / len(imgs):.2f} per frame); per "
          f"frame {per_frame}; by site: {sites(where)}")
    if n_sync > MAX_SLAM_SYNCS:
        raise PhaseError(f"{n_sync} synchronizing calls in the SLAM run, "
                         f"above {MAX_SLAM_SYNCS}")
    f0, f2 = (make_frame(torch.as_tensor(imgs[i]).to(DEVICE), system.cam,
                         scfg) for i in (0, 2))
    initializer.classic_relative_pose(f0, f2, system.cam, scfg)  # warm
    torch.cuda.synchronize()
    n_init, where = port_sync_calls(lambda: initializer.classic_relative_pose(
        f0, f2, system.cam, scfg).ctrl)
    phase("slam", f"sync debug mode, one classic initialization: {n_init} "
          f"synchronizing calls; by site: {sites(where)}")
    if n_init > MAX_CLASSIC_INIT_SYNCS:
        raise PhaseError(f"{n_init} synchronizing calls in the classic "
                         f"initialization, above {MAX_CLASSIC_INIT_SYNCS}")


def bench_slam_pass(cfg, frames):
    """bench.py's SLAM pass (bench.py:128-164) on a fresh system: the frames
    through StagedSource(batch=PIPE_BATCH), each track_monocular call timed,
    then flush and a device synchronize. Every keyframe the run creates is
    recorded by its frame id, in order. Returns (system, the trajectory
    records, keyframes created by frame, keyframes inserted by each call,
    {slam_fps, p50_ms, p90_ms, flush_ms, drop})."""
    from unittest import mock

    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource
    from orb_slam2_aruco_tpu_torch.pipeline import mapping
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    created = []
    real_create = mapping.create_keyframe

    def create(*a, **kw):
        created.append(int(a[6]))
        return real_create(*a, **kw)

    system = SlamSystem(cfg, device=DEVICE)
    lat, per_call, ok_from = [], [], None
    src = StagedSource([(f, k / 30.0) for k, f in enumerate(frames)],
                       batch=PIPE_BATCH, device=DEVICE)
    with mock.patch.object(mapping, "create_keyframe", create):
        for j, (img, ts) in enumerate(src):
            before = system.stats["kf_inserted"]
            t0 = time.perf_counter()
            system.track_monocular(img, ts=ts)
            lat.append(time.perf_counter() - t0)
            per_call.append(system.stats["kf_inserted"] - before)
            if ok_from is None and system.state is TrackingState.OK:
                ok_from = j
        t0 = time.perf_counter()
        system.flush()
        torch.cuda.synchronize()
        flush_s = time.perf_counter() - t0
    drop = (ok_from if ok_from is not None else 4) + 2
    steady = np.asarray(lat[drop:])
    return system, system.get_trajectory(), created, per_call, dict(
        slam_fps=(len(frames) - drop) / (steady.sum() + flush_s),
        p50_ms=float(np.percentile(steady, 50) * 1e3),
        p90_ms=float(np.percentile(steady, 90) * 1e3),
        flush_ms=flush_s * 1e3, drop=drop)


def hold_slam_run(label, system, records, ref, pre):
    """Hold a SLAM run's trajectory records, keyframes (frame ids and
    poses), valid points and ATE to the JAX run under ref[pre + ...]
    (ref_slam_* or ref_pipe_*; ground truth ref_slam_gt_*) within the SLAM
    limits. Returns a summary string."""
    import numpy as np

    from orb_slam2_aruco_tpu_torch.io import trajectory

    fids = [r.frame_id for r in records]
    states = [r.state.value for r in records]
    if fids != list(range(len(ref["ref_slam_gt_R"]))):
        raise PhaseError(f"{label}: trajectory records for frames {fids}")
    if states != ref[pre + "state"].tolist():
        raise PhaseError(f"{label}: states differ from the JAX run: port "
                         f"{states} vs JAX {ref[pre + 'state'].tolist()}")
    kf_fid, _, kf_R, kf_t = system.keyframe_trajectory()
    if kf_fid.tolist() != ref[pre + "kf_fid"].tolist():
        raise PhaseError(f"{label}: keyframes at frames {kf_fid.tolist()} "
                         f"vs JAX's {ref[pre + 'kf_fid'].tolist()}")
    poses = [(r.Rcw, r.tcw) if r.state.value == 2 else None
             for r in records]
    worst_r, worst_t = pose_errors(poses, ref[pre + "R"], ref[pre + "t"])
    kf_r, kf_tr = pose_errors(list(zip(kf_R, kf_t)), ref[pre + "kf_R"],
                              ref[pre + "kf_t"])
    if max(worst_r, kf_r) > SLAM_ROT_TOL_DEG or max(
            worst_t, kf_tr) > SLAM_TRANS_TOL_M:
        raise PhaseError(f"{label}: poses off the JAX run: frames "
                         f"{worst_r:.4f} deg / {worst_t * 100:.4f} cm, "
                         f"keyframes {kf_r:.4f} deg / {kf_tr * 100:.4f} cm")
    n_points = int(system.map.pt_valid.sum())
    want_pts = int(ref[pre + "n_valid"] if pre + "n_valid" in ref
                   else ref[pre + "n_points"][-1])
    if abs(n_points - want_pts) > SLAM_POINTS_TOL * want_pts:
        raise PhaseError(f"{label}: {n_points} valid map points vs the JAX "
                         f"run's {want_pts}")
    ok = np.asarray(states) == 2
    est_c = trajectory.camera_centers([r.Rcw for r in records if
                                       r.state.value == 2],
                                      [r.tcw for r in records if
                                       r.state.value == 2])
    gt_c = trajectory.camera_centers(ref["ref_slam_gt_R"][ok],
                                     ref["ref_slam_gt_t"][ok])
    ate = trajectory.ate_rmse(est_c, gt_c, align=True, with_scale=False)
    ref_ate = float(ref[pre + "ate"])
    limit = max(1.5 * ref_ate, ref_ate + 0.005)
    if not np.isfinite(ate) or ate > limit:
        raise PhaseError(f"{label}: ATE {ate:.5f} m above {limit:.5f} m")
    return (f"states and keyframes {kf_fid.tolist()} equal to JAX; frame "
            f"poses within {worst_r:.5f} deg / {worst_t * 100:.5f} cm, "
            f"keyframe poses within {kf_r:.5f} deg / {kf_tr * 100:.5f} cm "
            f"of JAX; {n_points} valid points (JAX {want_pts}); ATE "
            f"{ate * 1000:.3f} mm (JAX {ref_ate * 1000:.3f} mm, limit "
            f"{limit * 1000:.3f} mm)")


def pipe_phase(cfg, ref, loc_imgs):
    """Pipelined SLAM mode: bench.py's SLAM pass at depth 4 and at depth 0
    on the same frames, held to the JAX runs; save, reload and localize;
    the sync debug mode; the two-pass example. Returns the kernel launch
    counts of the timed depth-4 pass."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.examples import mono_synthetic
    from orb_slam2_aruco_tpu_torch.io import checkpoint
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem
    from orb_slam2_aruco_tpu_torch.worldmap.state import state_to_numpy

    if (str(ref["ref_pipe_cfg"]) != str(ref["ref_cfg"])
            or cfg.tracking.pipeline_depth != PIPE_DEPTH):
        raise PhaseError("ref_full's pipelined recording is not its own "
                         f"depth-{PIPE_DEPTH} configuration")
    frames = render(cfg, ref, "ref_map_params")
    t_phase = time.perf_counter()
    _, _, _, _, warm = bench_slam_pass(cfg, frames)          # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tracking.SYNCS["count"] = 0
    system, records, created, _, m4 = bench_slam_pass(cfg, frames)
    counts = dict(kernels.launch_counts)
    syncs = tracking.SYNCS["count"]
    phase("pipe", f"kernel launches in the timed depth-{PIPE_DEPTH} pass: "
          f"{counts}")
    check_launches("pipe", counts)
    check_frames_built("pipe", counts, len(frames))
    if created != ref["ref_pipe_inserts"].tolist():
        raise PhaseError(f"depth {PIPE_DEPTH}: keyframes created at frames "
                         f"{created} vs JAX's "
                         f"{ref['ref_pipe_inserts'].tolist()}")
    summary = hold_slam_run(f"depth {PIPE_DEPTH}", system, records, ref,
                            "ref_pipe_")
    phase("pipe", f"depth {PIPE_DEPTH}, {len(frames)} frames: keyframes "
          f"created at {created} (= JAX); {summary}; host syncs {syncs} = "
          f"{syncs / len(frames):.2f} per frame; stats {system.stats}")

    zcfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                    pipeline_depth=0))
    system0, records0, _, per_call, m0 = bench_slam_pass(zcfg, frames)
    got_ins = np.flatnonzero(per_call).tolist()
    want_ins = np.flatnonzero(ref["ref_slam_kf_insert"]).tolist()
    if got_ins != want_ins:
        raise PhaseError(f"depth 0: inserts at {got_ins} vs the JAX run's "
                         f"{want_ins}")
    summary0 = hold_slam_run("depth 0", system0, records0, ref, "ref_slam_")
    phase("pipe", f"depth 0, the same frames: inserts at {got_ins} (= JAX);"
          f" {summary0}")
    for label, m in ((f"depth {PIPE_DEPTH} (warm-up pass)", warm),
                     (f"depth {PIPE_DEPTH}", m4), ("depth 0", m0)):
        phase("pipe", f"bench SLAM pass, {label}: slam_fps "
              f"{m['slam_fps']:.4f} over frames {m['drop']}-"
              f"{len(frames) - 1} and the flush; p50 {m['p50_ms']:.3f} ms, "
              f"p90 {m['p90_ms']:.3f} ms; flush {m['flush_ms']:.3f} ms")

    # save, reload, localize
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "map.npz")
        system.save_map(mpath)
        loc = SlamSystem(cfg, device=DEVICE)
        loc.load_map(mpath)
        saved, loaded = state_to_numpy(system.map), state_to_numpy(loc.map)
        differ = [f for f in saved if not np.array_equal(saved[f],
                                                         loaded[f])]
        ts64 = checkpoint.load_extras(mpath)["kf_ts64"]
    if differ or not np.array_equal(ts64, system.kf_ts64):
        raise PhaseError(f"the reloaded map differs in {differ}")
    lposes = [loc.track_monocular(img, ts=100.0 + i / 30.0)
              for i, img in enumerate(loc_imgs)]
    lok = [p is not None for p in lposes]
    if lok != ref["ref_ok"].tolist():
        raise PhaseError(f"localization against the reloaded depth-"
                         f"{PIPE_DEPTH} map: states {lok} vs JAX's "
                         f"{ref['ref_ok'].tolist()}")
    lr, lt = pose_errors(lposes, ref["ref_R"], ref["ref_t"])
    if lr > SLAM_ROT_TOL_DEG or lt > SLAM_TRANS_TOL_M:
        raise PhaseError(f"localization against the reloaded map off JAX's:"
                         f" {lr:.4f} deg, {lt * 100:.4f} cm")
    phase("pipe", f"save_map -> load_map: every array equal; "
          f"{len(loc_imgs)} frames localized against it: {sum(lok)} OK "
          f"(= JAX); poses within {lr:.5f} deg / {lt * 100:.5f} cm of JAX's "
          f"against its own depth-{PIPE_DEPTH} map")

    # every synchronizing call of the pipelined run
    dbg = SlamSystem(cfg, device=DEVICE)
    sync_calls(lambda: None)          # the debug mode's own first report
    where, per_frame = collections.Counter(), []
    tracking.SYNCS["count"] = 0
    for i, img in enumerate(frames):
        got = sync_calls(lambda: dbg.track_monocular(img, ts=i / 30.0))
        per_frame.append(sum(got.values()))
        where.update(got)
    got = sync_calls(dbg.flush)
    where.update(got)
    n_sync = sum(per_frame) + sum(got.values())
    phase("pipe", f"sync debug mode, the {len(frames)} frames at depth "
          f"{PIPE_DEPTH} and the flush: {n_sync} synchronizing calls; per "
          f"frame {per_frame}, flush {sum(got.values())}; deliberate host "
          f"reads (tracking.SYNCS) {tracking.SYNCS['count']}; by site: "
          f"{sites(where)}")
    if n_sync > MAX_PIPE_SYNCS:
        raise PhaseError(f"{n_sync} synchronizing calls in the pipelined "
                         f"run, above {MAX_PIPE_SYNCS}")

    # the port's two-pass entry point
    with tempfile.TemporaryDirectory() as tmp:
        tum, mpath = os.path.join(tmp, "traj.tum"), os.path.join(tmp,
                                                                 "map.npz")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mono_synthetic.main(["--frames", str(EXAMPLE_FRAMES),
                                      "--two-pass", "--out", tum,
                                      "--save-map", mpath])
        dt = time.perf_counter() - t0
        lines = [ln.split("\r")[-1] for ln in out.getvalue().splitlines()]
        if (rc != 0 or not os.path.getsize(tum) or not any(
                ln.startswith("ATE RMSE vs ground truth:") for ln in lines)):
            raise PhaseError(f"the example exited {rc}: {lines[-6:]}")
        n_kf = int(checkpoint.load_map(mpath, DEVICE).kf_valid.sum())
    phase("pipe", f"example mono_synthetic --frames {EXAMPLE_FRAMES} "
          f"--two-pass --save-map: exit 0 in {dt:.1f} s, map with {n_kf} "
          f"keyframes; " + " | ".join(ln for ln in lines if ln.startswith((
              "median", "keyframes", "second pass", "trajectory", "ATE")))
          + f"; the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def loop_reference():
    """(cfg, ref_loop_* arrays without the prefix, the pan's float32
    frames, their ground-truth poses) of data/ref_full.npz."""
    import numpy as np

    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic

    with np.load(os.path.join(HERE, PKG, "data", "ref_full.npz")) as z:
        ref = {k[len("ref_loop_"):]: z[k] for k in z.files
               if k.startswith("ref_loop_")}
    cfg = SlamConfig.from_dict(json.loads(str(ref["cfg"])))
    w = json.loads(str(ref["world"]))
    world = synthetic.build_world(
        w["marker_ids"], dict_name=cfg.aruco.dictionary,
        marker_size=w["marker_size"], grid_cols=w["grid_cols"],
        spacing=w["spacing"], px_per_m=w["px_per_m"],
        extent_margin=w["extent_margin"])
    gt = [synthetic.look_at_plane_pose((x, y), d, yaw=yaw, pitch=pitch)
          for x, y, d, yaw, pitch in ref["params"]]
    imgs = [synthetic.render_view(world, cfg.camera, R, t) for R, t in gt]
    return cfg, ref, imgs, gt


def loop_frames(ref, imgs):
    """(frame, timestamp) of every step of the loop scene: the pan, then
    the extra frames (-1 black, -2 binary noise, k the pan's frame k)."""
    import numpy as np

    steps = [(img, i / 30.0) for i, img in enumerate(imgs)]
    for j, k in enumerate(ref["extra"].tolist()):
        if k == -1:
            img = np.zeros_like(imgs[0])
        elif k == -2:
            img = (np.random.default_rng(3).integers(0, 2, size=imgs[0].shape)
                   * 255).astype(np.float32)
        else:
            img = imgs[k]
        steps.append((img, 100.0 + j / 30.0))
    return steps


def run_loop_scene(cfg, ref, steps, probe=None):
    """The SLAM system over the loop scene's steps with the drift injected
    after frame LOOP_INJECT and keyframe_trajectory() after the pan:
    (system, poses, states, inserts, (fids, R, t) after the drain, valid
    points after the drain). probe(i, step_fn) runs each step (timing or
    sync counting)."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch.geometry.lie import so3_exp
    from orb_slam2_aruco_tpu_torch.io import synthetic
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    system = SlamSystem(cfg, device=DEVICE)
    n = len(ref["params"])
    poses, states, inserts = [], [], []
    traj = None
    for i, (img, ts) in enumerate(steps):
        if i == n:
            fids, _, kR, kt = system.keyframe_trajectory()
            traj = (fids, kR, kt, int(system.map.pt_valid.sum()))
        before = system.stats["kf_inserted"]
        def step(img=img, ts=ts):
            poses.append(system.track_monocular(img, ts=ts))

        probe(i, step) if probe is not None else step()
        states.append(system.state.value)
        inserts.append(system.stats["kf_inserted"] - before)
        if i == LOOP_INJECT:
            synthetic.inject_drift(system, LOOP_CUTOFF, so3_exp(
                torch.tensor(LOOP_DRIFT_W)), LOOP_DRIFT_T)
    return system, poses, np.asarray(states), np.asarray(inserts), traj


def loop_phase():
    """SLAM mode with loop closing and relocalization over the loop scene
    against the JAX package's recorded run. Returns the kernel launch
    counts of the timed run."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.io import trajectory
    from orb_slam2_aruco_tpu_torch.pipeline import loop_closing, tracking
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    cfg, ref, imgs, gt = loop_reference()
    steps = loop_frames(ref, imgs)
    # the loops (step, keyframe, loop keyframe, by marker, Sim3) and the
    # time of each correction, GBA slice and insert
    loops, kind, cur = [], [], [0]
    times = collections.defaultdict(list)
    real = {n: getattr(loop_closing, n) for n in
            ("correct_loop", "compute_sim3", "compute_sim3_classic")}
    real_sys = {n: getattr(SlamSystem, n) for n in
                ("_gba_slice", "_insert_keyframe", "_relocalize")}
    reloc_kind = {}

    def relocalize(self, frame, fid, ts):
        # by marker when the marker pose candidate holds (the JAX run's
        # record of the same question)
        slots = tracking.bind_markers(self.map, frame)
        ok = tracking.aruco_pose_candidate(self.map, frame, slots, self.cam,
                                           self.cfg)[0]
        before = self.stats["reloc"]
        out = real_sys["_relocalize"](self, frame, fid, ts)
        if self.stats["reloc"] > before:
            reloc_kind[cur[0]] = int(bool(ok))
        return out

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t)
            return out
        return run

    def correct(state, k, kf_loop, s, R, t, *a, **kw):
        loops.append((cur[0], k, kf_loop, kind[-1], float(s),
                      R.cpu().numpy(), t.cpu().numpy()))
        return real["correct_loop"](state, k, kf_loop, s, R, t, *a, **kw)

    def sim3(name, by_marker):
        def run(*a, **kw):
            kind.append(by_marker)
            return real[name](*a, **kw)
        return run

    frame_s = []

    def probe(i, step):
        cur[0] = i
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)

    loop_closing.correct_loop = timed("correction", correct)
    loop_closing.compute_sim3 = sim3("compute_sim3", 1)
    loop_closing.compute_sim3_classic = sim3("compute_sim3_classic", 0)
    SlamSystem._gba_slice = timed("gba", real_sys["_gba_slice"])
    SlamSystem._insert_keyframe = timed("insert",
                                        real_sys["_insert_keyframe"])
    SlamSystem._relocalize = relocalize
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        tracking.SYNCS["count"] = 0
        system, poses, states, inserts, traj = run_loop_scene(
            cfg, ref, steps, probe)
        counts = dict(kernels.launch_counts)
        syncs = tracking.SYNCS["count"]
    finally:
        for n, fn in real.items():
            setattr(loop_closing, n, fn)
        for n, fn in real_sys.items():
            setattr(SlamSystem, n, fn)
    phase("loop", f"kernel launches in the loop scene: {counts}")
    check_launches("loop", counts)
    check_frames_built("loop", counts, len(steps))

    n = len(imgs)
    last = len(steps) - 1
    want_states = ref["state"].tolist()
    if states[:last].tolist() != want_states[:last]:
        raise PhaseError(f"loop scene states differ from the JAX run: port "
                         f"{states.tolist()} vs JAX {want_states}")
    # the start-area frame: JAX's recorded run is lost there (its post-loop
    # map), JAX one ulp up relocalizes it by marker; the port must
    if states[last] != 2 or reloc_kind.get(last) != 1:
        raise PhaseError(f"the start-area frame (step {last}) did not "
                         f"relocalize by marker: state {states[last]}, "
                         f"relocalized by {reloc_kind.get(last)}")
    got_ins = np.flatnonzero(inserts).tolist()
    want_ins = np.flatnonzero(ref["kf_insert"]).tolist()
    fids, kR, kt, n_points = traj
    if (got_ins != want_ins or fids.tolist() != ref["kf_fid"].tolist()
            or system.n_keyframes != int(ref["n_kf"][-1])):
        raise PhaseError(f"keyframe inserts at {got_ins} (keyframes "
                         f"{fids.tolist()}) vs the JAX run's {want_ins} "
                         f"({ref['kf_fid'].tolist()})")
    got_loops = [list(lp[:4]) for lp in loops]
    if got_loops != ref["loops"].tolist() or not got_loops:
        raise PhaseError(f"loops (step, keyframe, loop keyframe, by marker) "
                         f"{got_loops} vs the JAX run's "
                         f"{ref['loops'].tolist()}")
    sim3_r = max(rot_err_deg(lp[5], R) for lp, R in zip(loops,
                                                         ref["loop_R"]))
    sim3_t = max(float(np.linalg.norm(lp[6] - t))
                 for lp, t in zip(loops, ref["loop_t"]))
    sim3_s = max(abs(lp[4] - s) for lp, s in zip(loops, ref["loop_s"]))
    if sim3_r > SLAM_ROT_TOL_DEG or sim3_t > SLAM_TRANS_TOL_M or sim3_s > 1e-6:
        raise PhaseError(f"loop Sim3s off the JAX run: {sim3_r:.4f} deg, "
                         f"{sim3_t * 100:.4f} cm, scale {sim3_s:.2e}")
    kf_r = max(rot_err_deg(a, b) for a, b in zip(kR, ref["kf_R"]))
    kf_t = max(float(np.linalg.norm(a - b)) for a, b in zip(kt, ref["kf_t"]))
    if kf_r > LOOP_KF_ROT_TOL_DEG or kf_t > LOOP_KF_TRANS_TOL_M:
        raise PhaseError(f"keyframe poses after the drain off the JAX run: "
                         f"{kf_r:.4f} deg, {kf_t * 100:.4f} cm (limits "
                         f"{LOOP_KF_ROT_TOL_DEG} deg, "
                         f"{LOOP_KF_TRANS_TOL_M * 100} cm)")
    want_pts = int(ref["n_valid"])
    if abs(n_points - want_pts) > SLAM_POINTS_TOL * want_pts:
        raise PhaseError(f"{n_points} valid map points vs the JAX run's "
                         f"{want_pts} (limit {SLAM_POINTS_TOL:.0%})")
    est_c = trajectory.camera_centers(kR, kt)
    gt_c = trajectory.camera_centers([gt[i][0] for i in fids],
                                     [gt[i][1] for i in fids])
    seam = float(np.linalg.norm(
        np.asarray(kR[0], np.float64) @ (est_c[-1] - est_c[0])
        - np.asarray(gt[fids[0]][0], np.float64) @ (gt_c[-1] - gt_c[0])))
    ref_seam = float(ref["seam"])
    seam_limit = min(max(1.5 * ref_seam, ref_seam + 0.005), 0.25)
    if not seam <= seam_limit:
        raise PhaseError(f"seam error {seam * 1000:.3f} mm above "
                         f"{seam_limit * 1000:.3f} mm (JAX "
                         f"{ref_seam * 1000:.3f} mm)")
    bow = [i for i in range(n, last) if ref["reloc_marker"][i] >= 0]
    got_bow = [i for i in range(n, last) if i in reloc_kind]
    if (got_bow != bow or [reloc_kind[i] for i in bow]
            != ref["reloc_marker"][bow].tolist()
            or 0 not in ref["reloc_marker"][bow].tolist()
            or system.stats["reloc"]
            != json.loads(str(ref["stats"]))["reloc"] + 1):
        raise PhaseError(f"relocalizations at steps {sorted(reloc_kind)} "
                         f"(marker {reloc_kind}) vs the JAX run's "
                         f"{ref['reloc_marker'].tolist()}")
    rl_r, rl_t = pose_errors([poses[i] for i in bow], ref["R"][bow],
                             ref["t"][bow])
    if rl_r > LOOP_RELOC_ROT_TOL_DEG or rl_t > LOOP_RELOC_TRANS_TOL_M:
        raise PhaseError(f"BoW-PnP poses off the JAX run: {rl_r:.4f} deg, "
                         f"{rl_t * 100:.4f} cm")
    gba_cams = sorted(set(ref["gba_cams"].tolist()) - {0})
    loop_step = got_loops[0][0]
    tracked = [frame_s[i] for i in range(n) if states[i] == 2
               and i != loop_step]
    phase("loop", f"{len(steps)} steps ({n} pan frames, extra "
          f"{ref['extra'].tolist()}): states, inserts ({len(got_ins)}), "
          f"keyframes ({len(fids)}) and loops {got_loops} equal to JAX "
          f"(post-loop GBA over {gba_cams} camera slots: CG beyond 32); "
          f"Sim3s within {sim3_r:.5f} deg / {sim3_t * 100:.5f} cm; keyframe "
          f"poses after the drain within {kf_r:.5f} deg / {kf_t * 100:.5f} "
          f"cm; {n_points} valid points (JAX {want_pts}); seam "
          f"{seam * 1000:.3f} mm (JAX {ref_seam * 1000:.3f} mm); "
          f"BoW-PnP relocalization at steps {bow} within {rl_r:.5f} deg / "
          f"{rl_t * 100:.5f} cm of JAX's; the start-area frame (step "
          f"{last}) relocalized by marker (JAX's recorded run: lost)")
    med = statistics.median
    phase("loop", f"{len(tracked) / sum(tracked):.2f} fps over the "
          f"{len(tracked)} tracked pan frames but the loop frame (median "
          f"{med(tracked) * 1000:.1f} ms); the loop frame (step {loop_step}) "
          f"{frame_s[loop_step] * 1000:.1f} ms; per insert median "
          f"{med(times['insert']) * 1000:.1f} ms over "
          f"{len(times['insert'])}; per GBA slice "
          f"{[round(v * 1000, 1) for v in times['gba']]} ms; per loop "
          f"correction {[round(v * 1000, 1) for v in times['correction']]}"
          f" ms; host syncs {syncs} = {syncs / len(steps):.2f} per step; "
          f"stats {system.stats}")

    sync_calls(lambda: None)          # the debug mode's own first report
    where, per_step = collections.Counter(), []

    def count(i, step):
        got = sync_calls(step)
        per_step.append(sum(got.values()))
        where.update(got)

    _, _, states2, _, _ = run_loop_scene(cfg, ref, steps, count)
    n_sync = sum(per_step)
    phase("loop", f"sync debug mode, the {len(steps)} steps again: {n_sync} "
          f"synchronizing calls; per step {per_step}; states "
          f"{'as' if states2.tolist() == states.tolist() else 'unlike'} the "
          f"timed run's; by site: {sites(where)}")
    if n_sync > MAX_LOOP_SYNCS:
        raise PhaseError(f"{n_sync} synchronizing calls in the loop scene, "
                         f"above {MAX_LOOP_SYNCS}")
    return counts


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"FAIL: {PKG}/ not found beside chip_smoke.py", flush=True)
        return 1
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    try:
        import torch

        smi = device_phase()
        build_phase()
        path, cfg, ref, imgs = load_reference()
        kres = kernel_phase(cfg, imgs[0])
        by_path = {"slice": slice_phase(path, cfg, ref, imgs),
                   "quads": quads_phase(cfg, ref, imgs),
                   "stream": stream_phase(path, cfg, ref, imgs),
                   "slam": slam_phase(cfg, ref, imgs),
                   "pipe": pipe_phase(cfg, ref, imgs),
                   "loop": loop_phase()}
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1],
         "launches": sum(c[name] for c in by_path.values()),
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         **kres[name]}
        for name in KERNEL_META
    ]}
    phase("report", f"all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
