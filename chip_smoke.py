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
  7. serve    the serving paths a user of the defaults takes, against the
              JAX package's runs at full width (data/ref_full.npz, ref_tb_*
              and ref_dstream_*): track_batch in its four modes (extrapolate
              with 1 and 2 passes, scan two-stage, sequential) on one chunk
              of 16 recorded frames from the recorded tracking state, OK
              flags equal and poses within 0.2 deg / 1 cm, ms per chunk;
              the default serving form, localize_stream(StagedSource(
              frames, batch=16)) at its own chunk and depth with SlamConfig's
              tracking serving knobs and ArUco route (scan, 2 passes,
              two-stage, detect_downsample=1: K3 at 540x960 in every
              frame) over 65 frames with a blank grey frame mid-chunk:
              emitted ids, OK/None, rewinds and relocalizations equal to
              JAX's, poses within 0.2 deg / 1 cm, K1, K2 and K3 once per
              frame built (the rewind's replayed frames included, as many
              as JAX built), fps, median chunk latency and host syncs; one
              more chunk of SERVE_DEBUG_FRAMES under the sync debug mode, at
              most MAX_SCAN_SYNCS calls, printed by site; and
              track_monocular_batch: poses bit-equal to one track_batch
              call from the same state, a chunk with a blank frame
              relocalizing through the per-frame path.
  8. slam     SLAM mode (tracking.pipeline_depth 0) from an empty map over
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
  9. pipe     pipelined SLAM mode at the bench's depth (pipeline_depth 4,
              data/ref_full.npz's own configuration): bench.py's SLAM pass
              (bench.py:128-164, bench_torch.slam_pass) — a warm-up
              pass, then a timed pass over the 32 map frames through
              StagedSource(batch=4), per-call
              latency, flush and a device synchronize; slam_fps =
              (n - drop) / (sum of latencies + flush), p50, p90 — and the
              same pass at depth 0 on the same frames. The depth-4 run's
              trajectory records (states, poses), the frames whose
              processing created keyframes, the keyframes and their poses,
              the valid points and the ATE held to the JAX package's
              depth-4 run (ref_pipe_*, whose map is the file's map) within
              the SLAM limits; the depth-0 run to ref_slam_* as the slam
              phase holds it. Then the rewind run at depth 4
              (ref_pipe_rewind_*: map frames 0-7, three black frames, 8-11,
              reset_if_lost_with_kfs_leq = 0): states, inserts,
              relocalized frames and keyframes equal to JAX's, poses within
              the SLAM limits, the ATE at most max(1.5 x, +5 mm) of JAX's,
              K1-K3 once per frame (the replayed frames are not rebuilt).
              Then save_map, load_map into a new system and
              the 32 mid-point frames localized against it: states equal to
              ref_ok, poses within 0.5 deg / 2 cm of ref_R / ref_t. Then the
              32 frames at depth 4 under the sync debug mode: at most
              MAX_PIPE_SYNCS, printed by site. Last, the port's two-pass
              example (examples/mono_synthetic.py: 40 frames, --two-pass,
              --save-map) must exit 0, write its TUM file and its map and
              print an ATE.
 10. bench    bench_torch.py's workload (bench.py's, through the port) at
              full size: the scene (bench_torch.bench_scene) must be
              ref_full's recorded one; a warm-up and a timed SLAM pass
              (bench_torch.slam_pass, the pipe phase's pass) held to
              ref_pipe_* as the pipe phase holds its pass; on the warm
              system the serving pass (bench_torch.stream_pass: one warm-up
              chunk of 64, then 1024 frames in chunks of 64, extrapolate
              mode, two chunks in flight): the warm-up chunk and the timed
              stream's first frames held to the JAX package's run of
              bench.py's sequence (ref_bench_*: ids, OK/None and rewinds
              equal, poses within 0.5 deg / 2 cm), all 1024 poses non-None
              and within 0.5 deg / 2 cm of JAX's for the same image; the
              30-iteration whole-map BA (bench_torch.ba_rate, 256 camera
              slots: the CG branch) on ref_full's map against JAX's on it:
              chi2 before and after within BENCH_CHI2_TOL, keyframe poses
              within R 2e-4 / t 2e-3; the idle shares of a third SLAM pass
              and two stream chunks from torch.profiler. Prints
              bench_torch's JSON line.
 11. loop     SLAM mode with loop closing and relocalization at the same
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
 12. dist     the distributed global BA over device lists of the one card
              (every entry cuda:0: the cost of sharding, not scaling): on
              the problem of the first GBA slice of the loop phase's
              untimed sync-counting run (the map right after the loop
              correction, copied outside every timed span; its bucket of
              64 camera slots and 4096 points: the CG branch; after the drain two
              LM iterations reject every step, which would hold nothing),
              distributed_ba_solve and bundle_adjust_distributed on 1, 2, 4
              and 8 entries against ba_solve / bundle_adjust: ba_solve's
              sharded path (shard_problem, the per-shard sums) on a 1-entry
              mesh bit for bit (under deterministic algorithms), the others
              within R 2e-4, t 2e-3 (JAX's own limits,
              tests/test_parallel.py:18-27) and 98 % of the points within
              5e-3 (JAX's map-level test, :93-98: two calls of the
              single-device solve differ by more), edge_chi2 in the caller's
              order; ms per solve and the host time of the edge partition.
              Then the loop scene again through SlamSystem with
              optim.distributed_gba over 4 entries: every GBA slice
              distributed, held to the JAX run as the loop phase holds it.
 13. graft    graft_entry_torch.py, the port of __graft_entry__.py: the
              flagship step (entry(): a 540x960 uniform-noise frame through
              make_frame at SlamConfig's defaults, bind_markers and
              track_local_map against a capacity map of 512 random points)
              held to the JAX package's recording (data/ref_graft.npz,
              tests/test_torch_slice.py --graft): valid keypoints,
              octaves and descriptors equal, pixels within
              GRAFT_KP_TOL_PX, n_inliers equal, pose within 0.2 deg /
              1 cm, K1, K2 and K3 once each per step, ms per step; the
              capacity global BA (make_gba_problem(256, 20000, 16): 256k
              point edges) built on the card, its index arrays' digest
              equal to JAX's and its chi2 before the solve within
              GRAFT_CHI2_0_TOL; ba_solve(iters=2) (the CG branch) and
              dryrun_multichip over 1, 2, 4 and 8 entries of cuda:0 held
              to JAX's single and 8-device solves with exact segment sums
              (JAX as shipped rejects both LM steps there: its cumsum
              segment sums cancel) and to each other: chi2 within twice
              what one ulp moves JAX's own solve, R 2e-4, t 2e-3, 98 % of
              the points within 5e-3; ba_solve's sharded path on one entry
              bit for bit (deterministic algorithms); ms per LM iteration
              for each mesh and the host ms of the edge partition.
 14. video    the real-footage CLI (examples/mono_video.py's `run`) over
              the recorded ARUCO_MIP_25h7 fly-by (data/ref_video.npz: 18
              frames at 480x360 as the JAX VideoSource decoded them from
              their MJPG file): --two-pass --chunk 6 --features 700, the
              camera from an ORB-SLAM yml the phase writes, the viewer on
              an automatic port (one GET of the snapshot and the frame, a
              cross-origin POST refused), save_map (reloaded equal) and the
              map view PNG. Pass-1 states, keyframes and pass-2 tracked
              frames equal to the JAX CLI's recorded run, pass-2 poses
              within 0.5 deg / 2 cm, ATE at most max(1.5 x, +5 mm) of
              JAX's and below 12 cm. Without cv2, VideoSource and
              ImageFolderSource must raise its ImportError.
 15. api      the public per-frame functions and the generated ArUco
              dictionaries (data/ref_dicts.npz, recorded from the JAX
              package by tests/test_torch_slice.py --dicts): (a) the
              recorded ARUCO_MIP_16h3 and TPU_36h12 frames through
              make_frame, ids equal to JAX's detect_markers, corners within
              API_CORNER_TOL_PX; (b) keypoint_angles and describe (K2) on
              the bench frame equal to their plain versions on the card,
              descriptors bit-equal to the CPU's, angles and
              orientation_map within API_ANGLE_TOL_RAD of the CPU's; (c)
              detect_level with use_pallas None and True identical (K1),
              False (the XLA route) with K1's score map outside the
              FAST_BORDER_PX band (nonzero pattern equal, values within
              FAST_ROUTE_RTOL), the keypoints that differ printed; (d)
              hamming_popcount equal to matching.distance_matrix; (e)
              native/quadfind.cpp built at first use into a temporary
              directory, its quads equal to the committed library's. Then
              solve_damped (LU) against small_spd_solve (Cholesky) and the
              ms per call of each entry point.
 16. report   one {"kernels": [...]} JSON line, the nvidia-smi line, and as
              the last line {"ok": true, "device": {...}}.

Launch counts are zeroed just before each of slice, quads, stream, serve
(its default-form stream), slam, pipe (its timed depth-4 pass), bench (the
whole of bench_torch's run), loop, dist (its system run), graft (one
flagship step), video and api and read just after: each must have
launched the kernels of its path (K1-K3 on slice, stream, serve, slam,
pipe, bench, loop, dist, graft, video and api, K4 on quads), and K1, K2
and K3 once per frame built (api: exactly its count).
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
# track_batch's modes: (loc_seed_mode, loc_extrap_passes, loc_two_stage)
# (tests/test_torch_slice.py TB_MODES)
TB_MODES = {
    "extrap1": ("extrapolate", 1, True),
    "extrap2": ("extrapolate", 2, True),
    "two_stage": ("scan", 2, True),
    "sequential": ("scan", 2, False),
}
# the serve phase's sync-debug chunk (the default form, scan two-stage) and
# its synchronizing calls: the two branch reads of _cascade_seed per frame
# and the chunk's control read
SERVE_DEBUG_FRAMES = 16
MAX_SCAN_SYNCS = 2 * SERVE_DEBUG_FRAMES + 1
# the bench's SLAM pass depth (bench_torch.SLAM_DEPTH); the example's
# frames
PIPE_DEPTH = 4
EXAMPLE_FRAMES = 40
# the distributed global BA: mesh sizes (entries of the one card) and the
# limits of the sharded solve against the single-device one, JAX's own:
# R and t as tests/test_parallel.py:18-27 holds the solve, and, since the
# loop scene's GBA problem has weakly constrained points that move by
# centimetres when only the summation order changes (two calls of the
# single-device solve on the card differ by 1.2-1.8 cm; PERF.md section
# 2), the points as its map-level test (:93-98) holds them: a share
# within the limit; the mesh of the system's run
DIST_MESHES = (1, 2, 4, 8)
DIST_ROT_TOL, DIST_TRANS_TOL, DIST_PTS_TOL = 2e-4, 2e-3, 5e-3
DIST_PTS_SHARE = 0.98
DIST_SYSTEM_MESH = 4
# the bench's whole-map BA on ref_full's map against JAX's: chi2 before and
# after within this share of JAX's (keyframe poses: DIST_ROT_TOL,
# DIST_TRANS_TOL)
BENCH_CHI2_TOL = 0.01

# the graft phase (graft_entry_torch.py, the port of __graft_entry__.py):
# the chi2 before the capacity solve within this share of JAX's, the
# entry step's keypoints within this many pixels of JAX's (its float32
# undistortion: 46.999996 where the port gives 47); the capacity solves'
# chi2 within twice what one float32 ulp moves JAX's own solve
# (ref_graft's witness_chi2, tests/test_torch_slice.py --graft), their
# poses and points within DIST_ROT_TOL, DIST_TRANS_TOL, DIST_PTS_SHARE
GRAFT_CHI2_0_TOL = 1e-5
GRAFT_KP_TOL_PX = 1e-3

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
    "serve": ("fast", "patches", "cc_fused"),
    "slam": ("fast", "patches", "cc_fused"),
    "pipe": ("fast", "patches", "cc_fused"),
    "bench": ("fast", "patches", "cc_fused"),
    "loop": ("fast", "patches", "cc_fused"),
    "dist": ("fast", "patches", "cc_fused"),
    "graft": ("fast", "patches", "cc_fused"),
    "video": ("fast", "patches", "cc_fused"),
    "api": ("fast", "patches", "cc_fused"),
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


def as_numpy(x):
    """A tensor (on any device), array or number as numpy."""
    import numpy as np

    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def hold_track_batch(ref, mode, ctrls, carry, min_matches):
    """track_batch's control vectors [B, 20] and carry in `mode` against the
    JAX package's (ref_tb_<mode>_*): every frame's OK flag (local-map
    inliers >= min_matches) and the carry's equal, every frame's pose and
    the carry's pose within ROT_TOL_DEG / TRANS_TOL_M. Returns (worst deg,
    worst m); raises PhaseError otherwise."""
    import numpy as np

    c, cj = as_numpy(ctrls), ref[f"ref_tb_{mode}_ctrl"]
    if c.shape != cj.shape:
        raise PhaseError(f"track_batch {mode}: control vectors {c.shape}, "
                         f"JAX's {cj.shape}")
    ok, okj = c[:, 0] >= min_matches, cj[:, 0] >= min_matches
    got_ok = bool(as_numpy(carry[4]))
    if ok.tolist() != okj.tolist() or got_ok != bool(ref[f"ref_tb_{mode}_ok"]):
        raise PhaseError(f"track_batch {mode}: OK flags {ok.tolist()} "
                         f"(carry {got_ok}) vs JAX's {okj.tolist()} "
                         f"(carry {bool(ref[f'ref_tb_{mode}_ok'])})")
    poses = [(c[j, 5:14].reshape(3, 3), c[j, 14:17]) for j in range(len(c))]
    poses.append((as_numpy(carry[0]), as_numpy(carry[1])))
    worst_r, worst_t = pose_errors(
        poses, np.concatenate([cj[:, 5:14].reshape(-1, 3, 3),
                               ref[f"ref_tb_{mode}_R"][None]]),
        np.concatenate([cj[:, 14:17], ref[f"ref_tb_{mode}_t"][None]]))
    if worst_r > ROT_TOL_DEG or worst_t > TRANS_TOL_M:
        raise PhaseError(f"track_batch {mode}: poses off JAX's by "
                         f"{worst_r:.4f} deg / {worst_t * 100:.4f} cm")
    return worst_r, worst_t


def hold_stream(ref, pre, out, stats, rewinds):
    """A localize_stream run's emitted [(frame id, pose or None)], its stats
    and rewind count against the JAX package's recorded stream
    (ref[pre + ...]): frame ids, OK/None and stats["reloc"] equal, the
    rewinds equal to `rewinds` (JAX's), poses within ROT_TOL_DEG /
    TRANS_TOL_M. Returns (worst deg, worst m); raises PhaseError
    otherwise."""
    fids = [f for f, _ in out]
    if fids != ref[pre + "fid"].tolist():
        raise PhaseError(f"{pre}: emitted frames {fids} vs JAX's "
                         f"{ref[pre + 'fid'].tolist()}")
    ok = [p is not None for _, p in out]
    if ok != ref[pre + "ok"].tolist():
        raise PhaseError(f"{pre}: OK/None differ from JAX's at "
                         f"{[j for j, o in enumerate(ok) if o != ref[pre + 'ok'][j]]}")
    if (stats["rewinds"], stats["reloc"]) != (rewinds,
                                              int(ref[pre + "reloc"])):
        raise PhaseError(f"{pre}: {stats['rewinds']} rewinds and "
                         f"{stats['reloc']} relocalizations vs JAX's "
                         f"{rewinds} and {int(ref[pre + 'reloc'])}")
    worst_r, worst_t = pose_errors([p for _, p in out], ref[pre + "R"],
                                   ref[pre + "t"])
    if worst_r > ROT_TOL_DEG or worst_t > TRANS_TOL_M:
        raise PhaseError(f"{pre}: poses off JAX's by {worst_r:.4f} deg / "
                         f"{worst_t * 100:.4f} cm")
    return worst_r, worst_t


def hold_monocular_batch(ctrls, poses, blank_poses, reloc):
    """SlamSystem.track_monocular_batch against one track_batch call from
    the same state: its poses equal the control vectors' bit for bit; and
    its chunk (frame, blank, frame, frame) sends the blank and the rest of
    the chunk through the per-frame path, which relocalizes at the next
    frame: OK [True, False, True, True], stats["reloc"] 2 (the map's first
    frame and that one)."""
    import numpy as np

    c = as_numpy(ctrls)
    for j, (R, t) in enumerate(poses):
        if not (np.array_equal(as_numpy(R), c[j, 5:14].reshape(3, 3))
                and np.array_equal(as_numpy(t), c[j, 14:17])):
            raise PhaseError(f"track_monocular_batch: frame {j}'s pose is "
                             f"not track_batch's")
    ok = [p is not None for p in blank_poses]
    if ok != [True, False, True, True] or reloc != 2:
        raise PhaseError(f"track_monocular_batch with a blank frame: OK "
                         f"{ok}, {reloc} relocalizations (want [True, "
                         f"False, True, True] and 2)")


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
    scfg = serving_config(cfg, spec["loc_seed_mode"],
                          spec["loc_extrap_passes"],
                          cfg.tracking.loc_two_stage)
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


def default_stream_spec():
    """The port's default serving form: localize_stream's own chunk and
    depth, SlamConfig's tracking serving knobs and ArUco downsample (the
    recorder's `default_stream_spec` on the JAX package gives the same)."""
    import inspect

    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    d = SlamConfig()
    sig = inspect.signature(SlamSystem.localize_stream).parameters
    return dict(chunk=sig["chunk"].default, depth=sig["depth"].default,
                loc_seed_mode=d.tracking.loc_seed_mode,
                loc_extrap_passes=d.tracking.loc_extrap_passes,
                loc_two_stage=d.tracking.loc_two_stage,
                detect_downsample=d.aruco.detect_downsample)


def serving_config(cfg, seed_mode, passes, two_stage, downsample=None):
    """`cfg` with the localization serving knobs (and ArUco downsample)."""
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, loc_seed_mode=seed_mode, loc_extrap_passes=passes,
        loc_two_stage=two_stage))
    if downsample is not None:
        cfg = cfg.replace(aruco=dataclasses.replace(
            cfg.aruco, detect_downsample=downsample))
    return cfg


def tb_inputs(ref, device):
    """track_batch's recorded inputs (ref_tb_in_*) as tensors on
    `device`, in the port's dtypes."""
    import numpy as np
    import torch

    out = {}
    for k in ("R_last", "t_last", "vel_R", "vel_t", "last_uv", "last_desc",
              "last_obs", "last_valid", "last_octave", "last_angle",
              "ref_kf", "pt_visible", "pt_found"):
        v = np.array(ref[f"ref_tb_in_{k}"])
        if k == "last_desc":
            v = v.view(np.int32)
        t = torch.as_tensor(v)
        if k in ("last_obs", "last_octave", "ref_kf"):
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


def run_track_batch(path, cfg, ref, imgs, mode, device):
    """track_batch in `mode` (TB_MODES) on the recorded chunk (reference
    frames 2 on) from the recorded inputs: (ctrls, carry, ms, host
    syncs)."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch.geometry import camera
    from orb_slam2_aruco_tpu_torch.io import checkpoint
    from orb_slam2_aruco_tpu_torch.pipeline import tracking

    ins = tb_inputs(ref, device)
    state = checkpoint.load_map(path, device=device)._replace(
        pt_visible=ins["pt_visible"], pt_found=ins["pt_found"])
    n = ref[f"ref_tb_{mode}_ctrl"].shape[0]
    stack = torch.as_tensor(np.stack(imgs[2:2 + n])).to(device)
    cam = camera.camera_from_config(cfg.camera, device=device)
    mcfg = serving_config(cfg, *TB_MODES[mode])
    if device != "cpu":
        torch.cuda.synchronize()
    tracking.SYNCS["count"] = 0
    t0 = time.perf_counter()
    ctrls, carry = tracking.track_batch(
        state, stack, ins["R_last"], ins["t_last"], ins["vel_R"],
        ins["vel_t"], torch.tensor(True, device=device), ins["last_uv"],
        ins["last_desc"], ins["last_obs"], ins["last_valid"],
        ins["last_octave"], ins["last_angle"], ins["ref_kf"], cam, mcfg)
    if device != "cpu":
        torch.cuda.synchronize()
    return (ctrls, carry, (time.perf_counter() - t0) * 1e3,
            tracking.SYNCS["count"])


def count_frames_built(system):
    """Wrap a SlamSystem's chunk dispatch and per-frame call to count the
    frames they build: returns a dict {"chunk": frames of every chunk
    dispatched, "frame": per-frame calls, "frame_s": their wall time}."""
    n = {"chunk": 0, "frame": 0, "frame_s": 0.0}
    run_chunk, track_one = system._run_chunk, system.track_monocular

    def chunk(stack):
        n["chunk"] += stack.shape[0]
        return run_chunk(stack)

    def one(img, ts):
        n["frame"] += 1
        t0 = time.perf_counter()
        out = track_one(img, ts)
        n["frame_s"] += time.perf_counter() - t0
        return out

    system._run_chunk, system.track_monocular = chunk, one
    return n


def serve_phase(path, cfg, ref, imgs):
    """track_batch in its four modes, the default serving form with its
    rewind, and track_monocular_batch, against the JAX package's runs.
    Returns the kernel launch counts of the default-form stream."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    min_m = cfg.tracking.min_matches_local_map
    for mode in TB_MODES:
        ctrls, carry, ms, syncs = run_track_batch(path, cfg, ref, imgs, mode,
                                                  DEVICE)
        worst_r, worst_t = hold_track_batch(ref, mode, ctrls, carry, min_m)
        phase("serve", f"track_batch {mode} {TB_MODES[mode]}, one chunk of "
              f"{len(ctrls)}: OK flags equal to JAX's, poses within "
              f"{worst_r:.5f} deg / {worst_t * 100:.5f} cm; {ms:.1f} ms per "
              f"chunk ({ms / len(ctrls):.1f} per frame); host syncs {syncs}")

    # the default serving form, its rewind included
    spec = json.loads(str(ref["ref_dstream_spec"]))
    if spec != default_stream_spec():
        raise PhaseError(f"ref_dstream_spec {spec} is not the port's "
                         f"default serving form {default_stream_spec()}")
    dcfg = serving_config(cfg, spec["loc_seed_mode"],
                          spec["loc_extrap_passes"], spec["loc_two_stage"],
                          spec["detect_downsample"])
    blank = np.full(imgs[0].shape, 128, np.uint8)
    frames = [(blank if k < 0 else imgs[k], 1.0 + j / 30.0)
              for j, k in enumerate(ref["ref_dstream_order"].tolist())]
    system = SlamSystem(dcfg, device=DEVICE)
    system.load_map(path)
    system.track_monocular(imgs[0], ts=0.0)
    if system.state is not TrackingState.OK:
        raise PhaseError("the default form's first frame did not relocalize")
    built = count_frames_built(system)
    chunk = spec["chunk"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tracking.SYNCS["count"] = 0
    emit_t, out = [], []
    t0 = time.perf_counter()
    for fid, _, p in system.localize_stream(
            StagedSource(frames, batch=chunk, device=DEVICE)):
        emit_t.append(time.perf_counter() - t0)
        out.append((fid, p))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    syncs = tracking.SYNCS["count"]
    phase("serve", f"kernel launches in the default-form stream: {counts}")
    check_launches("serve", counts)
    n_built = built["chunk"] + built["frame"]
    if n_built != int(ref["ref_dstream_built"]):
        raise PhaseError(f"the default-form stream built {n_built} frames, "
                         f"JAX's {int(ref['ref_dstream_built'])}")
    check_frames_built("serve", counts, n_built)
    worst_r, worst_t = hold_stream(ref, "ref_dstream_", out, system.stats,
                                   int(ref["ref_dstream_rewinds"]))
    n, chunks = len(out), system.stats["chunks"]
    bursts = [emit_t[0]] + [emit_t[k] - emit_t[k - chunk]
                            for k in range(chunk, n, chunk)]
    phase("serve", f"default form (localize_stream() at its defaults, "
          f"{spec}): {n} frames emitted, {sum(p is not None for _, p in out)}"
          f" OK, ids and OK/None equal to JAX's; {system.stats['rewinds']} "
          f"rewinds and {system.stats['reloc']} relocalizations (= JAX); "
          f"poses within {worst_r:.5f} deg / {worst_t * 100:.5f} cm of JAX; "
          f"frames built {n_built} = {len(frames)} + {n_built - len(frames)}"
          f" rebuilt after the rewind ({built['chunk']} in chunks, "
          f"{built['frame']} per frame), K1 = K2 = K3 = {n_built} (= JAX's "
          f"frames built)")
    phase("serve", f"default form: {n / dt:.2f} fps over {n} frames "
          f"({dt:.2f} s); median chunk latency "
          f"{statistics.median(bursts) * 1000:.1f} ms (bursts "
          f"{[round(b * 1000, 1) for b in bursts]} ms); host syncs {syncs} "
          f"over {chunks} chunks and {built['frame']} per-frame calls "
          f"({syncs / max(chunks, 1):.2f} per chunk); the "
          f"rewind: {n_built - len(frames)} frames built again "
          f"({(n_built - len(frames)) / len(frames):.0%} more than emitted) "
          f"and {built['frame']} per-frame calls in "
          f"{built['frame_s'] * 1000:.1f} ms")

    # every synchronizing call of one more default-form chunk (not timed)
    src = StagedSource(frames[:SERVE_DEBUG_FRAMES], batch=SERVE_DEBUG_FRAMES,
                       device=DEVICE)
    tracking.SYNCS["count"] = 0
    n_sync, where = port_sync_calls(lambda: list(system.localize_stream(
        src, chunk=SERVE_DEBUG_FRAMES)))
    phase("serve", f"sync debug mode, one default-form chunk of "
          f"{SERVE_DEBUG_FRAMES}: {n_sync} synchronizing calls "
          f"({n_sync / SERVE_DEBUG_FRAMES:.2f} per frame; deliberate host "
          f"reads {tracking.SYNCS['count']}); by site: {sites(where)}")
    if n_sync > MAX_SCAN_SYNCS:
        raise PhaseError(f"{n_sync} synchronizing calls in the default-form "
                         f"debug chunk, above {MAX_SCAN_SYNCS}")

    # the facade's chunk call against one track_batch call
    mono = SlamSystem(dcfg, device=DEVICE)
    mono.load_map(path)
    for i in range(2):
        mono.track_monocular(imgs[i], ts=i / 30.0)
    lf = mono.last_frame
    stack = torch.as_tensor(np.stack(imgs[2:6])).to(DEVICE)
    ctrls, _ = tracking.track_batch(
        mono.map, stack, *mono.last_pose, *mono.vel,
        torch.tensor(True, device=DEVICE), lf.kp_uv, lf.desc, mono.last_obs,
        lf.kp_valid, lf.kp_octave, lf.kp_angle,
        torch.tensor(mono.ref_kf, device=DEVICE), mono.cam, dcfg)
    t0 = time.perf_counter()
    poses = mono.track_monocular_batch(imgs[2:6], [0.1, 0.2, 0.3, 0.4])
    batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    blank_poses = mono.track_monocular_batch(
        [imgs[6], blank, imgs[7], imgs[6]], [0.5, 0.6, 0.7, 0.8])
    rewind_ms = (time.perf_counter() - t0) * 1e3
    hold_monocular_batch(ctrls, poses, blank_poses, mono.stats["reloc"])
    if [r.frame_id for r in mono.get_trajectory()] != list(range(10)):
        raise PhaseError("track_monocular_batch: trajectory records out of "
                         "order")
    phase("serve", f"track_monocular_batch: 4 frames in {batch_ms:.1f} ms, "
          f"poses bit-equal to one track_batch call; the chunk with a blank "
          f"frame {rewind_ms:.1f} ms: OK [True, False, True, True], "
          f"{mono.stats['reloc']} relocalizations, "
          f"{mono.stats['rewinds']} rewind")
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


def pipe_rewind_phase(cfg, ref, frames):
    """The rewind run at the bench's depth: ref_pipe_rewind_order's frames
    (map frames, -1 = black) with reset_if_lost_with_kfs_leq = 0 on a
    fresh system, then flush. Its records (frame ids, states), the frames
    whose processing created keyframes, the relocalized frames and the
    keyframes equal to the JAX package's run (ref_pipe_rewind_*), OK poses
    and keyframe poses within the SLAM limits, ATE at most max(1.5 x,
    +5 mm) of JAX's; every frame built once (K1, K2, K3), the replayed
    frames included."""
    from unittest import mock

    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.io import trajectory
    from orb_slam2_aruco_tpu_torch.pipeline import mapping, tracking
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    pre = "ref_pipe_rewind_"
    order = ref[pre + "order"].tolist()
    rcfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, reset_if_lost_with_kfs_leq=0))
    black = np.zeros_like(frames[0])
    imgs = [black if k < 0 else frames[k] for k in order]
    system = SlamSystem(rcfg, device=DEVICE)
    inserts, relocs = [], []
    real_create, real_reloc = mapping.create_keyframe, SlamSystem._relocalize

    def create(*a, **kw):
        inserts.append(int(a[6]))
        return real_create(*a, **kw)

    def relocalize(self, frame, fid, ts):
        before = self.stats["reloc"]
        out = real_reloc(self, frame, fid, ts)
        if self.stats["reloc"] > before:
            relocs.append(fid)
        return out

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tracking.SYNCS["count"] = 0
    t0 = time.perf_counter()
    with mock.patch.object(mapping, "create_keyframe", create), \
            mock.patch.object(SlamSystem, "_relocalize", relocalize):
        for j, img in enumerate(imgs):
            system.track_monocular(img, ts=j / 30.0)
        system.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        recs = system.get_trajectory()
    counts = dict(kernels.launch_counts)
    check_frames_built("pipe", counts, len(imgs))
    fids = [r.frame_id for r in recs]
    states = [r.state.value for r in recs]
    kf_fid, _, kf_R, kf_t = system.keyframe_trajectory()
    got = dict(fid=fids, state=states, inserts=inserts, reloc_fid=relocs,
               kf_fid=kf_fid.tolist())
    for k, v in got.items():
        if v != ref[pre + k].tolist():
            raise PhaseError(f"rewind run: {k} {v} vs JAX's "
                             f"{ref[pre + k].tolist()}")
    poses = [(r.Rcw, r.tcw) if r.state.value == 2 else None for r in recs]
    worst_r, worst_t = pose_errors(poses, ref[pre + "R"], ref[pre + "t"])
    kf_r, kf_tr = pose_errors(list(zip(kf_R, kf_t)), ref[pre + "kf_R"],
                              ref[pre + "kf_t"])
    if max(worst_r, kf_r) > SLAM_ROT_TOL_DEG or max(
            worst_t, kf_tr) > SLAM_TRANS_TOL_M:
        raise PhaseError(f"rewind run: poses off the JAX run: frames "
                         f"{worst_r:.4f} deg / {worst_t * 100:.4f} cm, "
                         f"keyframes {kf_r:.4f} deg / {kf_tr * 100:.4f} cm")
    ok = [i for i, r in enumerate(recs) if r.state.value == 2
          and order[r.frame_id] >= 0]
    gt = [order[recs[i].frame_id] for i in ok]
    ate = trajectory.ate_rmse(
        trajectory.camera_centers([recs[i].Rcw for i in ok],
                                  [recs[i].tcw for i in ok]),
        trajectory.camera_centers(ref["ref_slam_gt_R"][gt],
                                  ref["ref_slam_gt_t"][gt]),
        align=True, with_scale=False)
    ref_ate = float(ref[pre + "ate"])
    limit = max(1.5 * ref_ate, ref_ate + 0.005)
    if not np.isfinite(ate) or ate > limit:
        raise PhaseError(f"rewind run: ATE {ate:.5f} m above {limit:.5f} m")
    phase("pipe", f"rewind run at depth {cfg.tracking.pipeline_depth} "
          f"(order {order}): states {states}, inserts {inserts}, "
          f"relocalized {relocs}, keyframes {kf_fid.tolist()} (= JAX); "
          f"frame poses within {worst_r:.5f} deg / {worst_t * 100:.5f} cm, "
          f"keyframe poses within {kf_r:.5f} deg / {kf_tr * 100:.5f} cm of "
          f"JAX; ATE {ate * 1000:.3f} mm (JAX {ref_ate * 1000:.3f} mm, limit "
          f"{limit * 1000:.3f} mm); K1 = K2 = K3 = {len(imgs)}, one per "
          f"frame; {len(imgs)} frames and the flush in {dt:.2f} s "
          f"({len(imgs) / dt:.2f} fps); host syncs "
          f"{tracking.SYNCS['count']}; stats {system.stats}")


def pipe_phase(cfg, ref, loc_imgs):
    """Pipelined SLAM mode: bench.py's SLAM pass at depth 4 and at depth 0
    on the same frames, held to the JAX runs; save, reload and localize;
    the sync debug mode; the two-pass example. Returns the kernel launch
    counts of the timed depth-4 pass."""
    import numpy as np
    import torch
    from bench_torch import slam_pass

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
    _, _, _, _, warm = slam_pass(cfg, frames, DEVICE)          # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tracking.SYNCS["count"] = 0
    system, records, created, _, m4 = slam_pass(cfg, frames, DEVICE)
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
    system0, records0, _, per_call, m0 = slam_pass(zcfg, frames, DEVICE)
    got_ins = np.flatnonzero(per_call).tolist()
    want_ins = np.flatnonzero(ref["ref_slam_kf_insert"]).tolist()
    if got_ins != want_ins:
        raise PhaseError(f"depth 0: inserts at {got_ins} vs the JAX run's "
                         f"{want_ins}")
    summary0 = hold_slam_run("depth 0", system0, records0, ref, "ref_slam_")
    phase("pipe", f"depth 0, the same frames: inserts at {got_ins} (= JAX);"
          f" {summary0}")
    pipe_rewind_phase(cfg, ref, frames)
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


def hold_bench_stream(label, got, ref, pre, rewinds):
    """A bench stream's first len(ref[pre + "fid"]) emitted [(frame id,
    pose or None)] and its rewinds over them against the JAX package's
    recording (ref_bench_*): ids, OK/None and rewinds equal, poses within
    the SLAM limits (the map is the port's own). Returns (worst deg, worst
    m)."""
    n = len(ref[pre + "fid"])
    fids = [f for f, _ in got[:n]]
    ok = [p is not None for _, p in got[:n]]
    if fids != ref[pre + "fid"].tolist() or ok != ref[pre + "ok"].tolist():
        raise PhaseError(f"{label}: emitted ids {fids[:4]}..{fids[-2:]} and "
                         f"{n - sum(ok)} None vs JAX's "
                         f"{ref[pre + 'fid'][:4].tolist()}.."
                         f"{ref[pre + 'fid'][-2:].tolist()} and "
                         f"{int((~ref[pre + 'ok']).sum())} None")
    if rewinds != int(ref[pre + "rewinds"]):
        raise PhaseError(f"{label}: {rewinds} rewinds over the first {n} "
                         f"frames vs JAX's {int(ref[pre + 'rewinds'])}")
    worst_r, worst_t = pose_errors([p for _, p in got[:n]], ref[pre + "R"],
                                   ref[pre + "t"])
    if worst_r > SLAM_ROT_TOL_DEG or worst_t > SLAM_TRANS_TOL_M:
        raise PhaseError(f"{label}: poses off JAX's by {worst_r:.4f} deg / "
                         f"{worst_t * 100:.4f} cm")
    return worst_r, worst_t


def bench_phase(path, cfg, ref):
    """bench_torch.py's workload at full size (bench.py's: 1024 timed
    stream frames, chunk 64, 30 BA iterations), held to the JAX package:
    the scene is ref_full's recorded one; the warm-up and the timed SLAM
    pass to ref_pipe_* as the pipe phase holds its pass; the warm-up chunk
    and the first frames of the timed stream to ref_bench_* (ids, OK/None,
    rewinds equal; poses within the SLAM limits), and all 1024 poses
    non-None and within the SLAM limits of JAX's pose for the same image at
    the same place in its chunk (recorded frame k % the recorded count);
    the 30-iteration whole-map BA on ref_full's own map (the JAX depth-4
    map) to JAX's: chi2 before and after within BENCH_CHI2_TOL, keyframe
    poses within the dist phase's R / t limits; K1-K3 once per frame built.
    Prints bench_torch's JSON line. Returns the kernel launch counts."""
    import numpy as np
    import torch

    import bench_torch
    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.pipeline import mapping, tracking
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    spec = json.loads(str(ref["ref_bench_spec"]))
    if (spec["chunk"], spec["n_timed"], spec["ba_iters"]) != (
            bench_torch.CHUNK, bench_torch.N_TIMED, bench_torch.BA_ITERS):
        raise PhaseError(f"the JAX recording's bench {spec} is not "
                         f"bench_torch's")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tracking.SYNCS["count"] = 0
    t0 = time.perf_counter()
    res = bench_torch.run(DEVICE)
    dt = time.perf_counter() - t0
    if res["cfg"] != cfg or not all(np.array_equal(a, b) for a, b in zip(
            res["frames"], render(cfg, ref, "ref_map_params"))):
        raise PhaseError("bench_torch's scene is not ref_full's recorded "
                         "scene")
    counts = dict(kernels.launch_counts)
    line = res["line"]
    phase("bench", f"kernel launches in the bench: {counts}")
    check_launches("bench", counts)
    check_frames_built("bench", counts, res["built"])

    for label, (system, records, created, _, m) in (
            ("warm-up SLAM pass", res["warm"]),
            ("timed SLAM pass", res["timed"])):
        if created != ref["ref_pipe_inserts"].tolist():
            raise PhaseError(f"bench {label}: keyframes created at frames "
                             f"{created} vs JAX's "
                             f"{ref['ref_pipe_inserts'].tolist()}")
        summary = hold_slam_run(f"bench {label}", system, records, ref,
                                "ref_pipe_")
        phase("bench", f"{label}: keyframes created at {created} (= JAX); "
              f"{summary}; slam_fps {m['slam_fps']:.4f}, p50 "
              f"{m['p50_ms']:.3f} ms, p90 {m['p90_ms']:.3f} ms, flush "
              f"{m['flush_ms']:.3f} ms")

    st = res["stream"]
    warm = st["warm"]
    wr, wt = hold_bench_stream("bench warm-up chunk", warm["out"], ref,
                               "ref_bench_warm_", warm["rewinds_at"][-1])
    n_rec = len(ref["ref_bench_fid"])
    sr, stt = hold_bench_stream("bench stream", st["out"], ref,
                                "ref_bench_", st["rewinds_at"][n_rec - 1])
    k = np.arange(len(st["out"])) % n_rec
    ar, at = pose_errors([p for _, p in st["out"]], ref["ref_bench_R"][k],
                         ref["ref_bench_t"][k])
    if ar > SLAM_ROT_TOL_DEG or at > SLAM_TRANS_TOL_M:
        raise PhaseError(f"bench stream: the {len(st['out'])} poses off "
                         f"JAX's for the same image by {ar:.4f} deg / "
                         f"{at * 100:.4f} cm")
    phase("bench", f"warm-up chunk: {len(warm['out'])} ids and OK/None "
          f"equal to JAX's, {warm['rewinds_at'][-1]} rewinds (= JAX), poses "
          f"within {wr:.5f} deg / {wt * 100:.5f} cm; the timed stream's "
          f"first {n_rec} frames: ids and OK/None equal, "
          f"{st['rewinds_at'][n_rec - 1]} rewinds (= JAX), poses within "
          f"{sr:.5f} deg / {stt * 100:.5f} cm; all {len(st['out'])} poses "
          f"non-None and within {ar:.5f} deg / {at * 100:.5f} cm of JAX's "
          f"for the same image; {st['rewinds']} rewinds in all, "
          f"{st['built']} frames built")
    phase("bench", f"stream: {line['value']:.4f} fps over {line['n_timed']}"
          f" frames ({st['seconds']:.2f} s), median chunk latency "
          f"{line['loc_chunk_latency_ms']:.1f} ms (bursts "
          f"{[round(b, 1) for b in st['bursts_ms']]} ms)")

    # the BA on the JAX depth-4 map against JAX's BA on it
    loaded = SlamSystem(cfg, device=DEVICE)
    loaded.load_map(path)
    ba = bench_torch.ba_rate(loaded, cfg)
    kw = dict(max_cams=cfg.map.max_keyframes,
              max_pts=min(bench_torch.BA_MAX_PTS, cfg.map.max_points),
              window_all=True)
    _, chi0 = mapping.bundle_adjust(loaded.map, loaded.ref_kf, loaded.cam,
                                    cfg, iters=0, **kw)
    chi0 = float(chi0)
    want0, want = float(ref["ref_bench_ba_chi0"]), float(
        ref["ref_bench_ba_chi"])
    live = ref["ref_bench_ba_kf"]
    got_live = np.flatnonzero(as_numpy(ba["state"].kf_valid))
    dR = float(np.abs(as_numpy(ba["state"].kf_Rcw)[live]
                      - ref["ref_bench_ba_kf_R"]).max())
    dt_ = float(np.abs(as_numpy(ba["state"].kf_tcw)[live]
                       - ref["ref_bench_ba_kf_t"]).max())
    if (got_live.tolist() != live.tolist()
            or abs(chi0 - want0) > BENCH_CHI2_TOL * want0
            or abs(ba["chi2"] - want) > BENCH_CHI2_TOL * want
            or dR > DIST_ROT_TOL or dt_ > DIST_TRANS_TOL):
        raise PhaseError(f"bench BA on ref_full's map: keyframes "
                         f"{got_live.tolist()} (JAX {live.tolist()}), chi2 "
                         f"{chi0:.6g} -> {ba['chi2']:.6g} (JAX {want0:.6g} "
                         f"-> {want:.6g}), keyframe poses off JAX's by R "
                         f"{dR:.2e} / t {dt_:.2e}")
    phase("bench", f"BA ({bench_torch.BA_ITERS} iterations, window_all, "
          f"{ba['cams_live']} live of {ba['cams_live'] + ba['cams_masked']} "
          f"camera slots: the CG branch) on ref_full's map: chi2 "
          f"{chi0:.6g} -> {ba['chi2']:.6g} (JAX {want0:.6g} -> {want:.6g}),"
          f" keyframe poses within R {dR:.2e} / t {dt_:.2e} of JAX's; "
          f"{ba['ba_iters_per_s']:.3f} iterations/s; on the warm system's "
          f"map {line['ba_iters_per_s']:.3f} iterations/s "
          f"({line['ba_cams_live']} live, {line['ba_cams_masked']} masked "
          f"slots)")
    phase("bench", "idle share (torch.profiler, untimed runs): " + "; ".join(
        f"{label} {line[f'idle_share_{k}']} ({line[f'idle_{k}_device_events']}"
        f" device events, busy {line[f'idle_{k}_busy_s']} s of a "
        f"{line[f'idle_{k}_window_s']:.3f} s window)"
        for label, k in (("SLAM pass", "slam"), ("two stream chunks",
                                                 "stream")))
        + f"; host syncs {tracking.SYNCS['count']}; the bench took "
        f"{dt:.1f} s")
    print(json.dumps(line), flush=True)
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


def run_loop_scene(cfg, ref, steps, probe=None, mesh=None):
    """The SLAM system over the loop scene's steps with the drift injected
    after frame LOOP_INJECT and keyframe_trajectory() after the pan:
    (system, poses, states, inserts, (fids, R, t) after the drain, valid
    points after the drain)). probe(i, step_fn) runs each step (timing or
    sync counting). mesh: the device list of the distributed global BA
    (cfg.optim.distributed_gba)."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch.geometry.lie import so3_exp
    from orb_slam2_aruco_tpu_torch.io import synthetic
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    system = SlamSystem(cfg, device=DEVICE)
    system._gba_mesh = mesh
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


@contextlib.contextmanager
def loop_recorder():
    """Record, while the loop scene runs: the loops (step, keyframe, loop
    keyframe, by marker, s, R, t), the relocalizations' kind by step and
    the time of each correction, GBA slice and insert. Yields the record;
    rec["cur"][0] must hold the current step."""
    import torch

    from orb_slam2_aruco_tpu_torch.pipeline import loop_closing, tracking
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    rec = {"loops": [], "kind": [], "cur": [0], "reloc_kind": {},
           "times": collections.defaultdict(list)}
    real = {n: getattr(loop_closing, n) for n in
            ("correct_loop", "compute_sim3", "compute_sim3_classic")}
    real_sys = {n: getattr(SlamSystem, n) for n in
                ("_gba_slice", "_insert_keyframe", "_relocalize")}

    def relocalize(self, frame, fid, ts):
        # by marker when the marker pose candidate holds (the JAX run's
        # record of the same question)
        slots = tracking.bind_markers(self.map, frame)
        ok = tracking.aruco_pose_candidate(self.map, frame, slots, self.cam,
                                           self.cfg)[0]
        before = self.stats["reloc"]
        out = real_sys["_relocalize"](self, frame, fid, ts)
        if self.stats["reloc"] > before:
            rec["reloc_kind"][rec["cur"][0]] = int(bool(ok))
        return out

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec["times"][key].append(time.perf_counter() - t)
            return out
        return run

    def correct(state, k, kf_loop, s, R, t, *a, **kw):
        rec["loops"].append((rec["cur"][0], k, kf_loop, rec["kind"][-1],
                             float(s), R.cpu().numpy(), t.cpu().numpy()))
        return real["correct_loop"](state, k, kf_loop, s, R, t, *a, **kw)

    def sim3(name, by_marker):
        def run(*a, **kw):
            rec["kind"].append(by_marker)
            return real[name](*a, **kw)
        return run

    loop_closing.correct_loop = timed("correction", correct)
    loop_closing.compute_sim3 = sim3("compute_sim3", 1)
    loop_closing.compute_sim3_classic = sim3("compute_sim3_classic", 0)
    SlamSystem._gba_slice = timed("gba", real_sys["_gba_slice"])
    SlamSystem._insert_keyframe = timed("insert",
                                        real_sys["_insert_keyframe"])
    SlamSystem._relocalize = relocalize
    try:
        yield rec
    finally:
        for n, fn in real.items():
            setattr(loop_closing, n, fn)
        for n, fn in real_sys.items():
            setattr(SlamSystem, n, fn)


@contextlib.contextmanager
def gba_capture():
    """Record what the first GBA slice starts from while the loop scene
    runs: yields a list that then holds (a copy of the map, the last
    keyframe slot, the bucket, the point offset). The copy is taken outside
    every timed run."""
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    real = SlamSystem._gba_slice
    got = []

    def gba_slice(self):
        if not got:
            got.append((type(self.map)(*(t.clone() for t in self.map)),
                        self.last_kf_slot, self._gba_shape,
                        self._gba_pt_offset))
        return real(self)

    SlamSystem._gba_slice = gba_slice
    try:
        yield got
    finally:
        SlamSystem._gba_slice = real


def hold_loop_run(ref, gt, steps, system, poses, states, inserts, traj,
                  rec):
    """Hold a run of the loop scene to the JAX package's recorded run (the
    loop phase's limits). Returns a summary line."""
    import numpy as np

    from orb_slam2_aruco_tpu_torch.io import trajectory

    loops, reloc_kind = rec["loops"], rec["reloc_kind"]
    n = len(ref["params"])
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
    return (f"{len(steps)} steps ({n} pan frames, extra "
            f"{ref['extra'].tolist()}): states, inserts ({len(got_ins)}), "
            f"keyframes ({len(fids)}) and loops {got_loops} equal to JAX "
            f"(post-loop GBA over {gba_cams} camera slots: CG beyond 32); "
            f"Sim3s within {sim3_r:.5f} deg / {sim3_t * 100:.5f} cm; "
            f"keyframe poses after the drain within {kf_r:.5f} deg / "
            f"{kf_t * 100:.5f} cm; {n_points} valid points (JAX "
            f"{want_pts}); seam {seam * 1000:.3f} mm (JAX "
            f"{ref_seam * 1000:.3f} mm); BoW-PnP relocalization at steps "
            f"{bow} within {rl_r:.5f} deg / {rl_t * 100:.5f} cm of JAX's; "
            f"the start-area frame (step {last}) relocalized by marker "
            f"(JAX's recorded run: lost)")


def loop_phase():
    """SLAM mode with loop closing and relocalization over the loop scene
    against the JAX package's recorded run. Returns the kernel launch
    counts of the timed run and what the first GBA slice of the untimed
    sync-counting run started from (gba_capture)."""
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.pipeline import tracking

    cfg, ref, imgs, gt = loop_reference()
    steps = loop_frames(ref, imgs)
    frame_s = []
    with loop_recorder() as rec:
        def probe(i, step):
            rec["cur"][0] = i
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        tracking.SYNCS["count"] = 0
        system, poses, states, inserts, traj = run_loop_scene(
            cfg, ref, steps, probe)
        counts = dict(kernels.launch_counts)
        syncs = tracking.SYNCS["count"]
    phase("loop", f"kernel launches in the loop scene: {counts}")
    check_launches("loop", counts)
    check_frames_built("loop", counts, len(steps))
    phase("loop", hold_loop_run(ref, gt, steps, system, poses, states,
                                inserts, traj, rec))

    n = len(imgs)
    times = rec["times"]
    loop_step = rec["loops"][0][0]
    tracked = [frame_s[i] for i in range(n) if states[i] == 2
               and i != loop_step]
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

    with gba_capture() as gba_input:
        states2 = run_loop_scene(cfg, ref, steps, count)[2]
    if not gba_input:
        raise PhaseError("the loop scene ran no GBA slice")
    n_sync = sum(per_step)
    phase("loop", f"sync debug mode, the {len(steps)} steps again: {n_sync} "
          f"synchronizing calls; per step {per_step}; states "
          f"{'as' if states2.tolist() == states.tolist() else 'unlike'} the "
          f"timed run's; by site: {sites(where)}")
    if n_sync > MAX_LOOP_SYNCS:
        raise PhaseError(f"{n_sync} synchronizing calls in the loop scene, "
                         f"above {MAX_LOOP_SYNCS}")
    return counts, gba_input[0]


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (index_add_ sums in a fixed order on
    the card), warnings only where an op has no deterministic form."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def median_ms(fn, reps=3):
    """Median wall milliseconds of fn(), synchronized around each call."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dist_phase(gba_input):
    """The distributed global BA over device lists of one card (every entry
    cuda:0: the cost of sharding, not scaling): distributed_ba_solve and
    bundle_adjust_distributed on the problem of the loop scene's first GBA
    slice (gba_input: right after the loop correction; its bucket takes
    the CG branch) against the single-device solve, then the loop scene through
    SlamSystem with optim.distributed_gba over a DIST_SYSTEM_MESH-entry
    list, held to the JAX run as the loop phase holds it. Returns the
    kernel launch counts of that run."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.optim import ba
    from orb_slam2_aruco_tpu_torch.parallel import dist_ba
    from orb_slam2_aruco_tpu_torch.pipeline import mapping

    cfg, ref, imgs, gt = loop_reference()
    state, center, (cams, pts), offset = gba_input
    cam = camera_from_config(cfg.camera, DEVICE)
    kw = dict(iters=cfg.optim.gba_slice_iters,
              huber_delta=cfg.optim.huber_delta,
              lam0=cfg.optim.lm_lambda_init)
    bkw = dict(max_cams=cams, max_pts=pts, iters=kw["iters"],
               pt_offset=offset)
    prob = mapping.build_ba_problem(state, center, cfg, max_cams=cams,
                                    max_pts=pts, window_all=True,
                                    pt_offset=offset)[0]
    if prob.Rcw.shape[0] <= ba.DENSE_MAX_CAMS:
        raise PhaseError(f"the GBA bucket ({cams} cameras) does not take the "
                         f"CG branch")
    n_edges = int(prob.e_mask.sum())
    chi2_0 = float(ba._total_chi2(prob, cam)[0])
    single = ba.ba_solve(prob, cam, **kw)
    moved = float((single.points - prob.points).abs().max())
    if not (float(single.chi2) < chi2_0 and moved > 10 * DIST_PTS_TOL):
        raise PhaseError(f"the GBA problem does not move (chi2 {chi2_0:.6g} "
                         f"-> {float(single.chi2):.6g}, points by "
                         f"{moved:.2e}): comparing solves would hold nothing")
    def worst(a, b):
        return float((a - b).abs().max())

    again = ba.ba_solve(prob, cam, **kw)
    repeat = all(torch.equal(a, b) for a, b in zip(single, again))
    # the sharded code (shard_problem, the per-shard sums) on one shard:
    # ba_solve's mesh argument, not distributed_ba_solve, which hands a
    # 1-entry mesh to ba_solve as it is
    with deterministic():
        det = ba.ba_solve(prob, cam, **kw)
        one = ba.ba_solve(prob, cam, mesh=dist_ba.make_mesh(devices=[DEVICE]),
                          **kw)
    differ = [f for f, a, b in zip(ba.BAResult._fields, one, det)
              if not torch.equal(a, b)]
    if differ:
        raise PhaseError(f"ba_solve on a 1-entry mesh differs from ba_solve "
                         f"in {differ} (deterministic algorithms)")
    st_single, _ = mapping.bundle_adjust(state, center, cam, cfg,
                                         window_all=True, **bkw)
    # what the summation order alone moves: a second call of the same
    # single-device solve (index_add_'s atomic order) and the solve with
    # its edges in the 8-entry partition's order
    perm = dist_ba.partition_edges_by_point(prob, 8)[0]
    reordered = ba.ba_solve(perm, cam, **kw)
    witness = (f"the single-device solve moves its points by "
               f"{worst(again.points, single.points):.2e} when called again "
               f"and by {worst(reordered.points, single.points):.2e} with "
               f"its edges reordered (R / t "
               f"{worst(reordered.Rcw, single.Rcw):.2e} / "
               f"{worst(reordered.tcw, single.tcw):.2e})")

    def held(label, R, t, P, R0, t0, P0):
        """R and t within JAX's limits; the points as JAX's own map-level
        test holds them (DIST_PTS_SHARE within DIST_PTS_TOL)."""
        dp = (P - P0).abs().max(dim=-1).values
        err = (worst(R, R0), worst(t, t0), float(dp.max()),
               float((dp <= DIST_PTS_TOL).float().mean()))
        if not (err[0] <= DIST_ROT_TOL and err[1] <= DIST_TRANS_TOL
                and err[3] >= DIST_PTS_SHARE):
            raise PhaseError(f"{label} off the single-device result: R "
                             f"{err[0]:.2e}, t {err[1]:.2e}, points worst "
                             f"{err[2]:.2e}, {err[3]:.2%} within "
                             f"{DIST_PTS_TOL}; {witness}")
        return (f"R / t {err[0]:.2e} / {err[1]:.2e}, points worst "
                f"{err[2]:.2e} ({err[3]:.2%} within {DIST_PTS_TOL})")

    rows = []
    for n in DIST_MESHES:
        mesh = dist_ba.make_mesh(devices=[DEVICE] * n)
        out = dist_ba.distributed_ba_solve(prob, cam, mesh, **kw)
        solve_msg = held(f"distributed_ba_solve on {n} entries", out.Rcw,
                         out.tcw, out.points, single.Rcw, single.tcw,
                         single.points)
        # edge_chi2 in the caller's order: the chi2 of each original edge
        # at the returned state (float32 rounding of the recomputation:
        # 1e-3 absolute and relative; an edge out of order is off by its
        # whole chi2)
        c_e = ba._total_chi2(prob._replace(
            Rcw=out.Rcw, tcw=out.tcw, points=out.points, Rwm=out.Rwm,
            twm=out.twm), cam)[1]
        if out.edge_chi2.shape != c_e.shape:
            raise PhaseError(f"{n} entries: edge_chi2 of shape "
                             f"{tuple(out.edge_chi2.shape)}")
        chi_err = (out.edge_chi2 - c_e).abs()
        off = chi_err > 1e-3 + 1e-3 * c_e.abs()
        if bool(off.any()):
            raise PhaseError(
                f"{n} entries: edge_chi2 is not in the caller's edge order: "
                f"{int(off.sum())} of {c_e.shape[0]} edges off, worst "
                f"{float(chi_err.max()):.3e}")
        st, _ = mapping.bundle_adjust_distributed(state, center, cam, cfg,
                                                  mesh, **bkw)
        map_msg = held(f"bundle_adjust_distributed on {n} entries",
                       st.kf_Rcw, st.kf_tcw, st.pt_xyz, st_single.kf_Rcw,
                       st_single.kf_tcw, st_single.pt_xyz)
        t0 = time.perf_counter()
        dist_ba.partition_edges_by_point(prob, n)
        part_ms = (time.perf_counter() - t0) * 1e3
        ms = median_ms(lambda: dist_ba.distributed_ba_solve(
            prob, cam, mesh, **kw), reps=5)
        rows.append(f"{n}: {ms:.1f} ms per solve, partition "
                    f"{part_ms:.1f} ms on the host; solve {solve_msg}; map "
                    f"{map_msg}; edge_chi2 in the caller's order within "
                    f"{float(chi_err.max()):.1e}")
    single_ms = median_ms(lambda: ba.ba_solve(prob, cam, **kw), reps=5)
    phase("dist", f"the loop scene's first GBA slice problem: "
          f"{prob.Rcw.shape[0]} camera slots, {prob.points.shape[0]} "
          f"points, {n_edges} live point edges of {prob.e_kf.shape[0]}, "
          f"{kw['iters']} LM iterations (CG), chi2 {chi2_0:.6g} -> "
          f"{float(single.chi2):.6g}, points moved up to {moved:.3f} m; "
          f"ba_solve {single_ms:.1f} ms, "
          f"two calls {'bit-equal' if repeat else 'NOT bit-equal'} "
          f"(index_add_ order); ba_solve's sharded path on a 1-entry mesh "
          f"bit-equal to ba_solve under deterministic algorithms; "
          f"{witness}; per mesh of cuda:0 "
          f"entries "
          f"(one card repeated: the cost of sharding, not scaling): "
          + "; ".join(rows))

    dcfg = cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                 distributed_gba=True))
    steps = loop_frames(ref, imgs)
    with loop_recorder() as rec:
        def probe(i, step):
            rec["cur"][0] = i
            step()

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        system, poses, states, inserts, traj = run_loop_scene(
            dcfg, ref, steps, probe,
            mesh=dist_ba.make_mesh(devices=[DEVICE] * DIST_SYSTEM_MESH))
        counts = dict(kernels.launch_counts)
    phase("dist", f"kernel launches in the loop scene with the distributed "
          f"GBA: {counts}")
    check_launches("dist", counts)
    check_frames_built("dist", counts, len(steps))
    n_slices = system.stats.get("gba_slices", 0)
    if not n_slices or system.stats.get("gba_slices_distributed") != n_slices:
        raise PhaseError(f"the distributed branch did not run every GBA "
                         f"slice: stats {system.stats}")
    phase("dist", f"SlamSystem with distributed_gba over {DIST_SYSTEM_MESH} "
          f"entries of cuda:0: {n_slices} GBA slices, all distributed, "
          f"{[round(v * 1000, 1) for v in rec['times']['gba']]} ms; "
          + hold_loop_run(ref, gt, steps, system, poses, states, inserts,
                          traj, rec))
    return counts


def solve_errors(got, want, pts_tol=DIST_PTS_TOL):
    """(chi2 relative difference, R worst, t worst, points worst, share of
    points within pts_tol) of one BA result (Rcw, tcw, points, chi2:
    tensors or arrays) against another."""
    import numpy as np

    g = [np.asarray(as_numpy(x), np.float64) for x in got]
    w = [np.asarray(as_numpy(x), np.float64) for x in want]
    dp = np.abs(g[2] - w[2]).max(axis=-1)
    return (abs(float(g[3]) - float(w[3])) / abs(float(w[3])),
            float(np.abs(g[0] - w[0]).max()),
            float(np.abs(g[1] - w[1]).max()), float(dp.max()),
            float((dp <= pts_tol).mean()))


def hold_graft_solve(label, got, want, chi2_tol):
    """A capacity solve (Rcw, tcw, points, chi2) against a reference: chi2
    within chi2_tol relative, R and t within DIST_ROT_TOL / DIST_TRANS_TOL,
    DIST_PTS_SHARE of the points within DIST_PTS_TOL. Returns the errors as
    text; raises PhaseError off the limits."""
    err = solve_errors(got, want)
    msg = (f"chi2 {err[0]:.2%} (limit {chi2_tol:.2%}), R / t {err[1]:.2e} / "
           f"{err[2]:.2e}, points worst {err[3]:.2e} ({err[4]:.4%} within "
           f"{DIST_PTS_TOL})")
    if not (err[0] <= chi2_tol and err[1] <= DIST_ROT_TOL
            and err[2] <= DIST_TRANS_TOL and err[4] >= DIST_PTS_SHARE):
        raise PhaseError(f"{label} off: {msg}")
    return msg


def hold_graft_entry(ref, frame, R, t, n_in):
    """The flagship step against JAX's recording: the frame's valid
    keypoints, octaves and descriptors equal, pixels within
    GRAFT_KP_TOL_PX, n_inliers equal, pose within ROT_TOL_DEG /
    TRANS_TOL_M."""
    import numpy as np

    valid = as_numpy(frame.kp_valid)
    if not np.array_equal(valid, ref["entry_valid"]):
        raise PhaseError(f"entry step: {int(valid.sum())} valid keypoints, "
                         f"JAX {int(ref['entry_valid'].sum())}, or another "
                         f"mask")
    differ = [k for k, a, b in (
        ("octaves", as_numpy(frame.kp_octave)[valid], ref["entry_octave"]),
        ("descriptors", as_numpy(frame.desc)[valid], ref["entry_desc"]))
        if not np.array_equal(a, b)]
    d_uv = float(np.abs(as_numpy(frame.kp_uv)[valid]
                        - ref["entry_uv"]).max())
    if differ or d_uv > GRAFT_KP_TOL_PX:
        raise PhaseError(f"entry step: {differ} differ from JAX's, pixels "
                         f"by up to {d_uv:.2e}")
    dR = rot_err_deg(as_numpy(R), ref["entry_R"])
    dt = float(np.linalg.norm(as_numpy(t) - ref["entry_t"]))
    if (int(n_in) != int(ref["entry_n_inliers"]) or dR > ROT_TOL_DEG
            or dt > TRANS_TOL_M):
        raise PhaseError(f"entry step: n_inliers {int(n_in)} (JAX "
                         f"{int(ref['entry_n_inliers'])}), pose {dR:.4f} deg "
                         f"/ {dt * 100:.4f} cm off")
    return (f"{int(valid.sum())} valid keypoints, octaves and descriptors "
            f"equal to JAX's, pixels within {d_uv:.1e}; n_inliers "
            f"{int(n_in)}; pose {dR:.2e} deg / {dt * 100:.2e} cm")


def graft_phase():
    """graft_entry_torch.py on the card: the flagship step (entry(): one
    540x960 noise frame through make_frame, bind_markers and
    track_local_map against a capacity map of 512 points) held to JAX's
    recording and timed; the capacity global BA (make_gba_problem(256,
    20000, 16)): its index digest and chi2 before the solve against JAX's,
    ba_solve(iters=2) (the CG branch) and dryrun_multichip over
    DIST_MESHES entries of cuda:0 against JAX's solves with exact segment
    sums (data/ref_graft.npz), the 1-entry sharded path bit-equal to
    ba_solve under deterministic algorithms; ms per LM iteration for each
    mesh and the host ms of the edge partition. Returns the kernel launch
    counts of one step."""
    import numpy as np
    import torch

    import graft_entry_torch as tg
    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.optim import ba
    from orb_slam2_aruco_tpu_torch.parallel import dist_ba
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    t_phase = time.perf_counter()
    with np.load(os.path.join(HERE, PKG, "data", "ref_graft.npz")) as z:
        ref = {k: z[k] for k in z.files}

    step, args = tg.entry(DEVICE)
    step(*args)
    cfg = tg._flagship_config()
    frame = make_frame(args[0], camera_from_config(cfg.camera, DEVICE), cfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    R, t, n_in = step(*args)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    check_launches("graft", counts)
    check_frames_built("graft", counts, 1)
    entry_msg = hold_graft_entry(ref, frame, R, t, n_in)
    entry_ms = median_ms(lambda: step(*args), reps=5)
    phase("graft", f"entry step (540x960 noise frame, detect_downsample "
          f"{cfg.aruco.detect_downsample}): {entry_msg}; K1-K3 once each; "
          f"{entry_ms:.2f} ms per step")

    prob, cam = tg.make_gba_problem(tg.GBA_K, tg.GBA_L, tg.GBA_M,
                                    device=DEVICE)
    dig = tg.problem_digest(prob)
    want = (ref["prob_sums"].tolist(), ref["prob_sha"].tolist())
    got = ([dig[f][0] for f in ref["prob_fields"]],
           [dig[f][1] for f in ref["prob_fields"]])
    if got != want:
        raise PhaseError(f"the capacity problem's index digest differs from "
                         f"JAX's: {got} against {want}")
    chi2_0 = float(ba._total_chi2(prob, cam)[0])
    d0 = abs(chi2_0 - float(ref["prob_chi2_0"])) / float(ref["prob_chi2_0"])
    if d0 > GRAFT_CHI2_0_TOL:
        raise PhaseError(f"the capacity problem's chi2 before the solve "
                         f"{chi2_0:.9g} is {d0:.2e} off JAX's "
                         f"{float(ref['prob_chi2_0']):.9g} (one ulp on JAX's "
                         f"poses moves it {float(ref['witness_chi2_0']):.2e})")
    E = int(prob.e_kf.shape[0])
    if prob.Rcw.shape[0] <= ba.DENSE_MAX_CAMS:
        raise PhaseError("the capacity problem does not take the CG branch")

    iters = tg.DRYRUN_ITERS
    chi2_tol = 2 * float(ref["witness_chi2"])

    def fields(o):
        return (o.Rcw, o.tcw, o.points, o.chi2)

    def exact(pre):
        return tuple(ref[pre + k] for k in ("R", "t", "P", "chi2"))

    single = ba.ba_solve(prob, cam, iters=iters)
    again = ba.ba_solve(prob, cam, iters=iters)
    spread = solve_errors(fields(again), fields(single))
    single_msg = hold_graft_solve("ba_solve at capacity", fields(single),
                                  exact("exact_single_"), chi2_tol)
    shipped = solve_errors(fields(single), (
        ref["shipped_single_R"], ref["shipped_single_t"],
        as_numpy(prob.points), ref["shipped_single_chi2"]))
    flung = float(np.abs(ref["shipped_dist8_t"] - as_numpy(prob.tcw)).max())
    with deterministic():
        det = ba.ba_solve(prob, cam, iters=iters)
        one = ba.ba_solve(prob, cam, iters=iters,
                          mesh=dist_ba.make_mesh(devices=[DEVICE]))
    differ = [f for f, a, b in zip(ba.BAResult._fields, one, det)
              if not torch.equal(a, b)]
    if differ:
        raise PhaseError(f"ba_solve on a 1-entry mesh differs from ba_solve "
                         f"at capacity in {differ} (deterministic "
                         f"algorithms)")
    single_ms = median_ms(lambda: ba.ba_solve(prob, cam, iters=iters),
                          reps=5) / iters
    rows = []
    for n in DIST_MESHES:
        out = tg.dryrun_multichip(n, [DEVICE] * n)
        vs_jax = hold_graft_solve(f"dryrun_multichip({n}) against JAX's "
                                  f"8-device solve", fields(out),
                                  exact("exact_dist8_"), chi2_tol)
        vs_single = hold_graft_solve(f"dryrun_multichip({n}) against the "
                                     f"port's ba_solve", fields(out),
                                     fields(single), chi2_tol)
        mesh = dist_ba.make_mesh(devices=[DEVICE] * n)
        t0 = time.perf_counter()
        dist_ba.partition_edges_by_point(prob, n)
        part_ms = (time.perf_counter() - t0) * 1e3
        ms = median_ms(lambda: dist_ba.distributed_ba_solve(
            prob, cam, mesh, iters=iters), reps=3) / iters
        rows.append(f"{n}: {ms:.2f} ms per LM iteration "
                    f"({1e3 / ms:.2f} iterations/s), partition "
                    f"{part_ms:.1f} ms on the "
                    f"host; against JAX {vs_jax}; against ba_solve "
                    f"{vs_single}")
    phase("graft", f"capacity global BA: K={tg.GBA_K} L={tg.GBA_L} "
          f"M={tg.GBA_M}, {E} point edges, index digest equal to JAX's, chi2 "
          f"before {chi2_0:.9g} ({d0:.2e} off JAX's); ba_solve({iters} LM "
          f"iterations, CG) {single_ms:.2f} ms per LM iteration "
          f"({1e3 / single_ms:.2f} iterations/s), chi2 -> "
          f"{float(single.chi2):.6g}, against JAX's exact-sum solve "
          f"{single_msg}; two calls differ by chi2 {spread[0]:.2%}, points "
          f"worst {spread[3]:.2e} ({spread[4]:.4%} within {DIST_PTS_TOL}); "
          f"JAX as shipped (cumsum segment sums) rejects both steps: the "
          f"port's chi2 is {shipped[0]:.2%} off its, points moved up to "
          f"{shipped[3]:.3f} m (its 8-device solve moves cameras by "
          f"{flung:.3g} m); one ulp moves JAX's own solve's chi2 by "
          f"{float(ref['witness_chi2']):.2%}; the 1-entry sharded path "
          f"bit-equal to ba_solve (deterministic); per mesh of cuda:0 "
          f"entries (one card repeated: the cost of sharding, not scaling): "
          + "; ".join(rows))
    phase("graft", f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def video_phase():
    """The real-footage entry point on the card: the port's mono_video CLI
    path (`run`) over the recorded 25h7 fly-by (data/ref_video.npz, as the
    JAX VideoSource decoded it) with the camera from an ORB-SLAM yml, two
    passes, the viewer, save_map and the map view, held to the JAX CLI's
    recorded run. Returns the kernel launch counts of the run."""
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from bench_torch import slam_pass

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.examples import mono_synthetic, mono_video
    from orb_slam2_aruco_tpu_torch.io import checkpoint, ingest, trajectory
    from orb_slam2_aruco_tpu_torch.viz import framedrawer

    with np.load(os.path.join(HERE, PKG, "data", "ref_video.npz")) as z:
        ref = {k: z[k] for k in z.files}
    frames, K = ref["frames"], ref["K"]
    n = len(frames)
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
        for src in (ingest.VideoSource("seq.avi", ingest.CameraConfig()),
                    ingest.ImageFolderSource(HERE, ingest.CameraConfig())):
            try:
                list(src)
            except ImportError as e:
                if "needs opencv-python" not in str(e):
                    raise
            else:
                raise PhaseError(f"{type(src).__name__} ran without cv2")
    with tempfile.TemporaryDirectory() as tmp:
        yml = os.path.join(tmp, "camera.yaml")
        with open(yml, "w") as f:
            fx, fy, cx, cy = (float(v) for v in (K[0, 0], K[1, 1], K[0, 2],
                                                 K[1, 2]))
            f.write(f"%YAML:1.0\nCamera.fx: {fx!r}\nCamera.fy: {fy!r}\n"
                    f"Camera.cx: {cx!r}\nCamera.cy: {cy!r}\n"
                    f"Camera.width: {frames.shape[2]}\n"
                    f"Camera.height: {frames.shape[1]}\nCamera.fps: 30.0\n")
        out_tum = os.path.join(tmp, "traj.tum")
        args = mono_video.parse_args(
            ["--video", os.path.join(tmp, "recorded.avi"), "--camera", yml,
             "--out", out_tum, "--kf-out", os.path.join(tmp, "kf.tum"),
             "--save-map", os.path.join(tmp, "map.npz"), "--viewer", "0",
             "--device", DEVICE] + json.loads(str(ref["args"])))
        camc = ingest.camera_from_slam_yaml(yml)
        if mono_video.load_camera(args) != camc or (camc.fx, camc.cy) != (
                K[0, 0], K[1, 2]):
            raise PhaseError(f"camera file read as {camc}")
        cfg = mono_video.make_config(camc, args)
        log = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            out = mono_video.run(cfg, zip(frames, ref["ts"].tolist()), args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launch_counts)
        slam, viewer = out["system"], out["viewer"]
        try:
            base = f"http://127.0.0.1:{viewer.port}"
            snap = json.loads(urllib.request.urlopen(base + "/state",
                                                     timeout=10).read())
            png = urllib.request.urlopen(base + "/frame.png",
                                         timeout=10).read()
            req = urllib.request.Request(
                base + "/control", method="POST",
                data=json.dumps({"cmd": "reset", "value": True}).encode(),
                headers={"Origin": "http://elsewhere.example"})
            try:
                urllib.request.urlopen(req, timeout=10)
                raise PhaseError("the viewer accepted a cross-origin POST")
            except urllib.error.HTTPError as e:
                if e.code != 403:
                    raise PhaseError(f"cross-origin POST: HTTP {e.code}")
            if viewer.poll_controls():
                raise PhaseError("a refused POST reached the controls")
        finally:
            viewer.close()
        if (not snap["map"]["kf_centers"] or not snap["map"]["points"]
                or png[:4] != b"\x89PNG"):
            raise PhaseError(f"viewer snapshot with "
                             f"{len(snap['map']['kf_centers'])} keyframes, "
                             f"{len(snap['map']['points'])} points, frame "
                             f"{png[:8]!r}")
        view = mono_synthetic.save_views(slam.map, tmp)
        with open(view, "rb") as f:
            if f.read() != framedrawer.encode_png(
                    framedrawer.draw_map_topdown(slam.map)):
                raise PhaseError("the saved map view is not the map's")
        saved = checkpoint.load_map(os.path.join(tmp, "map.npz"), DEVICE)
        differ = [f for f in slam.map._fields if not torch.equal(
            getattr(saved, f), getattr(slam.map, f))]
        if differ:
            raise PhaseError(f"save_map -> load_map differs in {differ}")
        n_tum = len(trajectory.load_tum(out_tum)[0])
    phase("video", f"kernel launches in the CLI run: {counts}")
    check_launches("video", counts)
    check_frames_built("video", counts, 2 * n)

    state = np.full(n, -1, np.int32)
    for r in slam.get_trajectory():
        if r.frame_id < n:
            state[r.frame_id] = r.state.value
    fids = slam.keyframe_trajectory()[0]
    if (state.tolist() != ref["state"].tolist()
            or slam.n_keyframes != int(ref["n_kf"])
            or fids.tolist() != ref["kf_fid"].tolist()):
        raise PhaseError(f"pass 1: states {state.tolist()}, keyframes "
                         f"{fids.tolist()} vs the JAX CLI's "
                         f"{ref['state'].tolist()}, {ref['kf_fid'].tolist()}")
    ok = np.asarray([p is not None for p in out["pass2"]])
    if ok.tolist() != ref["pass2_ok"].tolist() or n_tum != int(ok.sum()):
        raise PhaseError(f"pass 2 tracked {ok.astype(int).tolist()} vs the "
                         f"JAX CLI's {ref['pass2_ok'].astype(int).tolist()}")
    r2, t2 = pose_errors(out["pass2"], ref["pass2_R"], ref["pass2_t"])
    if r2 > SLAM_ROT_TOL_DEG or t2 > SLAM_TRANS_TOL_M:
        raise PhaseError(f"pass-2 poses off the JAX CLI's: {r2:.4f} deg, "
                         f"{t2 * 100:.4f} cm")
    R = np.stack([np.asarray(p[0]) for p in out["pass2"] if p is not None])
    t = np.stack([np.asarray(p[1]) for p in out["pass2"] if p is not None])
    ate = trajectory.ate_rmse(
        trajectory.camera_centers(R, t),
        trajectory.camera_centers(ref["gt_R"][ok], ref["gt_t"][ok]),
        align=True, with_scale=False)
    want = float(ref["ate"])
    if not (ate <= max(1.5 * want, want + 0.005) and ate < 0.12):
        raise PhaseError(f"pass-2 ATE {ate * 100:.3f} cm (JAX "
                         f"{want * 100:.3f} cm; limit max(1.5 x, +5 mm), "
                         f"< 12 cm)")
    timers = [ln.strip() for ln in log.getvalue().replace("\r", "\n")
              .splitlines() if "tracking time" in ln]
    phase("video", f"cv2 {'importable' if has_cv2 else 'absent: VideoSource'
          ' and ImageFolderSource raise its ImportError'}; mono_video.run "
          f"over the recorded {n} frames ({frames.shape[2]}x"
          f"{frames.shape[1]}, {' '.join(json.loads(str(ref['args'])))}, "
          f"camera from an ORB-SLAM yml): pass-1 states and keyframes "
          f"{fids.tolist()} equal to the JAX CLI's; pass 2 {int(ok.sum())}/"
          f"{n} tracked (= JAX) within {r2:.5f} deg / {t2 * 100:.5f} cm; ATE "
          f"{ate * 100:.3f} cm (JAX {want * 100:.3f} cm); viewer: snapshot "
          f"({len(snap['map']['points'])} points) and frame served, the "
          f"cross-origin POST refused; save_map reloads equal; map view "
          f"PNG written; {wall:.1f} s; {' | '.join(timers)}")
    return counts


# the api phase: decoded marker corners against the JAX recording (px);
# the IC angles against the port's CPU result where the moment vector is
# above ANGLE_MAG_SHARE of its largest (rad); pixels this close to the
# image edge (the 3-px border band and its 3x3 NMS neighbourhood) where
# the XLA FAST route may differ from K1, and its values elsewhere (summed
# in another order) relative
API_CORNER_TOL_PX = 0.05
API_ANGLE_TOL_RAD = 1e-4
ANGLE_MAG_SHARE = 1e-3
FAST_BORDER_PX = 4
FAST_ROUTE_RTOL = 1e-5
# keypoints per detect_level call and SPD systems per solve in the api
# phase's timings
API_KPS = 1000
API_SOLVES = 1024


def api_phase(cfg, img_np, smi):
    """The public per-frame functions the fused paths fold away, and the
    generated dictionaries, on the card. Returns the kernel launch counts
    of this run."""
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch import kernels
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.ops import fast, image, matching, orb
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector, native
    from orb_slam2_aruco_tpu_torch.optim import lm
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    with np.load(os.path.join(HERE, PKG, "data", "ref_dicts.npz")) as z:
        rec = {k: z[k] for k in z.files}
    scenes = sorted(k[:-len("_frame")] for k in rec if k.endswith("_frame"))
    ocfg, acfg = cfg.orb, cfg.aruco
    t_args = (ocfg.fast_threshold, ocfg.fast_min_threshold)
    det_args = (*t_args, ocfg.cell_size, 8, API_KPS, ocfg.patch_radius + 1)
    gray = torch.as_tensor(img_np).to(DEVICE).float()
    blurred = image.gaussian_blur(gray, ocfg.blur_ksize, ocfg.blur_sigma)
    cam = camera_from_config(cfg.camera, DEVICE)
    dcfg = {d: cfg.replace(aruco=dataclasses.replace(acfg, dictionary=d))
            for d in scenes}
    dimg = {d: torch.as_tensor(rec[f"{d}_frame"]).to(DEVICE) for d in scenes}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    # the path: the generated dictionaries' worlds through make_frame, the
    # three detect_level routes, keypoint_angles and describe
    frames = {d: make_frame(dimg[d], cam, dcfg[d]) for d in scenes}
    routes = {r: fast.detect_level(gray, *det_args, use_pallas=r)
              for r in (None, True, False)}
    xy = routes[None].xy
    angles = orb.keypoint_angles(blurred, xy)
    desc = orb.describe(blurred, xy, angles)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    phase("api", f"kernel launches in the api path: {counts}")
    check_launches("api", counts)
    # K1 once per make_frame and per K1-route detect_level, K2 once per
    # make_frame, keypoint_angles and describe, K3 once per make_frame
    n = len(scenes)
    want = {"fast": n + 2, "patches": n + 2, "cc_fused": n,
            "cc_propagate": 0}
    if counts != want:
        raise PhaseError(f"api path launch counts {counts}, expected {want}")

    # (a) the generated dictionaries: JAX's ids, corners within the limit
    for d in scenes:
        f = frames[d]
        want_m = {int(i): c for i, c, v in zip(
            rec[f"{d}_ids"], rec[f"{d}_corners"], rec[f"{d}_valid"]) if v}
        got_m = {int(i): c for i, c, v in zip(
            f.mk_ids.cpu().numpy(), f.mk_corners.cpu().numpy(),
            f.mk_valid.cpu().numpy()) if v}
        if got_m.keys() != want_m.keys():
            raise PhaseError(f"{d}: make_frame decoded {sorted(got_m)}, "
                             f"JAX {sorted(want_m)}")
        err = max(float(np.abs(got_m[i] - want_m[i]).max()) for i in want_m)
        if err > API_CORNER_TOL_PX:
            raise PhaseError(f"{d}: corners {err:.4f} px off JAX's (limit "
                             f"{API_CORNER_TOL_PX} px)")
        phase("api", f"(a) {d} world ({tuple(dimg[d].shape)}): make_frame "
              f"decoded ids {sorted(got_m)} = JAX's; corners within "
              f"{err:.5f} px")

    # (b) keypoint_angles and describe (K2) against their plain versions
    # on the card and the port's CPU result
    y0, x0 = orb.patch_corners(blurred.shape, xy)
    patches = orb.extract_patches_torch(blurred, y0, x0)
    if not (torch.equal(angles, orb.angles_from_patches(patches))
            and torch.equal(desc, orb.describe_patches(patches, angles))):
        raise PhaseError("keypoint_angles / describe differ from their "
                         "plain versions on the card")
    cpu_img, cpu_xy = blurred.cpu(), xy.cpu()
    if not torch.equal(orb.describe(cpu_img, cpu_xy, angles.cpu()),
                       desc.cpu()):
        raise PhaseError("describe on the card differs from the CPU's")
    _, _, kx, ky = orb._tables_on(torch.device("cpu"))
    flat = patches.cpu().reshape(len(xy), -1)
    kp_mag = torch.hypot(flat @ kx, flat @ ky)
    strong = kp_mag > ANGLE_MAG_SHARE * kp_mag.max()
    d_ang = torch.remainder(orb.keypoint_angles(cpu_img, cpu_xy)
                            - angles.cpu() + np.pi, 2 * np.pi) - np.pi
    ang_err = float(d_ang.abs()[strong].max())
    omap = orb.orientation_map(gray)
    omap_cpu = orb.orientation_map(gray.cpu())
    okx, oky = (torch.as_tensor(k) for k in orb._moment_kernels())
    m = torch.nn.functional.conv2d(gray.cpu()[None, None], torch.stack(
        [okx, oky])[:, None], padding=orb.PATCH_RADIUS)[0]
    mag = torch.hypot(m[0], m[1])
    o_strong = mag > ANGLE_MAG_SHARE * mag.max()
    d_om = torch.remainder(omap.cpu() - omap_cpu + np.pi, 2 * np.pi) - np.pi
    om_err = float(d_om.abs()[o_strong].max())
    if ang_err > API_ANGLE_TOL_RAD or om_err > API_ANGLE_TOL_RAD:
        raise PhaseError(f"angles off the CPU's: keypoint_angles "
                         f"{ang_err:.2e} rad, orientation_map {om_err:.2e} "
                         f"rad (limit {API_ANGLE_TOL_RAD})")
    phase("api", f"(b) {len(xy)} keypoints of the {tuple(gray.shape)} bench "
          f"frame: keypoint_angles and describe through K2 equal to "
          f"angles_from_patches / describe_patches of extract_patches_torch "
          f"on the card; descriptors bit-equal to the CPU's, angles within "
          f"{ang_err:.2e} rad of them ({int(strong.sum())} strong); "
          f"orientation_map within {om_err:.2e} rad of the CPU's")

    # (c) the detect_level routes: None is True (K1); False (the XLA
    # route) differs from K1 only in the border band
    if not all(torch.equal(a, b) for a, b in zip(routes[None],
                                                  routes[True])):
        raise PhaseError("detect_level use_pallas None and True differ")
    k1 = fast.fast_score_nms(gray, *t_args)
    s_hi, s_lo = fast._fast_scores(gray, list(t_args))
    xla = fast.nms3x3(s_lo)
    xla = torch.where((xla > 0) & (s_hi > 0), xla + fast.BONUS, xla)
    H, W = gray.shape
    yy = torch.arange(H, device=DEVICE)[:, None]
    xx = torch.arange(W, device=DEVICE)[None, :]
    edge = torch.minimum(torch.minimum(yy, H - 1 - yy),
                         torch.minimum(xx, W - 1 - xx))
    inner = edge >= FAST_BORDER_PX
    same_nz = torch.equal((k1 != 0) & inner, (xla != 0) & inner)
    rel = float(((k1 - xla).abs() / k1.abs().clamp(min=1e-30))[
        inner & (k1 != 0)].max())
    if not same_nz or rel > FAST_ROUTE_RTOL:
        raise PhaseError(f"the XLA FAST route differs from K1 inside the "
                         f"border band (same nonzero pattern {same_nz}, "
                         f"values {rel:.2e} relative)")
    band_px = int(((k1 != xla) & ~inner).sum())

    def kp_set(kp):
        return {tuple(p) for p in kp.xy[kp.valid].cpu().tolist()}

    kp_diff = len(kp_set(routes[False]) ^ kp_set(routes[True]))
    phase("api", f"(c) detect_level: use_pallas None == True (K1); False "
          f"(XLA route) has K1's nonzero pattern inside the {FAST_BORDER_PX}"
          f"-px band, values within {rel:.2e} relative; {band_px} band "
          f"pixels differ; {kp_diff} of {int(routes[True].valid.sum())} "
          f"keypoints differ")

    # (d) hamming_popcount against the matcher's distance matrix
    other = frames[scenes[0]].desc
    hp = orb.hamming_popcount(desc, other)
    dm = matching.distance_matrix(desc, other)
    if not (torch.equal(hp.float(), dm) and torch.equal(
            hp.cpu(), orb.hamming_popcount(desc.cpu(), other.cpu()))):
        raise PhaseError("hamming_popcount differs from distance_matrix or "
                         "from the CPU's")
    phase("api", f"(d) hamming_popcount {tuple(hp.shape)} equal to "
          f"matching.distance_matrix and to the CPU's")

    # (e) the native library built at first use against the committed one
    ds = acfg.detect_downsample
    images = [rec[f"{d}_frame"].astype(np.float32) for d in scenes] + [
        255.0 * detector.downsample_majority(detector.adaptive_threshold(
            dimg[d].float(), acfg.adaptive_thresh_win, acfg.adaptive_thresh_c),
            ds).float().cpu().numpy() for d in scenes]
    if not native.available():
        raise PhaseError(f"the committed native library does not load: "
                         f"{native._load()[1]}")
    want_q = [native.find_quads_native(im) for im in images]
    saved = native._LIB_PATH, native._BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        native._LIB_PATH = os.path.join(tmp, "missing", "libquadfind.so")
        native._BUILD_DIR = os.path.join(tmp, "build")
        native._load.cache_clear()
        try:
            t0 = time.perf_counter()
            if not native.available():
                raise PhaseError(f"the native build failed: "
                                 f"{native._load()[1]}")
            build_s = time.perf_counter() - t0
            got_q = [native.find_quads_native(im) for im in images]
        finally:
            native._LIB_PATH, native._BUILD_DIR = saved
            native._load.cache_clear()
    if not all(np.array_equal(a, b) for a, b in zip(got_q, want_q)):
        raise PhaseError("the built native library's quads differ from "
                         "the committed library's")
    phase("api", f"(e) native/quadfind.cpp built at first use in "
          f"{build_s:.1f} s; quads {[len(q) for q in got_q]} on the "
          f"{[tuple(im.shape) for im in images]} frames and binaries equal "
          f"to the committed library's")

    # the solve departure: LU (solve_damped) against the unrolled Cholesky
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    A = torch.randn((API_SOLVES, 6, 6), device=DEVICE, generator=gen)
    Hs = A @ A.transpose(-1, -2) + 0.5 * torch.eye(6, device=DEVICE)
    bs = torch.randn((API_SOLVES, 6), device=DEVICE, generator=gen)
    lam = torch.full((API_SOLVES,), 1e-4, device=DEVICE)
    d = torch.diagonal(Hs, dim1=-2, dim2=-1).clamp(min=1e-10)
    Hd = (Hs + lam[:, None, None] * torch.diag_embed(d)
          + 1e-10 * torch.eye(6, device=DEVICE))
    lu, chol = lm.solve_damped(Hs, bs, lam), lm.small_spd_solve(Hd, bs)
    solve_rel = float(((lu - chol).norm(dim=-1)
                       / chol.norm(dim=-1)).max())

    rgb = gray[..., None].expand(H, W, 3).contiguous()
    ms = {
        "make_frame " + scenes[0]: cuda_ms(
            lambda: make_frame(dimg[scenes[0]], cam, dcfg[scenes[0]]),
            reps=5),
        "detect_level(None)": cuda_ms(
            lambda: fast.detect_level(gray, *det_args)),
        "detect_level(True)": cuda_ms(
            lambda: fast.detect_level(gray, *det_args, use_pallas=True)),
        "detect_level(False)": cuda_ms(
            lambda: fast.detect_level(gray, *det_args, use_pallas=False)),
        "fast_score_map": cuda_ms(lambda: fast.fast_score_map(gray,
                                                              t_args[1])),
        "nms3x3": cuda_ms(lambda: fast.nms3x3(s_lo)),
        "keypoint_angles": cuda_ms(lambda: orb.keypoint_angles(blurred, xy)),
        "describe": cuda_ms(lambda: orb.describe(blurred, xy, angles)),
        "orientation_map": cuda_ms(lambda: orb.orientation_map(gray)),
        "hamming_popcount": cuda_ms(lambda: orb.hamming_popcount(desc,
                                                                 other)),
        "to_gray": cuda_ms(lambda: image.to_gray(rgb)),
        f"small_spd_solve x{API_SOLVES}": cuda_ms(
            lambda: lm.small_spd_solve(Hd, bs)),
        f"solve_damped x{API_SOLVES}": cuda_ms(
            lambda: lm.solve_damped(Hs, bs, lam)),
    }
    phase("api", f"6x6 solves: solve_damped (LU) within {solve_rel:.2e} "
          f"relative of small_spd_solve (Cholesky) on {API_SOLVES} damped "
          f"SPD systems")
    phase("api", f"ms per call on the card ({smi}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items()))
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
                   "serve": serve_phase(path, cfg, ref, imgs),
                   "slam": slam_phase(cfg, ref, imgs),
                   "pipe": pipe_phase(cfg, ref, imgs),
                   "bench": bench_phase(path, cfg, ref)}
        by_path["loop"], gba_input = loop_phase()
        by_path["dist"] = dist_phase(gba_input)
        by_path["graft"] = graft_phase()
        by_path["video"] = video_phase()
        by_path["api"] = api_phase(cfg, imgs[0], smi)
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
