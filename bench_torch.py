#!/usr/bin/env python3
"""bench.py's workload through orb_slam2_aruco_tpu_torch on one CUDA device.

    python3 bench_torch.py

Prints ONE JSON line with bench.py's keys, each with bench.py's meaning
(bench.py:128-240):
  value            localization-mode tracking fps: localize_stream over
                   N_TIMED frames of the sweep (frame k = sweep frame
                   k % 32) from the warm SLAM system, extrapolate mode with
                   one pass, chunks of CHUNK staged by StagedSource, two
                   chunks in flight
  vs_baseline      value / 30 (bench.py's ~30 Hz design budget)
  slam_fps         SLAM-mode fps of a second, timed SLAM pass over the 32
                   frames at pipeline_depth 4 through StagedSource(batch=4):
                   (frames after drop) / (their call latencies + flush and a
                   device synchronize), drop = the first OK call + 2
  p50_ms / p90_ms  per-call latency percentiles of that pass after drop
  ba_iters_per_s   BA_ITERS / the seconds of one whole-map
                   mapping.bundle_adjust (window_all, max_cams = the map's
                   keyframe capacity, max_pts 8192) after a warm-up call,
                   a synchronize before each clock read
  chunk, loc_chunk_latency_ms
                   the stream's chunk and the median gap between bursts
                   of emitted poses (bench.py:202-208)
and beside them the card (`device` and `power_limit`, as nvidia-smi gives
them), the device's idle share of a SLAM pass and of two stream chunks
(`idle_share_slam`, `idle_share_stream`: 1 - the union of the device's
kernel and copy intervals over the host window, which ends in a
synchronize; torch.profiler over separate, untimed runs; null when the
trace holds no device work) with the device events, busy seconds and
window behind each, the stream's rewinds and frames built,
and the BA's live and masked camera slots.

Builds the CUDA kernels from the package's kernels/csrc at first use (one
nvcc per source, all at once). Needs a CUDA GPU: `main(device="cpu")`
runs the same workload on the CPU only when a caller asks for it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import torch  # noqa: E402

from orb_slam2_aruco_tpu_torch import require_device  # noqa: E402

METRIC = "tracking_fps_960x540_1000feat"
BASELINE_FPS = 30.0
# the bench world and its non-wrapping out-and-back sweep (bench.py:104-126)
MARKER_IDS = [3, 17, 42, 99, 7, 23, 55, 88]
N_BASE = 16
# the SLAM pass: pipeline depth, frames per staged batch
SLAM_DEPTH, SLAM_BATCH = 4, 4
# the serving pass and the global BA (bench.py:176-226)
CHUNK, N_TIMED = 64, 1024
BA_ITERS, BA_MAX_PTS = 30, 8192


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_scene(device="cuda"):
    """(cfg, frames): bench.py's configuration (960x540, fx = fy = 500,
    detect_downsample 2, pipeline_depth 4) and its 32 uint8 frames of the
    8-marker world, rendered by the port's io/synthetic."""
    from orb_slam2_aruco_tpu_torch.config import CameraConfig, SlamConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic

    require_device(device)
    camc = CameraConfig(fx=500.0, fy=500.0, cx=480.0, cy=270.0,
                        dist=(0, 0, 0, 0, 0), width=960, height=540)
    cfg = SlamConfig().replace(camera=camc)
    cfg = cfg.replace(
        aruco=cfg.aruco.__class__(detect_downsample=2),
        tracking=cfg.tracking.__class__(pipeline_depth=SLAM_DEPTH),
    )
    world = synthetic.build_world(MARKER_IDS, px_per_m=500.0, spacing=0.6,
                                  grid_cols=4, marker_size=0.165)
    n_frames = 2 * N_BASE
    xs = np.concatenate([np.linspace(0.5, 1.3, N_BASE),
                         np.linspace(1.3, 0.5, n_frames - N_BASE)])
    poses = [synthetic.look_at_plane_pose(
        (x, 0.3), 2.0, yaw=0.1 * np.sin(2 * np.pi * i / n_frames),
        pitch=0.04) for i, x in enumerate(xs)]
    frames = [np.clip(synthetic.render_view(world, camc, R, t), 0,
                      255).astype(np.uint8) for R, t in poses]
    return cfg, frames


def slam_pass(cfg, frames, device="cuda"):
    """bench.py's SLAM pass (bench.py:128-164) on a fresh system: the frames
    through StagedSource(batch=SLAM_BATCH), each track_monocular call timed,
    then flush and a device synchronize inside the clock. Every keyframe
    the run creates is recorded by its frame id, in order. Returns (system,
    the trajectory records, keyframes created by frame, keyframes inserted
    by each call, {slam_fps, p50_ms, p90_ms, flush_ms, drop})."""
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

    system = SlamSystem(cfg, device=device)
    lat, per_call, ok_from = [], [], None
    src = StagedSource([(f, k / 30.0) for k, f in enumerate(frames)],
                       batch=SLAM_BATCH, device=device)
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
        _sync(system.device)
        flush_s = time.perf_counter() - t0
    if system.state is not TrackingState.OK:
        raise RuntimeError(f"the bench's SLAM pass ended {system.state}")
    drop = (ok_from if ok_from is not None else 4) + 2
    steady = np.asarray(lat[drop:])
    return system, list(system.get_trajectory()), created, per_call, dict(
        slam_fps=(len(frames) - drop) / (steady.sum() + flush_s),
        p50_ms=float(np.percentile(steady, 50) * 1e3),
        p90_ms=float(np.percentile(steady, 90) * 1e3),
        flush_ms=flush_s * 1e3, drop=drop)


def serve(slam, frames, n, chunk):
    """localize_stream over frames[k % len(frames)] for k < n (ts 0.0)
    through StagedSource(batch=chunk), two chunks in flight. Returns
    {out: [(frame id, pose or None)], emit_s: seconds from the start to
    each emission, seconds (ending in a synchronize), rewinds_at: the
    stream's rewinds when each frame was emitted, built: frames built (every
    frame of every chunk dispatched, discarded ones included, and every
    per-frame call)}."""
    from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource

    built = [0]
    run_chunk, track_one = slam._run_chunk, slam.track_monocular

    def chunk_built(stack):
        built[0] += stack.shape[0]
        return run_chunk(stack)

    def one_built(img, ts):
        built[0] += 1
        return track_one(img, ts)

    r0 = slam.stats["rewinds"]
    out, emit_s, rewinds_at = [], [], []
    slam._run_chunk, slam.track_monocular = chunk_built, one_built
    try:
        t0 = time.perf_counter()
        for fid, _, p in slam.localize_stream(
                StagedSource([(frames[k % len(frames)], 0.0)
                              for k in range(n)], batch=chunk,
                             device=slam.device), chunk=chunk):
            emit_s.append(time.perf_counter() - t0)
            out.append((fid, p))
            rewinds_at.append(slam.stats["rewinds"] - r0)
        _sync(slam.device)
        seconds = time.perf_counter() - t0
    finally:
        del slam._run_chunk, slam.track_monocular
    return dict(out=out, emit_s=emit_s, seconds=seconds,
                rewinds_at=rewinds_at, built=built[0])


def serving_mode(slam):
    """bench.py's serving mode (bench.py:175-183) on a system: localization
    mode, extrapolate seeds, one pass."""
    slam.activate_localization_mode()
    slam.cfg = slam.cfg.replace(tracking=dataclasses.replace(
        slam.cfg.tracking, loc_seed_mode="extrapolate", loc_extrap_passes=1))


def stream_pass(slam, frames, n_timed=N_TIMED, chunk=CHUNK):
    """bench.py's serving pass (bench.py:166-208) on the warm SLAM system:
    serving_mode, one warm-up localize_stream of `chunk` frames, then the
    timed one over n_timed frames. Every pose must be non-None
    (bench.py:197). Returns {out: the emitted [(frame id, pose)], chunk,
    n_timed, fps, loc_chunk_latency_ms, rewinds, built, rewinds_at,
    bursts_ms, seconds, warm: the warm-up's serve() result}."""
    serving_mode(slam)
    warm = serve(slam, frames, chunk, chunk)
    run = serve(slam, frames, n_timed, chunk)
    out, emit_s = run["out"], run["emit_s"]
    lost = [fid for fid, p in out if p is None]
    if lost or len(out) != n_timed:
        raise RuntimeError(f"the stream emitted {len(out)} of {n_timed} "
                           f"frames, None at frames {lost[:16]}")
    bursts = [emit_s[0]] + [emit_s[k] - emit_s[k - chunk]
                            for k in range(chunk, n_timed, chunk)]
    return dict(out=out, chunk=chunk, n_timed=n_timed,
                fps=n_timed / run["seconds"],
                loc_chunk_latency_ms=float(np.median(bursts) * 1e3),
                rewinds=run["rewinds_at"][-1], built=run["built"],
                rewinds_at=run["rewinds_at"],
                bursts_ms=[b * 1e3 for b in bursts],
                seconds=run["seconds"], warm=warm)


def ba_rate(slam, cfg, iters=BA_ITERS):
    """bench.py's global-BA rate (bench.py:210-226): the whole-map
    mapping.bundle_adjust (window_all, max_cams = the map's keyframe
    capacity, max_pts BA_MAX_PTS, or the map's point capacity where that
    is smaller) on the system's map, once to warm up and once timed, a
    synchronize before each clock read. Returns
    {ba_iters_per_s, iters, seconds, chi2, state: the BA's map, cams_live
    (valid keyframes in the problem), cams_masked (the other camera
    slots)}."""
    from orb_slam2_aruco_tpu_torch.pipeline import mapping

    kw = dict(max_cams=cfg.map.max_keyframes,
              max_pts=min(BA_MAX_PTS, cfg.map.max_points), iters=iters,
              window_all=True)
    _, chi = mapping.bundle_adjust(slam.map, slam.ref_kf, slam.cam, cfg,
                                   **kw)
    float(chi)
    _sync(slam.device)
    t0 = time.perf_counter()
    state, chi = mapping.bundle_adjust(slam.map, slam.ref_kf, slam.cam, cfg,
                                       **kw)
    chi = float(chi)
    _sync(slam.device)
    seconds = time.perf_counter() - t0
    live = min(int(slam.map.kf_valid.sum()), kw["max_cams"])
    return dict(ba_iters_per_s=iters / seconds, iters=iters, seconds=seconds,
                chi2=chi, state=state, cams_live=live,
                cams_masked=kw["max_cams"] - live)


def device_spans(fn, device):
    """(fn's result, [(start ns, end ns)] of every kernel and copy on the
    device while fn() ran, nanoseconds of the host window around fn(),
    which ends in a synchronize), from one torch.profiler session tracing
    the device alone. The spans are read from the raw trace: a bench
    window holds ~10^6 device events (~10^4 a frame), for which the
    profiler's per-event Python objects (events(), key_averages()) take
    many minutes to build. The spans are None off CUDA, and empty where
    the profiler traced no device work."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter_ns()
        result = fn()
        return result, None, time.perf_counter_ns() - t0
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        result = fn()
        _sync(device)
        window_ns = time.perf_counter_ns() - t0
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    return result, spans, window_ns


def union_ns(spans):
    """Nanoseconds covered by the union of [start, end) spans."""
    busy, lo, hi = 0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + (0 if hi is None else hi - lo)


def idle_share(fn, device):
    """(1 - (the union of the device's kernel and copy intervals) / (the
    host window around fn(), which ends in a synchronize), {device_events,
    busy_s, window_s}, fn's result), from device_spans. The share is None
    (not measured) where the trace holds no device event: the CPU, or a
    profiler that traced no device work. The profiler's own cost
    lengthens the window: busy_s over an unprofiled run's seconds is the
    other reading."""
    result, spans, window_ns = device_spans(fn, device)
    if not spans:
        return None, dict(device_events=0, busy_s=None,
                          window_s=window_ns / 1e9), result
    busy = union_ns(spans)
    return 1.0 - busy / window_ns, dict(
        device_events=len(spans), busy_s=busy / 1e9,
        window_s=window_ns / 1e9), result


def card(device):
    """(name, power limit) as nvidia-smi gives them; ("cpu", None) on the
    CPU."""
    if torch.device(device).type != "cuda":
        return "cpu", None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return name, limit


def bench_line(m, stream, ba, smi, idle):
    """The JSON line: bench.py's keys from the timed SLAM pass's metrics
    `m`, stream_pass's and ba_rate's results, then the card (name, power
    limit), the idle shares ((share, idle_share's counts) of the SLAM pass
    and of the stream) and the counts behind the rates."""
    (idle_slam, at_slam), (idle_stream, at_stream) = idle
    return {
        "metric": METRIC,
        "value": stream["fps"],
        "unit": "frames/s",
        "vs_baseline": stream["fps"] / BASELINE_FPS,
        "slam_fps": m["slam_fps"],
        "p50_ms": m["p50_ms"],
        "p90_ms": m["p90_ms"],
        "ba_iters_per_s": ba["ba_iters_per_s"],
        "chunk": stream["chunk"],
        "loc_chunk_latency_ms": stream["loc_chunk_latency_ms"],
        "device": smi[0],
        "power_limit": smi[1],
        "idle_share_slam": idle_slam,
        "idle_share_stream": idle_stream,
        "idle_slam_device_events": at_slam["device_events"],
        "idle_slam_busy_s": at_slam["busy_s"],
        "idle_slam_window_s": at_slam["window_s"],
        "idle_stream_device_events": at_stream["device_events"],
        "idle_stream_busy_s": at_stream["busy_s"],
        "idle_stream_window_s": at_stream["window_s"],
        "n_timed": stream["n_timed"],
        "rewinds": stream["rewinds"],
        "frames_built": stream["built"],
        "ba_iters": ba["iters"],
        "ba_cams_live": ba["cams_live"],
        "ba_cams_masked": ba["cams_masked"],
    }


def run(device="cuda"):
    """The bench on `device`: bench_scene, a warm-up SLAM pass (its system
    serves the stream and the BA, as bench.py's does), the timed SLAM pass,
    the serving pass, the BA rate, and the two profiled runs for the idle
    shares (a third SLAM pass; two chunks of the stream, after the timed
    one). Returns {line: the JSON line, cfg, frames, warm / timed:
    slam_pass results, stream: stream_pass's, ba: ba_rate's, built: frames
    built in all}."""
    device = require_device(device)
    if device.type == "cuda":
        from orb_slam2_aruco_tpu_torch.kernels import build

        build.build_all()
    name, limit = card(device)
    cfg, frames = bench_scene(device)
    warm = slam_pass(cfg, frames, device)
    timed = slam_pass(cfg, frames, device)
    idle_slam = idle_share(lambda: slam_pass(cfg, frames, device), device)
    slam = warm[0]
    stream = stream_pass(slam, frames)
    idle_stream = idle_share(lambda: serve(slam, frames, 2 * CHUNK, CHUNK),
                             device)
    ba = ba_rate(slam, cfg)
    line = bench_line(timed[4], stream, ba, (name, limit),
                      (idle_slam[:2], idle_stream[:2]))
    built = (3 * len(frames) + stream["warm"]["built"] + stream["built"]
             + idle_stream[2]["built"])
    return dict(line=line, cfg=cfg, frames=frames, warm=warm, timed=timed,
                stream=stream, ba=ba, built=built)


def main(device="cuda"):
    """Run the bench on `device` and print its JSON line; returns it."""
    line = run(device)["line"]
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
