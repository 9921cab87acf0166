"""Slice 1 of the port, end to end: localization against a map the JAX
package built.

`build_reference_data` runs the JAX package on the CPU and writes the two
reference files the port is held to (orb_slam2_aruco_tpu_torch/data/):

  ref_small.npz  the smoke-test configuration (320x240, 300 features, 16
                 keyframes, 2048 points, 4 markers): a format-4 map from a
                 12-frame SLAM pass, plus the JAX SlamSystem.load_map +
                 track_monocular poses and OK/LOST states of 8 localization
                 frames rendered between the mapping poses;
  ref_full.npz   the bench configuration (960x540, 1000 features, 8 levels,
                 detect_downsample=2, 256 keyframes / 20000 points, the
                 8-marker world): the map from the 32-frame SLAM sweep, the
                 JAX localization poses and states of 32 frames rendered at
                 mid-points of the sweep, their ground truth and the JAX
                 run's ATE. chip_smoke.py holds the port to it on the card.

`add_serving_reference` adds, to both files, the JAX package's K4 quad
proposal on a few of those frames (`ref_quad_*`), a `localize_stream`
run (`ref_stream_*`: chunk 64 over 128 frames in ref_full, the bench's
serving form; chunk 4 with a rewind in ref_small) and `track_batch` in
each of its modes (`ref_tb_*`: one chunk of 4 frames in ref_small, of 16
in ref_full), and to ref_full the default serving form (`ref_dstream_*`:
localize_stream and SlamConfig at their defaults, a rewind mid-chunk).

`add_slam_reference` adds, to both files, the JAX SlamSystem in SLAM mode
at tracking.pipeline_depth 0 over the map frames and the localization of
the reference frames against the map it built (`ref_slam_*`; ref_small
also holds the system's state before every step).

`add_loop_reference` adds, to both files, the JAX SlamSystem over a loop
scene (`LOOP_SETUPS`; `ref_loop_*`): a pan away from the markers and back
with the test_full_system_loop_closure drift injected, the loop it closes
and the global BA drained, then black, noise, BoW-PnP and marker
relocalization frames; ref_small also holds the system's state before the
loop step and after the drain (`ref_loop_snap_*`).

`add_pipe_reference` adds, to both files, the JAX SlamSystem in pipelined
SLAM mode (`ref_pipe_*`): ref_full's own depth-4 map build (bench.py's
SLAM pass; the map it leaves is the file's map), and on ref_small depth 2
over the shifted scene; in both files a run at the file's depth that loses
tracking and rewinds (`ref_pipe_rewind_*`).

`add_bench_reference` (`--bench`) adds, to ref_full, the JAX package's
run of bench.py's sequence (`ref_bench_*`): the depth-4 SLAM pass (its map
is the file's map), then on that warm system the warm-up chunk and the
first two chunks of the timed localize_stream, with the tracking state the
stream starts from, and the 30-iteration whole-map BA on the file's map.
chip_smoke.py's bench phase and tests/test_torch_bench.py hold
bench_torch.py to it.

Each file is a valid map checkpoint (the JAX and the port's load_map read
it) with the reference arrays under `ref_*` keys. Regenerate everything
with `--regen`, or only the serving, SLAM, loop or pipelined keys with
`--serving`, `--slam`, `--loop` or `--pipe` (the existing keys stay
byte-equal; `--parts` picks some of the serving recordings):

    python tests/test_torch_slice.py \
        --regen|--serving|--slam|--loop|--pipe [small|full]
    python tests/test_torch_slice.py --serving full --parts tb,dstream
    python tests/test_torch_slice.py --bench
    python tests/test_torch_slice.py --graft

`add_graft_reference` (`--graft`) writes ref_graft.npz: __graft_entry__.py's
flagship step, its capacity global-BA problem's digest and JAX's solves of
it (as shipped, and with each segment summed apart, with what one float32
ulp moves them). chip_smoke.py's graft phase and tests/test_torch_graft.py
hold graft_entry_torch.py to it.

`add_video_reference` (`--video`, needs cv2) writes a third file,
ref_video.npz: the real-footage sequence of tests/test_ingest.py's 25h7
two-pass test as the JAX VideoSource decodes it, and the JAX
examples/mono_video.py CLI's run over it.

`add_dicts_reference` (`--dicts`) writes ref_dicts.npz: the JAX package's
generated ArUco dictionaries (TPU_16h5 / ARUCO_MIP_16h3, TPU_36h12 and the
25h7 regeneration), and its detect_markers on one bench-camera frame of a
16h3 world and one of a TPU_36h12 world (`DICT_SCENES`). JAX's generator
takes minutes for TPU_16h5 and longer for TPU_36h12 (pure-Python loops over
200 000 tries), so the tests hold the port to this recording and never run
it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import pytest

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

# One intra-op thread for the port's tests (this module is imported by the
# other test_torch_* files that hold the port to JAX): their tensors are
# small, and the suite runs its files in parallel workers, where torch's
# default of one thread per core oversubscribes the cores and every small
# op stalls at the thread pool's barrier.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "orb_slam2_aruco_tpu_torch", "data")


# ---------------------------------------------------------------------------
# the two reference setups
# ---------------------------------------------------------------------------


def small_pose(u, n=12):
    """Render parameters (x, y, dist, yaw, pitch) of the small setup at the
    continuous frame parameter u of tests/test_smoke.py."""
    return (0.3 + 0.4 * u / n, 0.22, 1.3, 0.1 * np.sin(2 * np.pi * u / n),
            0.05)


def _small_setup():
    from orb_slam2_aruco_tpu.config import CameraConfig, SlamConfig

    camc = CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                        dist=(0, 0, 0, 0, 0), width=320, height=240)
    cfg = SlamConfig().replace(camera=camc)
    cfg = cfg.replace(
        orb=cfg.orb.__class__(num_features=300),
        map=cfg.map.__class__(max_keyframes=16, max_points=2048,
                              max_markers=8),
    )
    world = dict(marker_ids=[3, 17, 42, 99], px_per_m=700.0, spacing=0.45,
                 grid_cols=2, marker_size=0.165)
    map_params = [small_pose(i) for i in range(12)]
    loc_params = [small_pose(i + 0.5) for i in range(2, 10)]
    return cfg, world, map_params, loc_params


# the small setup's second SLAM scene: the same sweep half a frame later
SMALL_SHIFTED_PARAMS = [small_pose(i + 0.5) for i in range(12)]


def _full_setup():
    from orb_slam2_aruco_tpu.config import CameraConfig, SlamConfig

    camc = CameraConfig(fx=500.0, fy=500.0, cx=480.0, cy=270.0,
                        dist=(0, 0, 0, 0, 0), width=960, height=540)
    cfg = SlamConfig().replace(camera=camc)
    cfg = cfg.replace(
        aruco=cfg.aruco.__class__(detect_downsample=2),
        tracking=cfg.tracking.__class__(pipeline_depth=4),
    )
    world = dict(marker_ids=[3, 17, 42, 99, 7, 23, 55, 88], px_per_m=500.0,
                 spacing=0.6, grid_cols=4, marker_size=0.165)
    n_base, n_frames = 16, 32
    xs = np.concatenate([np.linspace(0.5, 1.3, n_base),
                         np.linspace(1.3, 0.5, n_frames - n_base)])

    def pose(u):   # continuous frame parameter of bench.py's sweep
        return (float(np.interp(u, np.arange(n_frames), xs)), 0.3, 2.0,
                0.1 * np.sin(2 * np.pi * u / n_frames), 0.04)

    map_params = [pose(i) for i in range(n_frames)]
    loc_params = [pose(i + 0.5) for i in range(n_frames)]
    return cfg, world, map_params, loc_params


SETUPS = {"small": _small_setup, "full": _full_setup}


def render_frames(syn, world_kw, camc, params, dict_name="ARUCO",
                  uint8=True):
    """Frames (uint8, or the renderer's float32) and ground-truth poses for
    (x, y, dist, yaw, pitch) render parameters; `syn` is either package's
    io.synthetic."""
    world = syn.build_world(world_kw["marker_ids"], dict_name=dict_name,
                            marker_size=world_kw["marker_size"],
                            grid_cols=world_kw["grid_cols"],
                            spacing=world_kw["spacing"],
                            px_per_m=world_kw["px_per_m"],
                            extent_margin=world_kw.get("extent_margin", 0.5))
    poses = [syn.look_at_plane_pose((x, y), d, yaw=yaw, pitch=pitch)
             for x, y, d, yaw, pitch in params]
    imgs = [syn.render_view(world, camc, R, t) for R, t in poses]
    if uint8:
        imgs = [np.clip(im, 0, 255).astype(np.uint8) for im in imgs]
    return imgs, poses


def build_reference_data(which=("small", "full"), out_dir=DATA_DIR):
    """Build the map(s) with the JAX SLAM pass, localize the reference
    frames with the JAX SlamSystem, and write ref_<which>.npz."""
    from orb_slam2_aruco_tpu.io import checkpoint
    from orb_slam2_aruco_tpu.io import synthetic as jsyn
    from orb_slam2_aruco_tpu.io import trajectory
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem, TrackingState

    os.makedirs(out_dir, exist_ok=True)
    for name in which:
        cfg, world_kw, map_params, loc_params = SETUPS[name]()
        camc = cfg.camera
        map_imgs, _ = render_frames(jsyn, world_kw, camc, map_params,
                                    cfg.aruco.dictionary)
        slam = SlamSystem(cfg)
        for i, img in enumerate(map_imgs):
            slam.track_monocular(img, ts=i / 30.0)
        slam.flush()
        if slam.state is not TrackingState.OK:
            raise RuntimeError(f"{name}: JAX map build ended {slam.state}")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "map.npz")
            slam.save_map(path)
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
            loc = SlamSystem(cfg)
            loc.load_map(path)
        loc_imgs, gt = render_frames(jsyn, world_kw, camc, loc_params,
                                     cfg.aruco.dictionary)
        Rs, ts, ok = [], [], []
        for i, img in enumerate(loc_imgs):
            p = loc.track_monocular(img, ts=100.0 + i / 30.0)
            ok.append(loc.state is TrackingState.OK and p is not None)
            R, t = (p if p is not None else
                    (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))
            Rs.append(np.asarray(R, np.float32))
            ts.append(np.asarray(t, np.float32))
        ok = np.asarray(ok)
        gt_R = np.stack([g[0] for g in gt]).astype(np.float32)
        gt_t = np.stack([g[1] for g in gt]).astype(np.float32)
        est_c = trajectory.camera_centers([Rs[i] for i in np.flatnonzero(ok)],
                                          [ts[i] for i in np.flatnonzero(ok)])
        gt_c = trajectory.camera_centers(gt_R[ok], gt_t[ok])
        ate = trajectory.ate_rmse(est_c, gt_c, align=True, with_scale=False)
        arrays.update(
            ref_cfg=np.asarray(json.dumps(dataclasses.asdict(cfg))),
            ref_world=np.asarray(json.dumps(world_kw)),
            ref_map_params=np.asarray(map_params, np.float64),
            ref_loc_params=np.asarray(loc_params, np.float64),
            ref_R=np.stack(Rs), ref_t=np.stack(ts), ref_ok=ok,
            ref_gt_R=gt_R, ref_gt_t=gt_t,
            ref_ate=np.asarray(ate, np.float64),
        )
        out = os.path.join(out_dir, f"ref_{name}.npz")
        np.savez_compressed(out, **arrays)
        print(f"{out}: {os.path.getsize(out)} bytes, ok {int(ok.sum())}/"
              f"{len(ok)}, keyframes {int(arrays['kf_valid'].sum())}, "
              f"points {int(arrays['pt_valid'].sum())}, ATE {ate:.5f} m",
              flush=True)
    add_serving_reference(which, out_dir)


# ---------------------------------------------------------------------------
# the chunked serving form and the K4 quad proposal (ref_stream_*, ref_tb_*,
# ref_quad_* keys)
# ---------------------------------------------------------------------------

# localize_stream runs held to the JAX package: after load_map and one
# track_monocular on reference frame 0 (relocalization), the frames of
# `order` (reference frame indices, -1 = a blank grey frame) are served in
# chunks. "full" is bench.py's serving form (bench.py:176-196): chunk 64,
# two chunks in flight, 128 frames out and back over the 32 frames.
# "small" holds one blank frame: its chunk loses tracking and the stream
# rewinds through the per-frame path.
STREAM_SPECS = {
    "small": dict(chunk=4, depth=2, loc_seed_mode="extrapolate",
                  loc_extrap_passes=1,
                  order=[0, 1, 2, 3, 4, 5, -1, 6, 7, 7, 6, 5, 4, 3, 2, 1, 0]),
    "full": dict(chunk=64, depth=2, loc_seed_mode="extrapolate",
                 loc_extrap_passes=1, order=[k % 32 for k in range(128)]),
}

# track_batch modes: (loc_seed_mode, loc_extrap_passes, loc_two_stage)
TB_MODES = {
    "extrap1": ("extrapolate", 1, True),
    "extrap2": ("extrapolate", 2, True),
    "two_stage": ("scan", 2, True),
    "sequential": ("scan", 2, False),
}
TB_CARRY = ("R", "t", "vel_R", "vel_t", "ok", "kp_uv", "desc", "obs",
            "kp_valid", "kp_octave", "kp_angle", "pt_visible", "pt_found")
TB_INPUTS = ("R_last", "t_last", "vel_R", "vel_t", "last_uv", "last_desc",
             "last_obs", "last_valid", "last_octave", "last_angle", "ref_kf",
             "pt_visible", "pt_found")

# frames of the recorded track_batch chunk (reference frames 2 on)
TB_CHUNK = {"small": 4, "full": 16}

# the default serving form (ref_dstream_*, ref_full only): localize_stream
# at its own chunk and depth, SlamConfig's default tracking serving knobs
# and ArUco route (`default_stream_spec`), a blank frame after frame 19 —
# mid-chunk, so one speculative chunk is in flight when the stream rewinds
# — then the rest of the sweep and the way back (65 frames)
DSTREAM_ORDER = (list(range(20)) + [-1] + list(range(20, 32))
                 + list(range(31, -1, -1)))

# reference frames whose K4 quad proposal is recorded
QUAD_FRAMES = {"small": [0, 4], "full": [0, 8, 16, 24]}

# the serving recordings, each under its keys ref_<part>_*
SERVING_PARTS = ("quad", "tb", "stream", "dstream")


def serving_cfg(cfg, loc_seed_mode, loc_extrap_passes, loc_two_stage=True):
    """`cfg` with the localization serving mode set (either package's
    SlamConfig)."""
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, loc_seed_mode=loc_seed_mode,
        loc_extrap_passes=loc_extrap_passes, loc_two_stage=loc_two_stage))


def default_stream_spec(config, localize_stream):
    """The default serving form from either package's config module and
    SlamSystem.localize_stream: their defaults, and DSTREAM_ORDER."""
    import inspect

    d = config.SlamConfig()
    sig = inspect.signature(localize_stream).parameters
    return dict(chunk=sig["chunk"].default, depth=sig["depth"].default,
                loc_seed_mode=d.tracking.loc_seed_mode,
                loc_extrap_passes=d.tracking.loc_extrap_passes,
                loc_two_stage=d.tracking.loc_two_stage,
                detect_downsample=d.aruco.detect_downsample,
                order=list(DSTREAM_ORDER))


def stream_cfg(cfg, spec):
    """`cfg` with a stream spec's serving mode and, where the spec names
    one, its ArUco downsample (either package's SlamConfig)."""
    cfg = serving_cfg(cfg, spec["loc_seed_mode"], spec["loc_extrap_passes"],
                      spec.get("loc_two_stage", True))
    if "detect_downsample" in spec:
        cfg = cfg.replace(aruco=dataclasses.replace(
            cfg.aruco, detect_downsample=spec["detect_downsample"]))
    return cfg


def stream_frames(imgs, order):
    """[(uint8 frame, ts)] of a stream spec's order (-1 = blank grey)."""
    blank = np.full(imgs[0].shape, 128, np.uint8)
    return [(blank if k < 0 else imgs[k], 1.0 + j / 30.0)
            for j, k in enumerate(order)]


def half_res_binary(img, acfg):
    """The quad proposal's input in either package's convention: adaptive
    threshold, then the majority-vote downsample (numpy bool)."""
    from orb_slam2_aruco_tpu.ops.aruco import detector as jdet

    b = np.asarray(jdet.adaptive_threshold(
        jax.numpy.asarray(np.asarray(img, np.float32)),
        acfg.adaptive_thresh_win, acfg.adaptive_thresh_c))
    ds = acfg.detect_downsample
    if ds > 1:
        h, w = (b.shape[0] // ds) * ds, (b.shape[1] // ds) * ds
        b = (b[:h, :w].reshape(h // ds, ds, w // ds, ds).sum(axis=(1, 3))
             * 2 >= ds * ds)
    return b


def jax_quads_k4(binary, acfg):
    """JAX quad_candidates(use_pallas_cc=True) with K4 in interpret mode
    (it has no CPU path otherwise); the JAX package is not changed."""
    import functools
    from unittest import mock

    from orb_slam2_aruco_tpu.ops import pallas_cc
    from orb_slam2_aruco_tpu.ops.aruco import detector as jdet

    ds = acfg.detect_downsample
    interp = functools.partial(pallas_cc.cc_propagate_pallas, interpret=True)
    with mock.patch.object(pallas_cc, "cc_propagate_pallas", interp):
        q, s, v = jdet.quad_candidates(
            jax.numpy.asarray(binary), acfg.max_quad_candidates,
            min_area=acfg.min_quad_side_px**2 / ds**2,
            cc_iters=acfg.cc_iters, use_pallas_cc=True)
    return np.asarray(q), np.asarray(s), np.asarray(v)


def _record_stream(cfg, path, imgs, spec, prefix="ref_stream_"):
    """JAX localize_stream over stream_frames(imgs, spec["order"]) after one
    relocalizing track_monocular on reference frame 0: the emitted ids,
    OK/None and poses, stats["reloc"], and under `prefix` + rewinds / built
    the stream's rewinds (each starts a run of per-frame track_monocular
    calls) and the frames it built (every frame of every chunk dispatched,
    discarded ones included, and every per-frame call)."""
    from unittest import mock

    from orb_slam2_aruco_tpu.io.ingest import StagedSource
    from orb_slam2_aruco_tpu.pipeline import tracking as jtrack
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem, TrackingState

    system = SlamSystem(stream_cfg(cfg, spec))
    system.load_map(path)
    system.track_monocular(imgs[0], ts=0.0)
    if system.state is not TrackingState.OK:
        raise RuntimeError("the stream's first frame did not relocalize")
    src = StagedSource(stream_frames(imgs, spec["order"]),
                       batch=spec["chunk"])
    calls = []          # "B" per frame of a dispatched chunk, "M" per frame
    real_tb, real_tm = jtrack.track_batch, system.track_monocular

    def track_batch(state, imgs_b, *a, **k):
        calls.extend("B" * imgs_b.shape[0])
        return real_tb(state, imgs_b, *a, **k)

    def track_monocular(img, ts):
        calls.append("M")
        return real_tm(img, ts)

    system.track_monocular = track_monocular
    fid, ok, Rs, ts = [], [], [], []
    with mock.patch.object(jtrack, "track_batch", track_batch):
        for f, _, p in system.localize_stream(src, chunk=spec["chunk"],
                                              depth=spec["depth"]):
            fid.append(f)
            ok.append(p is not None)
            R, t = p if p is not None else (np.eye(3), np.zeros(3))
            Rs.append(np.asarray(R, np.float32))
            ts.append(np.asarray(t, np.float32))
    rewinds = sum(1 for j, c in enumerate(calls)
                  if c == "M" and (j == 0 or calls[j - 1] == "B"))
    spec_json = {k: v for k, v in spec.items() if k != "order"}
    out = {"spec": np.asarray(json.dumps(spec_json)),
           "order": np.asarray(spec["order"], np.int32),
           "fid": np.asarray(fid, np.int32), "ok": np.asarray(ok),
           "R": np.stack(Rs), "t": np.stack(ts),
           "reloc": np.asarray(system.stats["reloc"])}
    if prefix != "ref_stream_":
        out.update(rewinds=np.asarray(rewinds, np.int64),
                   built=np.asarray(len(calls), np.int64))
    print(f"  {prefix}*: {len(fid)} frames emitted, "
          f"{len(fid) - sum(ok)} None, reloc "
          f"{system.stats['reloc']}, rewinds {rewinds}, frames built "
          f"{len(calls)}", flush=True)
    return {prefix + k: v for k, v in out.items()}


def _record_track_batch(cfg, path, imgs, chunk=4):
    """JAX track_batch in each mode on reference frames 2 to chunk + 1, from
    the tracking state after frames 0 (relocalization) and 1."""
    import jax.numpy as jnp

    from orb_slam2_aruco_tpu.pipeline import tracking as jtrack
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem, TrackingState

    system = SlamSystem(cfg)
    system.load_map(path)
    for i in range(2):
        system.track_monocular(imgs[i], ts=i / 30.0)
    if system.state is not TrackingState.OK or system.vel is None:
        raise RuntimeError("track_batch reference: frames 0-1 did not track")
    lf = system.last_frame
    ins = dict(R_last=system.last_pose[0], t_last=system.last_pose[1],
               vel_R=system.vel[0], vel_t=system.vel[1], last_uv=lf.kp_uv,
               last_desc=lf.desc, last_obs=system.last_obs,
               last_valid=lf.kp_valid, last_octave=lf.kp_octave,
               last_angle=lf.kp_angle, ref_kf=jnp.asarray(system.ref_kf),
               pt_visible=system.map.pt_visible,
               pt_found=system.map.pt_found)
    out = {f"ref_tb_in_{k}": np.asarray(v) for k, v in ins.items()}
    stack = jnp.asarray(np.stack(imgs[2:2 + chunk]))
    for name, mode in TB_MODES.items():
        ctrls, carry = jtrack.track_batch(
            system.map, stack, ins["R_last"], ins["t_last"], ins["vel_R"],
            ins["vel_t"], jnp.asarray(True), *[ins[k] for k in TB_INPUTS[4:11]],
            system.cam, serving_cfg(cfg, *mode))
        out[f"ref_tb_{name}_ctrl"] = np.asarray(ctrls)
        for k, v in zip(TB_CARRY, carry):
            out[f"ref_tb_{name}_{k}"] = np.asarray(v)
        print(f"  track_batch {name}: n_inliers "
              f"{np.asarray(ctrls)[:, 0].tolist()}", flush=True)
    return out


def add_serving_reference(which=("small", "full"), out_dir=DATA_DIR,
                          parts=SERVING_PARTS):
    """Record, into the existing ref_<which>.npz, the `parts` of the JAX
    package's serving runs: its K4 quad proposal on QUAD_FRAMES (quad),
    track_batch in each mode (TB_MODES) on one chunk of TB_CHUNK frames
    (tb), the localize_stream run of STREAM_SPECS (stream) and, in ref_full,
    the default serving form (dstream, `default_stream_spec`). Every key of
    another part stays byte-equal."""
    import time

    from orb_slam2_aruco_tpu import config as jconfig
    from orb_slam2_aruco_tpu.io import synthetic as jsyn
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem

    drop = tuple(f"ref_{p}_" for p in parts)
    for name in which:
        t0 = time.perf_counter()
        path = os.path.join(out_dir, f"ref_{name}.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if not k.startswith(drop)}
        cfg, world_kw, _, loc_params = SETUPS[name]()
        imgs, _ = render_frames(jsyn, world_kw, cfg.camera, loc_params,
                                cfg.aruco.dictionary)
        if "quad" in parts:
            quads = [jax_quads_k4(half_res_binary(imgs[i], cfg.aruco),
                                  cfg.aruco) for i in QUAD_FRAMES[name]]
            arrays.update(
                ref_quad_frames=np.asarray(QUAD_FRAMES[name], np.int32),
                ref_quad_q=np.stack([q[0] for q in quads]),
                ref_quad_score=np.stack([q[1] for q in quads]),
                ref_quad_valid=np.stack([q[2] for q in quads]))
            print(f"{name}: quads {[int(q[2].sum()) for q in quads]} valid,"
                  f" {time.perf_counter() - t0:.0f} s", flush=True)
        for part in ("tb", "stream", "dstream"):
            if part not in parts or (part == "dstream" and name != "full"):
                continue
            t1 = time.perf_counter()
            if part == "tb":
                arrays.update(_record_track_batch(cfg, path, imgs,
                                                  TB_CHUNK[name]))
            elif part == "stream":
                arrays.update(_record_stream(cfg, path, imgs,
                                             STREAM_SPECS[name]))
            else:
                arrays.update(_record_stream(
                    cfg, path, imgs,
                    default_stream_spec(jconfig, SlamSystem.localize_stream),
                    prefix="ref_dstream_"))
            print(f"{name}: {part} recorded in "
                  f"{time.perf_counter() - t1:.0f} s", flush=True)
        np.savez_compressed(path, **arrays)
        print(f"{path}: serving parts {list(parts)}, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)


# ---------------------------------------------------------------------------
# SLAM mode (ref_slam_* keys)
# ---------------------------------------------------------------------------


def slam_cfg(cfg):
    """`cfg` in non-pipelined SLAM mode (tracking.pipeline_depth = 0, the
    configuration default), either package's SlamConfig."""
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                    pipeline_depth=0))


# host-side SlamSystem attributes of a recorded SLAM step (ref_slam_step_*)
STEP_SCALARS = ("state", "n_keyframes", "last_kf_frame_id",
                "last_reloc_frame_id", "ref_kf", "last_kf_slot",
                "prev_kf_slot", "init_frame_id")
STEP_FRAMES = ("frame", "last_frame", "init_frame")


def _slam_snapshot(slam, frame):
    """The JAX SlamSystem's state before it steps `frame` (a depth-0 SLAM
    step), as numpy: the map (map_*), the host counters, the frames
    (frame_*, last_frame_*, init_frame_*), last_obs, last_pose and vel,
    with has_* flags for the optional ones."""
    out = {f"map_{f}": np.asarray(getattr(slam.map, f))
           for f in slam.map._fields}
    out["kf_valid_host"] = slam._kf_valid_host.copy()
    out["kf_ts64"] = slam.kf_ts64.copy()
    for a in STEP_SCALARS:
        v = getattr(slam, a)
        out[a] = np.asarray(v.value if a == "state" else int(v), np.int64)
    out["init_ts"] = np.asarray(getattr(slam, "init_ts", 0.0), np.float64)
    for name, fr in zip(STEP_FRAMES, (frame, slam.last_frame,
                                       slam.init_frame)):
        out[f"has_{name}"] = np.asarray(fr is not None)
        for f in fr._fields if fr is not None else frame._fields:
            out[f"{name}_{f}"] = np.asarray(getattr(
                fr if fr is not None else frame, f))
    N = frame.kp_uv.shape[0]
    out["has_last_obs"] = np.asarray(slam.last_obs is not None)
    out["last_obs"] = (np.asarray(slam.last_obs) if slam.last_obs is not None
                       else np.full(N, -1, np.int32))
    for name in ("last_pose", "vel"):
        v = getattr(slam, name)
        out[f"has_{name}"] = np.asarray(v is not None)
        out[f"{name}_R"] = np.asarray(v[0] if v is not None else np.eye(3),
                                      np.float32)
        out[f"{name}_t"] = np.asarray(v[1] if v is not None else np.zeros(3),
                                      np.float32)
    return out


def _jax_slam_run(cfg, imgs, gt, snapshots=None):
    """The JAX SlamSystem at pipeline_depth 0 over `imgs` (track_monocular's
    steps, with the frame and, where `snapshots` is a list, the system's
    state before each step recorded): (system, ref_slam_* arrays without
    the prefix). Raises if the run reaches loop detection, which the port
    skips."""
    from unittest import mock

    import jax.numpy as jnp

    from orb_slam2_aruco_tpu.io import trajectory
    from orb_slam2_aruco_tpu.pipeline import loop_closing
    from orb_slam2_aruco_tpu.pipeline.frontend import make_frame
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem, TrackingState

    detect_calls = []
    real_detect = loop_closing.detect_loops

    def counted(*a, **k):
        detect_calls.append(1)
        return real_detect(*a, **k)

    slam = SlamSystem(cfg)
    st, Rs, ts, nkf, ins, npts = [], [], [], [], [], []
    with mock.patch.object(loop_closing, "detect_loops", counted):
        for i, img in enumerate(imgs):
            before = slam.stats["kf_inserted"]
            frame = make_frame(jnp.asarray(img), slam.cam, cfg)
            if snapshots is not None:
                snapshots.append(_slam_snapshot(slam, frame))
            fid = slam.frame_id
            slam.frame_id += 1
            p = slam._step_frame(frame, fid, i / 30.0)
            R, t = (p if p is not None else
                    (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))
            st.append(slam.state.value)
            Rs.append(np.asarray(R, np.float32))
            ts.append(np.asarray(t, np.float32))
            nkf.append(slam.n_keyframes)
            ins.append(slam.stats["kf_inserted"] - before)
            npts.append(int(slam.map.num_points()))
    if detect_calls:
        raise RuntimeError("the SLAM recording reached loop detection; the "
                           "port skips that step")
    st = np.asarray(st, np.int32)
    ok = st == TrackingState.OK.value
    gt_R = np.stack([g[0] for g in gt]).astype(np.float32)
    gt_t = np.stack([g[1] for g in gt]).astype(np.float32)
    est_c = trajectory.camera_centers(np.stack(Rs)[ok], np.stack(ts)[ok])
    ate = trajectory.ate_rmse(est_c, trajectory.camera_centers(
        gt_R[ok], gt_t[ok]), align=True, with_scale=False)
    return slam, dict(
        state=st, R=np.stack(Rs), t=np.stack(ts),
        n_kf=np.asarray(nkf, np.int32),
        kf_insert=np.asarray(ins, np.int32),
        n_points=np.asarray(npts, np.int32), gt_R=gt_R, gt_t=gt_t,
        ate=np.asarray(ate, np.float64))


def add_slam_reference(which=("small", "full"), out_dir=DATA_DIR):
    """Record, into the existing ref_<which>.npz, the JAX SlamSystem in
    non-pipelined SLAM mode over the map frames (`ref_map_params`): per
    frame its state, pose, keyframe count, keyframe inserts and valid point
    count; the final keyframe trajectory, stats and ATE; then the
    localization of the mid-point frames (`ref_loc_params`) against the map
    that run built. ref_small also records the system's state before every
    step (ref_slam_step_*, `_slam_snapshot`), and the same run over a
    second scene, `SMALL_SHIFTED_PARAMS` (ref_slam_shift_*). No recording
    reaches the loop-detection step (`loop_closing.detect_loops` is counted
    and must stay uncalled: every run keeps fewer keyframes than
    `cfg.loop.min_kfs_between_loops`)."""
    import time

    from orb_slam2_aruco_tpu.io import synthetic as jsyn
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem, TrackingState

    for name in which:
        t0 = time.perf_counter()
        path = os.path.join(out_dir, f"ref_{name}.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files
                      if not k.startswith("ref_slam_")}
        base_cfg, world_kw, map_params, loc_params = SETUPS[name]()
        cfg = slam_cfg(base_cfg)
        imgs, gt = render_frames(jsyn, world_kw, cfg.camera, map_params,
                                 cfg.aruco.dictionary)
        steps = [] if name == "small" else None
        slam, run = _jax_slam_run(cfg, imgs, gt, steps)
        kf_fid, _, kf_R, kf_t = slam.keyframe_trajectory()
        with tempfile.TemporaryDirectory() as tmp:
            mpath = os.path.join(tmp, "map.npz")
            slam.save_map(mpath)
            loc = SlamSystem(cfg)
            loc.load_map(mpath)
        loc_imgs, _ = render_frames(jsyn, world_kw, cfg.camera, loc_params,
                                    cfg.aruco.dictionary)
        lok, lR, lt = [], [], []
        for i, img in enumerate(loc_imgs):
            p = loc.track_monocular(img, ts=100.0 + i / 30.0)
            lok.append(loc.state is TrackingState.OK and p is not None)
            R, t = (p if p is not None else
                    (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))
            lR.append(np.asarray(R, np.float32))
            lt.append(np.asarray(t, np.float32))
        arrays.update({f"ref_slam_{k}": v for k, v in run.items()})
        arrays.update(
            ref_slam_kf_fid=np.asarray(kf_fid, np.int32),
            ref_slam_kf_R=np.asarray(kf_R, np.float32),
            ref_slam_kf_t=np.asarray(kf_t, np.float32),
            ref_slam_stats=np.asarray(json.dumps(
                {k: int(v) for k, v in slam.stats.items()})),
            ref_slam_loc_ok=np.asarray(lok), ref_slam_loc_R=np.stack(lR),
            ref_slam_loc_t=np.stack(lt))
        if steps:
            arrays.update({f"ref_slam_step_{k}":
                           np.stack([step[k] for step in steps])
                           for k in steps[0]})
        if name == "small":
            simgs, sgt = render_frames(jsyn, world_kw, cfg.camera,
                                       SMALL_SHIFTED_PARAMS,
                                       cfg.aruco.dictionary)
            _, shift = _jax_slam_run(cfg, simgs, sgt)
            arrays.update({f"ref_slam_shift_{k}": v
                           for k, v in shift.items()})
        np.savez_compressed(path, **arrays)
        print(f"{path}: SLAM states {run['state'].tolist()}, inserts at "
              f"{np.flatnonzero(run['kf_insert']).tolist()}, keyframes "
              f"{kf_fid.tolist()}, points {run['n_points'][-1]}, ATE "
              f"{float(run['ate']):.5f} m, stats {slam.stats}, "
              f"loc ok {int(np.sum(lok))}/{len(lok)}, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)


# ---------------------------------------------------------------------------
# loop closing and BoW-PnP relocalization (ref_loop_* keys)
# ---------------------------------------------------------------------------

# the controlled drift of tests/test_pipeline.py::
# test_full_system_loop_closure: the map built after frame LOOP_CUTOFF is
# rigidly displaced by (so3_exp(LOOP_DRIFT_W), LOOP_DRIFT_T) once frame
# LOOP_INJECT is tracked
LOOP_DRIFT_W = (0.0, -0.06, 0.0)
LOOP_DRIFT_T = (0.65, 0.0, 0.2)
LOOP_INJECT, LOOP_CUTOFF = 32, 18
# frames after the pan: -1 black (tracking is lost), -2 binary noise (no
# structure of the map: must not relocalize), k the pan's frame k
BLACK, NOISE = -1, -2


def loop_cfg(cfg):
    """The loop scenes' SLAM settings (test_full_system_loop_closure): a
    keyframe every 2 frames (kf_ref_ratio 2 passes NeedNewKeyFrame's c2),
    loops after 6 keyframes, no keyframe culling; depth 0. Either
    package's SlamConfig."""
    return cfg.replace(
        loop=dataclasses.replace(cfg.loop, min_kfs_between_loops=6),
        tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=30,
                                     min_frames_between_kf=2,
                                     kf_ref_ratio=2.0, pipeline_depth=0),
        map=dataclasses.replace(cfg.map, kf_cull_redundancy=1.1))


def _pan(n, x0, x1, y, dist, pitch=0.03, n_back=None):
    """Render parameters of a pan from x0 to x1 in n // 2 frames and back
    to x0 in the other n - n // 2, or only the first n_back of those."""
    xs = np.concatenate([np.linspace(x0, x1, n // 2),
                         np.linspace(x1, x0, n - n // 2)[:n_back]])
    return [(float(x), y, dist, 0.0, pitch) for x in xs]


def _loop_small():
    """test_full_system_loop_closure's own scene and configuration: 4
    markers at the left of a long wall, a 60-frame pan away and back."""
    from orb_slam2_aruco_tpu.config import CameraConfig, SlamConfig

    camc = CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                        dist=(0, 0, 0, 0, 0), width=320, height=240)
    cfg = SlamConfig().replace(camera=camc)
    cfg = cfg.replace(
        orb=dataclasses.replace(cfg.orb, num_features=700),
        map=dataclasses.replace(cfg.map, max_keyframes=40, max_points=4096,
                                max_markers=16))
    world = dict(marker_ids=[3, 17, 42, 99], px_per_m=700.0, spacing=0.45,
                 grid_cols=2, marker_size=0.165, extent_margin=2.2)
    extra = [BLACK, BLACK, NOISE, LOOP_EXTRA["small"][0], BLACK, BLACK,
             LOOP_EXTRA["small"][1]]
    return loop_cfg(cfg), world, _pan(60, 0.2, 1.4, 0.22, 1.2), extra


def _loop_full():
    """The scene at the bench configuration's widths (_full_setup's camera,
    features, levels, detect_downsample and capacities): the bench
    world's 8 marker ids in two columns at the left of a wall 8 m wide; a
    pan 1.2 m from it, 40 frames away (the markers leave the view at frame
    23) and 22 frames back, to where the markers are back in view and the
    loop has closed (frame 60: 31 keyframes, so the post-loop global BA
    takes the CG branch). The return stops there: the JAX package's own run
    one float32 ulp apart leaves this one from frame 64 on, where it was
    continued to the start (tools/torch_loop_sensitivity.py)."""
    cfg, _, _, _ = _full_setup()
    world = dict(marker_ids=[3, 17, 42, 99, 7, 23, 55, 88], px_per_m=500.0,
                 spacing=0.45, grid_cols=2, marker_size=0.165,
                 extent_margin=3.8)
    extra = [BLACK, BLACK, NOISE, LOOP_EXTRA["full"][0], BLACK, BLACK,
             LOOP_EXTRA["full"][1]]
    return (loop_cfg(cfg), world,
            _pan(80, 0.2, 2.8, 0.675, 1.2, n_back=22),
            extra)


# the step closing the small scene's loop, where its snapshot is taken
LOOP_SNAPSHOT_STEP = {"small": 41}
# (marker-free frame of the away leg, start-area frame) fed after the pan
LOOP_EXTRA = {"small": (26, 2), "full": (24, 2)}
LOOP_SETUPS = {"small": _loop_small, "full": _loop_full}


def jax_inject_drift(slam, cutoff_fid, Rd, td):
    """test_full_system_loop_closure's drift on the JAX SlamSystem: the
    late map segment and the tracking context displaced by X' = Rd X + td,
    Tcw' = Tcw D^-1."""
    import jax.numpy as jnp

    st = slam.map
    Rd = jnp.asarray(Rd, jnp.float32)
    td = jnp.asarray(td, jnp.float32)
    late_kf = st.kf_valid & (st.kf_frame_id > cutoff_fid)
    R2 = jnp.einsum("kij,lj->kil", st.kf_Rcw, Rd.T)
    t2 = st.kf_tcw - jnp.einsum("kij,j->ki", R2, td)
    ref = jnp.clip(st.pt_ref_kf, 0, st.K - 1)
    late_pt = st.pt_valid & (st.pt_ref_kf >= 0) & late_kf[ref]
    obs = (st.kf_mk_slot >= 0) & st.kf_mk_valid & st.kf_valid[:, None]
    M = st.M
    any_obs = jnp.zeros((M,), bool).at[
        jnp.where(obs, st.kf_mk_slot, M)].max(obs, mode="drop")
    early = obs & ~late_kf[:, None]
    early_obs = jnp.zeros((M,), bool).at[
        jnp.where(early, st.kf_mk_slot, M)].max(early, mode="drop")
    late_mk = st.mk_valid & any_obs & ~early_obs
    slam.map = st._replace(
        kf_Rcw=jnp.where(late_kf[:, None, None], R2, st.kf_Rcw),
        kf_tcw=jnp.where(late_kf[:, None], t2, st.kf_tcw),
        pt_xyz=jnp.where(late_pt[:, None], st.pt_xyz @ Rd.T + td, st.pt_xyz),
        mk_Rwm=jnp.where(late_mk[:, None, None],
                         jnp.einsum("ij,mjk->mik", Rd, st.mk_Rwm), st.mk_Rwm),
        mk_twm=jnp.where(late_mk[:, None], st.mk_twm @ Rd.T + td,
                         st.mk_twm))
    Rl, tl = slam.last_pose
    Rl2 = Rl @ Rd.T
    slam.last_pose = (Rl2, tl - Rl2 @ td)


def loop_extra_frame(k, imgs):
    """The frame of an entry of the extra list."""
    if k == BLACK:
        return np.zeros_like(imgs[0])
    if k == NOISE:
        rng = np.random.default_rng(3)
        return (rng.integers(0, 2, size=imgs[0].shape) * 255).astype(
            np.float32)
    return imgs[k]


def seam_error(fids, Rs, ts, gt):
    """test_full_system_loop_closure's contract: the first -> last keyframe
    translation in the first keyframe's frame against the ground truth's
    (gauge-free), in metres. gt: the pan's (R, t) per frame."""
    from orb_slam2_aruco_tpu_torch.io import trajectory

    est_c = trajectory.camera_centers(Rs, ts)
    gt_c = trajectory.camera_centers([gt[i][0] for i in fids],
                                     [gt[i][1] for i in fids])
    rel_est = np.asarray(Rs[0], np.float64) @ (est_c[-1] - est_c[0])
    rel_gt = np.asarray(gt[fids[0]][0], np.float64) @ (gt_c[-1] - gt_c[0])
    return float(np.linalg.norm(rel_est - rel_gt))


LOOP_HOST = ("pending_gba_iters", "pending_gba_fuse", "_gba_shape_kfs",
             "_gba_pt_offset", "last_loop_kf_count")


def _loop_snapshot(slam, frame):
    """_slam_snapshot and the loop closing's host state: LOOP_HOST, the GBA
    bucket (0, 0 if none) and the BoW consistency groups ([8, 2], rows of
    -1 after the last)."""
    out = _slam_snapshot(slam, frame)
    for a in LOOP_HOST:
        out[a] = np.asarray(int(getattr(slam, a, 0)), np.int64)
    out["gba_shape"] = np.asarray(slam._gba_shape or (0, 0), np.int64)
    prev = np.full((8, 2), -1, np.int64)
    groups = slam.bow_consistency.prev[:8]
    prev[:len(groups)] = np.asarray(groups, np.int64).reshape(-1, 2)
    out["bow_prev"] = prev
    return out


def jax_loop_run(name, nudge=None, extra=None, snapshots=None):
    """The JAX SlamSystem at depth 0 over a loop scene: the pan with the
    drift injected after frame LOOP_INJECT, keyframe_trajectory() (the
    pending global BA drained), then the extra frames (`extra` replaces the
    scene's list). `nudge` maps each Frame before it is stepped
    (tools/torch_loop_sensitivity.py). Returns the ref_loop_* arrays
    without the prefix; corr_kf_* are the keyframe poses the first loop
    correction left, before any global BA slice. Where `snapshots` is a
    list it receives the system's state (_loop_snapshot) before the step
    that closes the first loop and before the first extra frame."""
    from unittest import mock

    import jax.numpy as jnp

    from orb_slam2_aruco_tpu.geometry.lie import so3_exp
    from orb_slam2_aruco_tpu.io import synthetic as jsyn
    from orb_slam2_aruco_tpu.pipeline import loop_closing, tracking
    from orb_slam2_aruco_tpu.pipeline.frontend import make_frame
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem

    cfg, world, params, scene_extra = LOOP_SETUPS[name]()
    extra = scene_extra if extra is None else extra
    snapshots_at = [LOOP_SNAPSHOT_STEP.get(name, -1)]
    imgs, gt = render_frames(jsyn, world, cfg.camera, params,
                             cfg.aruco.dictionary, uint8=False)
    slam = SlamSystem(cfg)
    loops, kind, step, corrected = [], [], [0], []
    real = {f: getattr(loop_closing, f) for f in
            ("correct_loop", "compute_sim3", "compute_sim3_classic")}

    def correct(state, k, kf_loop, s, R, t, *a, **kw):
        loops.append((step[0], int(k), int(kf_loop), kind[-1], float(s),
                      np.asarray(R), np.asarray(t)))
        out = real["correct_loop"](state, k, kf_loop, s, R, t, *a, **kw)
        if not corrected:
            v = np.asarray(out[0].kf_valid)
            order = np.argsort(np.asarray(out[0].kf_frame_id)[v])
            corrected.extend(np.asarray(getattr(out[0], f))[v][order]
                             for f in ("kf_frame_id", "kf_Rcw", "kf_tcw"))
        return out

    def sim3(by_marker):
        fn = real["compute_sim3" if by_marker else "compute_sim3_classic"]

        def run(*a, **kw):
            kind.append(int(by_marker))
            return fn(*a, **kw)
        return run

    real_reloc = SlamSystem._relocalize
    reloc_kind = {}

    def relocalize(self, frame, fid, ts):
        slots = tracking.bind_markers(self.map, frame)
        ok = tracking.aruco_pose_candidate(self.map, frame, slots, self.cam,
                                           self.cfg)[0]
        before = self.stats["reloc"]
        out = real_reloc(self, frame, fid, ts)
        if self.stats["reloc"] > before:
            reloc_kind[step[0]] = int(bool(ok))
        return out

    rec = {k: [] for k in ("state", "R", "t", "n_kf", "kf_insert",
                           "n_points", "gba_cams")}

    def do_step(img, ts, snap=False):
        frame = make_frame(jnp.asarray(img), slam.cam, cfg)
        if nudge is not None:
            frame = nudge(frame)
        if snap:
            snapshots.append(_loop_snapshot(slam, frame))
        fid = slam.frame_id
        slam.frame_id += 1
        before = slam.stats["kf_inserted"]
        p = slam._step_frame(frame, fid, ts)
        R, t = (p if p is not None else
                (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))
        for k, v in (("state", slam.state.value),
                     ("R", np.asarray(R, np.float32)),
                     ("t", np.asarray(t, np.float32)),
                     ("n_kf", slam.n_keyframes),
                     ("kf_insert", slam.stats["kf_inserted"] - before),
                     ("n_points", int(slam.map.num_points())),
                     ("gba_cams", slam._gba_shape[0] if slam._gba_shape
                      else 0)):
            rec[k].append(v)
        step[0] += 1

    with mock.patch.multiple(loop_closing, correct_loop=correct,
                             compute_sim3=sim3(True),
                             compute_sim3_classic=sim3(False)), \
            mock.patch.object(SlamSystem, "_relocalize", relocalize):
        for i, img in enumerate(imgs):
            # the step closing the loop is known from a first run
            do_step(img, i / 30.0, snapshots is not None
                    and i == snapshots_at[0])
            if i == LOOP_INJECT:
                jax_inject_drift(slam, LOOP_CUTOFF, so3_exp(
                    jnp.asarray(LOOP_DRIFT_W, jnp.float32)), LOOP_DRIFT_T)
        kf_fid, _, kf_R, kf_t = slam.keyframe_trajectory()
        n_valid = int(slam.map.num_points())
        for j, k in enumerate(extra):
            do_step(loop_extra_frame(k, imgs), 100.0 + j / 30.0,
                    snapshots is not None and j == 0)
    out = {k: np.asarray(v, np.float32 if k in ("R", "t") else np.int32)
           for k, v in rec.items()}
    L = len(loops)
    out.update(
        cfg=np.asarray(json.dumps(dataclasses.asdict(cfg))),
        world=np.asarray(json.dumps(world)),
        params=np.asarray(params, np.float64),
        extra=np.asarray(extra, np.int32),
        loops=np.asarray([lp[:4] for lp in loops], np.int32).reshape(L, 4),
        loop_s=np.asarray([lp[4] for lp in loops], np.float32),
        loop_R=np.asarray([lp[5] for lp in loops], np.float32).reshape(
            L, 3, 3),
        loop_t=np.asarray([lp[6] for lp in loops], np.float32).reshape(L, 3),
        kf_fid=np.asarray(kf_fid, np.int32),
        kf_R=np.asarray(kf_R, np.float32), kf_t=np.asarray(kf_t, np.float32),
        corr_kf_fid=np.asarray(corrected[0], np.int32),
        corr_kf_R=np.asarray(corrected[1], np.float32),
        corr_kf_t=np.asarray(corrected[2], np.float32),
        n_valid=np.asarray(n_valid, np.int32),
        seam=np.asarray(seam_error(kf_fid, kf_R, kf_t, gt), np.float64),
        reloc_marker=np.asarray([reloc_kind.get(i, -1)
                                 for i in range(len(out["state"]))],
                                np.int32),
        stats=np.asarray(json.dumps({k: int(v) for k, v in
                                     slam.stats.items()
                                     if not k.startswith("_")})))
    return out


def add_loop_reference(which=("small", "full"), out_dir=DATA_DIR):
    """Record, into the existing ref_<which>.npz, the JAX SlamSystem over
    its loop scene (jax_loop_run: ref_loop_* keys; the other keys stay
    byte-equal)."""
    import time

    for name in which:
        t0 = time.perf_counter()
        path = os.path.join(out_dir, f"ref_{name}.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files
                      if not k.startswith("ref_loop_")}
        snaps = [] if name in LOOP_SNAPSHOT_STEP else None
        run = jax_loop_run(name, snapshots=snaps)
        arrays.update({f"ref_loop_{k}": v for k, v in run.items()})
        if snaps:
            if len(snaps) != 2:
                raise RuntimeError(f"{name}: {len(snaps)} snapshots")
            arrays.update({f"ref_loop_snap_{k}":
                           np.stack([sn[k] for sn in snaps])
                           for k in snaps[0]})
        np.savez_compressed(path, **arrays)
        n = len(run["params"])
        print(f"{path}: loop scene states {run['state'].tolist()}, inserts "
              f"at {np.flatnonzero(run['kf_insert'][:n]).tolist()}, loops "
              f"{run['loops'].tolist()} (GBA cameras "
              f"{sorted(set(run['gba_cams'].tolist()))}), keyframes "
              f"{len(run['kf_fid'])}, points {int(run['n_valid'])}, seam "
              f"{float(run['seam']):.5f} m, relocalizations (marker) "
              f"{run['reloc_marker'].tolist()}, stats {str(run['stats'])}, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)


# ---------------------------------------------------------------------------
# pipelined SLAM mode (ref_pipe_* keys)
# ---------------------------------------------------------------------------

# pipeline depth of each file's pipelined run: ref_full's own configuration
# (bench.py's SLAM pass), and 2 on the small setup's shifted scene
PIPE_DEPTH = {"small": 2, "full": 4}
# the rewind run (tests/test_stream.py::
# test_pipelined_lost_rewind_and_recovery): the run's frames 0-7 (ref_small:
# the shifted scene, initialized at frame 4; ref_full: the map frames,
# initialized at frame 6), three black frames, frames 8-11; -1 = black
PIPE_REWIND_ORDER = list(range(8)) + [-1, -1, -1] + list(range(8, 12))


def pipe_cfg(cfg, depth, **tracking):
    """`cfg` at tracking.pipeline_depth `depth` (either package's
    SlamConfig)."""
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, pipeline_depth=depth, **tracking))


def pipe_params(name):
    """Render parameters of a file's pipelined run: the map frames of
    ref_full, the shifted scene of ref_small."""
    return SETUPS[name]()[2] if name == "full" else SMALL_SHIFTED_PARAMS


def pipe_scene(name, cfg, syn):
    """(frames, ground truth per frame) of a file's pipelined run; `syn` is
    either package's io.synthetic."""
    return render_frames(syn, SETUPS[name]()[1], cfg.camera,
                         pipe_params(name), cfg.aruco.dictionary)


def rewind_frames(imgs, gt):
    """(frames, ground truth or None) of PIPE_REWIND_ORDER."""
    black = np.zeros_like(imgs[0])
    return ([black if k < 0 else imgs[k] for k in PIPE_REWIND_ORDER],
            [None if k < 0 else gt[k] for k in PIPE_REWIND_ORDER])


def frame_ts(j):
    """Timestamp of a pipelined run's j-th frame."""
    return j / 30.0


def trajectory_ate(fids, states, Rs, ts, gt):
    """ATE (SE3-aligned) of the OK records against their frames' ground
    truth, by the port's io.trajectory."""
    from orb_slam2_aruco_tpu_torch.io import trajectory

    ok = [i for i, s in enumerate(states) if s == 2 and gt[fids[i]]
          is not None]
    est = trajectory.camera_centers([Rs[i] for i in ok], [ts[i] for i in ok])
    ref = trajectory.camera_centers([gt[fids[i]][0] for i in ok],
                                    [gt[fids[i]][1] for i in ok])
    return trajectory.ate_rmse(est, ref, align=True, with_scale=False)


def pipe_run(system, mapping, imgs, gt):
    """A fresh SlamSystem of either package (`mapping` is its
    pipeline.mapping module) over `imgs` through track_monocular (frame j
    at ts frame_ts(j)), then flush(): the ref_pipe_* arrays without the
    prefix — the trajectory records (fid, state, R, t), the frame ids of
    every keyframe created in creation order (inserts), the frames
    relocalized (reloc_fid), the keyframes after the flush, stats, valid
    points and the ATE over the OK records."""
    from unittest import mock

    inserts, relocs = [], []
    cls = type(system)
    real_create, real_reloc = mapping.create_keyframe, cls._relocalize

    def create(*a, **kw):
        inserts.append(int(a[6]))
        return real_create(*a, **kw)

    def relocalize(self, frame, fid, ts):
        before = self.stats["reloc"]
        out = real_reloc(self, frame, fid, ts)
        if self.stats["reloc"] > before:
            relocs.append(fid)
        return out

    with mock.patch.object(mapping, "create_keyframe", create), \
            mock.patch.object(cls, "_relocalize", relocalize):
        for j, img in enumerate(imgs):
            system.track_monocular(img, ts=frame_ts(j))
        system.flush()
        recs = system.get_trajectory()
        kf_fid, _, kf_R, kf_t = system.keyframe_trajectory()
    out = dict(
        fid=np.asarray([r.frame_id for r in recs], np.int32),
        state=np.asarray([r.state.value for r in recs], np.int32),
        R=np.stack([np.asarray(r.Rcw, np.float32) for r in recs]),
        t=np.stack([np.asarray(r.tcw, np.float32) for r in recs]),
        inserts=np.asarray(inserts, np.int32),
        reloc_fid=np.asarray(relocs, np.int32),
        kf_fid=np.asarray(kf_fid, np.int32),
        kf_R=np.asarray(kf_R, np.float32), kf_t=np.asarray(kf_t, np.float32),
        stats=np.asarray(json.dumps({k: int(v) for k, v in
                                     system.stats.items()
                                     if not k.startswith("_")})),
        n_valid=np.asarray(int(system.map.num_points()), np.int32))
    out["ate"] = np.asarray(trajectory_ate(
        out["fid"].tolist(), out["state"].tolist(), out["R"], out["t"], gt),
        np.float64)
    return out


def add_pipe_reference(which=("small", "full"), out_dir=DATA_DIR):
    """Record, into the existing ref_<which>.npz, the JAX SlamSystem in
    pipelined SLAM mode (`pipe_run`; ref_pipe_* keys, the other keys
    stay byte-equal). ref_full: depth 4 over the map frames with the file's
    own ref_cfg; the map the run leaves must equal the map arrays already in
    the file (they were built the same way). ref_small: depth 2 over the
    shifted scene (`SMALL_SHIFTED_PARAMS`: the recorded small scene is
    chaotic in JAX itself, ROADMAP C2). Both: the rewind run at the file's
    depth (PIPE_REWIND_ORDER, reset_if_lost_with_kfs_leq = 0) under
    ref_pipe_rewind_*."""
    import time

    from orb_slam2_aruco_tpu.io import synthetic as jsyn
    from orb_slam2_aruco_tpu.pipeline import mapping
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem

    for name in which:
        t0 = time.perf_counter()
        path = os.path.join(out_dir, f"ref_{name}.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files
                      if not k.startswith("ref_pipe_")}
        base, _, _, _ = SETUPS[name]()
        cfg = pipe_cfg(base, PIPE_DEPTH[name])
        imgs, gt = pipe_scene(name, cfg, jsyn)
        slam = SlamSystem(cfg)
        run = pipe_run(slam, mapping, imgs, gt)
        arrays.update({f"ref_pipe_{k}": v for k, v in run.items()})
        arrays["ref_pipe_cfg"] = np.asarray(json.dumps(
            dataclasses.asdict(cfg)))
        arrays["ref_pipe_params"] = np.asarray(pipe_params(name),
                                               np.float64)
        if name == "full":
            if arrays["ref_cfg"] != arrays["ref_pipe_cfg"]:
                raise RuntimeError("ref_full's ref_cfg is not depth 4")
            with tempfile.TemporaryDirectory() as tmp:
                mpath = os.path.join(tmp, "map.npz")
                slam.save_map(mpath)
                with np.load(mpath) as z:
                    differ = [f for f in slam.map._fields
                              if not np.array_equal(z[f], arrays[f])]
            if differ:
                raise RuntimeError(f"the depth-4 re-run's map differs from "
                                   f"the file's in {differ}")
        t1 = time.perf_counter()
        rcfg = pipe_cfg(base, PIPE_DEPTH[name], reset_if_lost_with_kfs_leq=0)
        rimgs, rgt = rewind_frames(imgs, gt)
        rew = pipe_run(SlamSystem(rcfg), mapping, rimgs, rgt)
        if 2 not in rew["state"][:PIPE_REWIND_ORDER.index(-1)].tolist():
            raise RuntimeError("the rewind run had no map before its black "
                               "frames")
        arrays.update({f"ref_pipe_rewind_{k}": v for k, v in rew.items()})
        arrays["ref_pipe_rewind_order"] = np.asarray(PIPE_REWIND_ORDER,
                                                     np.int32)
        print(f"  rewind run: fids {rew['fid'].tolist()}, states "
              f"{rew['state'].tolist()}, relocalized "
              f"{rew['reloc_fid'].tolist()}, inserts "
              f"{rew['inserts'].tolist()}, "
              f"{time.perf_counter() - t1:.0f} s", flush=True)
        np.savez_compressed(path, **arrays)
        print(f"{path}: depth {PIPE_DEPTH[name]} states "
              f"{run['state'].tolist()}, inserts {run['inserts'].tolist()}, "
              f"keyframes {run['kf_fid'].tolist()}, points "
              f"{int(run['n_valid'])}, ATE {float(run['ate']):.5f} m, stats "
              f"{str(run['stats'])}, {time.perf_counter() - t0:.0f} s",
              flush=True)


# ---------------------------------------------------------------------------
# bench.py's workload (ref_bench_* keys, ref_full only)
# ---------------------------------------------------------------------------

# bench.py's serving pass (bench.py:166-208) and global-BA rate
# (:210-226): the stream's chunk and depth, its seed mode, the timed frames
# (the recording keeps the first `n_recorded`: two chunks, four wraps of
# the sweep), the BA's iterations and point bucket
BENCH_SPEC = dict(chunk=64, depth=2, loc_seed_mode="extrapolate",
                  loc_extrap_passes=1, n_timed=1024, n_recorded=128,
                  ba_iters=30, ba_max_pts=8192)


def _record_bench_stream(slam, frames, n, chunk):
    """JAX localize_stream over frames[k % len(frames)] for k < n (ts 0.0,
    StagedSource(batch=chunk)) on the warm system `slam`: (emitted ids,
    OK, R, t, rewinds), rewinds counted as _record_stream counts them."""
    from unittest import mock

    from orb_slam2_aruco_tpu.io.ingest import StagedSource
    from orb_slam2_aruco_tpu.pipeline import tracking as jtrack

    calls = []
    real_tb, real_tm = jtrack.track_batch, slam.track_monocular

    def track_batch(state, imgs_b, *a, **k):
        calls.extend("B" * imgs_b.shape[0])
        return real_tb(state, imgs_b, *a, **k)

    def track_monocular(img, ts):
        calls.append("M")
        return real_tm(img, ts)

    slam.track_monocular = track_monocular
    fid, ok, Rs, ts = [], [], [], []
    src = StagedSource([(frames[k % len(frames)], 0.0) for k in range(n)],
                       batch=chunk)
    try:
        with mock.patch.object(jtrack, "track_batch", track_batch):
            for f, _, p in slam.localize_stream(src, chunk=chunk):
                fid.append(f)
                ok.append(p is not None)
                R, t = p if p is not None else (np.eye(3), np.zeros(3))
                Rs.append(np.asarray(R, np.float32))
                ts.append(np.asarray(t, np.float32))
    finally:
        del slam.track_monocular
    rewinds = sum(1 for j, c in enumerate(calls)
                  if c == "M" and (j == 0 or calls[j - 1] == "B"))
    return (np.asarray(fid, np.int32), np.asarray(ok), np.stack(Rs),
            np.stack(ts), np.asarray(rewinds, np.int64))


def add_bench_reference(out_dir=DATA_DIR):
    """Record, into the existing ref_full.npz, the JAX package's run of
    bench.py's workload (ref_bench_* keys; every other key stays
    byte-equal): the SLAM pass at the file's depth 4 over the map frames
    through StagedSource(batch=4) (its map must equal the file's map, which
    ref_pipe_* already holds), then on that warm system
    activate_localization_mode, the extrapolate 1-pass serving config, the
    warm-up localize_stream of one chunk (ref_bench_warm_*) and the first
    BENCH_SPEC["n_recorded"] frames of the timed stream: emitted ids,
    OK/None, poses and rewinds. Last, the 30-iteration whole-map BA
    (window_all, max_cams = the map's keyframe capacity) on the file's map:
    chi2 before (0 iterations) and after, and the keyframe poses."""
    import time

    import jax.numpy as jnp

    from orb_slam2_aruco_tpu.geometry import camera as jcam
    from orb_slam2_aruco_tpu.io import checkpoint
    from orb_slam2_aruco_tpu.io import synthetic as jsyn
    from orb_slam2_aruco_tpu.io.ingest import StagedSource
    from orb_slam2_aruco_tpu.pipeline import mapping
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem, TrackingState

    t0 = time.perf_counter()
    path = os.path.join(out_dir, "ref_full.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if not k.startswith("ref_bench_")}
    cfg = SETUPS["full"]()[0]
    if arrays["ref_cfg"] != np.asarray(json.dumps(dataclasses.asdict(cfg))):
        raise RuntimeError("ref_full's ref_cfg is not bench.py's config")
    frames, _ = pipe_scene("full", cfg, jsyn)
    slam = SlamSystem(cfg)
    for img, ts in StagedSource([(f, k / 30.0) for k, f in enumerate(frames)],
                                batch=4):
        slam.track_monocular(img, ts=ts)
    slam.flush()
    if slam.state is not TrackingState.OK:
        raise RuntimeError(f"the bench's SLAM pass ended {slam.state}")
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "map.npz")
        slam.save_map(mpath)
        with np.load(mpath) as z:
            differ = [f for f in slam.map._fields
                      if not np.array_equal(z[f], arrays[f])]
    if differ:
        raise RuntimeError(f"the bench's SLAM pass left a map that differs "
                           f"from the file's in {differ}")
    t1 = time.perf_counter()
    spec = BENCH_SPEC
    slam.activate_localization_mode()
    slam.cfg = serving_cfg(slam.cfg, spec["loc_seed_mode"],
                           spec["loc_extrap_passes"],
                           slam.cfg.tracking.loc_two_stage)
    lf = slam.last_frame
    vel = slam.vel if slam.vel is not None else (np.eye(3), np.zeros(3))
    # the warm system's tracking state the stream starts from (TB_INPUTS)
    warm_in = dict(R_last=slam.last_pose[0], t_last=slam.last_pose[1],
                   vel_R=vel[0], vel_t=vel[1], last_uv=lf.kp_uv,
                   last_desc=lf.desc, last_obs=slam.last_obs,
                   last_valid=lf.kp_valid, last_octave=lf.kp_octave,
                   last_angle=lf.kp_angle, ref_kf=slam.ref_kf,
                   pt_visible=slam.map.pt_visible,
                   pt_found=slam.map.pt_found)
    out = {"spec": np.asarray(json.dumps(spec)),
           "in_has_vel": np.asarray(slam.vel is not None),
           "in_frame_id": np.asarray(slam.frame_id, np.int64)}
    out.update({f"in_{k}": np.asarray(v) for k, v in warm_in.items()})
    for pre, n in (("warm_", spec["chunk"]), ("", spec["n_recorded"])):
        got = _record_bench_stream(slam, frames, n, spec["chunk"])
        out.update({pre + k: v for k, v in
                    zip(("fid", "ok", "R", "t", "rewinds"), got)})
        print(f"  {pre or 'timed '}stream: {len(got[0])} frames, ids "
              f"{int(got[0][0])}-{int(got[0][-1])}, {int((~got[1]).sum())} "
              f"None, rewinds {int(got[4])}", flush=True)
    t2 = time.perf_counter()
    state = checkpoint.load_map(path)
    cam = jcam.camera_from_config(cfg.camera)
    ba_kw = dict(max_cams=cfg.map.max_keyframes, max_pts=spec["ba_max_pts"],
                 window_all=True)
    _, chi0 = mapping.bundle_adjust(state, jnp.asarray(0), cam, cfg,
                                    iters=0, **ba_kw)
    ba_state, chi = mapping.bundle_adjust(state, jnp.asarray(0), cam, cfg,
                                          iters=spec["ba_iters"], **ba_kw)
    live = np.flatnonzero(np.asarray(ba_state.kf_valid))
    out.update(ba_chi0=np.asarray(chi0, np.float32),
               ba_chi=np.asarray(chi, np.float32),
               ba_kf=live.astype(np.int32),
               ba_kf_R=np.asarray(ba_state.kf_Rcw)[live],
               ba_kf_t=np.asarray(ba_state.kf_tcw)[live])
    print(f"  BA: chi2 {float(chi0):.6g} -> {float(chi):.6g} over "
          f"{len(live)} live keyframes", flush=True)
    arrays.update({f"ref_bench_{k}": v for k, v in out.items()})
    np.savez_compressed(path, **arrays)
    print(f"{path}: bench recorded; SLAM pass {t1 - t0:.0f} s, streams "
          f"{t2 - t1:.0f} s, BA {time.perf_counter() - t2:.0f} s",
          flush=True)


# the real-footage sequence (tests/test_ingest.py::test_video_25h7_two_pass_
# ate's): tools/independent_seq.py's ARUCO_MIP_25h7 fly-by, written as an
# MJPG video, decoded by the JAX VideoSource and run through the JAX
# examples/mono_video.py CLI with these options
VIDEO_SEQ = dict(n_frames=18, width=480, height=360,
                 dict_name="ARUCO_MIP_25h7", noise_sigma=3.0)
VIDEO_ARGS = ["--dict", "ARUCO_MIP_25h7", "--marker-size", "0.165",
              "--features", "700", "--two-pass", "--chunk", "6"]
VIDEO_PATH = os.path.join(DATA_DIR, "ref_video.npz")


def add_video_reference(out_path=VIDEO_PATH):
    """Record ref_video.npz: the 25h7 fly-by's frames as the JAX VideoSource
    decodes them from the MJPG file (frames, ts), the ground truth (gt_R,
    gt_t) and calibration (K), and the JAX CLI's run over that file
    (VIDEO_ARGS, --cpu, the OpenCV calibration yml): pass-1 state per frame
    id (-1 without a record; pass 2's records follow with later ids), keyframe count and keyframe frame ids, stats,
    the second pass's poses (pass2_ok, pass2_R, pass2_t) and their ATE
    against the ground truth (SE3-aligned)."""
    import runpy
    import time
    from unittest import mock

    import cv2

    from orb_slam2_aruco_tpu.config import CameraConfig
    from orb_slam2_aruco_tpu.io import ingest, trajectory
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from independent_seq import render_sequence, write_video

    t0 = time.perf_counter()
    frames, poses, K, _ = render_sequence(**VIDEO_SEQ)
    w, h = VIDEO_SEQ["width"], VIDEO_SEQ["height"]
    systems, pass2 = [], []
    real_init = SlamSystem.__init__
    real_batch = SlamSystem.track_monocular_batch

    def init(self, *a, **k):
        systems.append(self)
        real_init(self, *a, **k)

    def batch(self, *a, **k):
        out = real_batch(self, *a, **k)
        pass2.extend(out)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        vid = os.path.join(tmp, "seq25h7.avi")
        write_video(vid, frames)
        calib = os.path.join(tmp, "calib.yml")
        fs = cv2.FileStorage(calib, cv2.FILE_STORAGE_WRITE)
        fs.write("camera_matrix", K)
        fs.write("distortion_coefficients", np.zeros((1, 5)))
        fs.write("image_width", w)
        fs.write("image_height", h)
        fs.release()
        camc = CameraConfig(fx=float(K[0, 0]), fy=float(K[1, 1]),
                            cx=float(K[0, 2]), cy=float(K[1, 2]),
                            dist=(0, 0, 0, 0, 0), width=w, height=h)
        decoded = list(ingest.VideoSource(vid, camc))
        argv = ["mono_video.py", "--video", vid, "--camera", calib,
                "--out", os.path.join(tmp, "traj.tum"), "--cpu"] + VIDEO_ARGS
        old = sys.argv
        sys.argv = argv
        try:
            with mock.patch.object(SlamSystem, "__init__", init), \
                    mock.patch.object(SlamSystem, "track_monocular_batch",
                                      batch):
                runpy.run_path(os.path.join(REPO, "examples", "mono_video.py"),
                               run_name="__main__")
        finally:
            sys.argv = old
    slam, = systems
    n = len(decoded)
    state = np.full(n, -1, np.int32)
    for r in slam.get_trajectory():
        if r.frame_id < n:                   # pass 1; pass 2's ids follow
            state[r.frame_id] = r.state.value
    fids, _, _, _ = slam.keyframe_trajectory()
    ok = np.asarray([p is not None for p in pass2])
    eye = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    R2 = np.stack([np.asarray((p or eye)[0], np.float32) for p in pass2])
    t2 = np.stack([np.asarray((p or eye)[1], np.float32) for p in pass2])
    gt_R = np.stack([np.asarray(g[0], np.float32) for g in poses])
    gt_t = np.stack([np.asarray(g[1], np.float32) for g in poses])
    ate = trajectory.ate_rmse(
        trajectory.camera_centers(R2[ok], t2[ok]),
        trajectory.camera_centers(gt_R[ok], gt_t[ok]), align=True,
        with_scale=False)
    np.savez_compressed(
        out_path, frames=np.stack([f for f, _ in decoded]),
        ts=np.asarray([t for _, t in decoded], np.float64),
        K=np.asarray(K, np.float64), gt_R=gt_R, gt_t=gt_t,
        state=state, n_kf=np.asarray(slam.n_keyframes, np.int32),
        kf_fid=np.asarray(fids, np.int32), pass2_ok=ok, pass2_R=R2,
        pass2_t=t2, ate=np.asarray(ate, np.float64),
        args=np.asarray(json.dumps(VIDEO_ARGS)),
        stats=np.asarray(json.dumps({k: int(v) for k, v in
                                     slam.stats.items()
                                     if not k.startswith("_")})))
    print(f"{out_path}: {n} frames, pass-1 states {state.tolist()}, "
          f"keyframes {np.asarray(fids).tolist()}, pass 2 {int(ok.sum())}/{n} "
          f"tracked, ATE {ate:.5f} m, {os.path.getsize(out_path)} bytes, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)


# the generated dictionaries' worlds: the bench world's layout (ref_full's
# _full_setup) with ids below each table's size (TPU_16h5 holds 31 codes,
# TPU_36h12 133), seen from one pose of the bench sweep with every marker
# in view; detection at the bench's aruco settings (detect_downsample=2)
DICT_SCENES = {
    "ARUCO_MIP_16h3": [3, 17, 29, 9, 7, 23, 25, 14],
    "TPU_36h12": [3, 17, 42, 99, 7, 23, 55, 88],
}
DICT_POSE = (0.9, 0.3, 2.0, 0.05, 0.04)
# what each generator call of the JAX module is recorded as
DICT_TABLES = {
    "TPU_16h5": ("ARUCO_MIP_16h3",),
    "TPU_36h12": ("TPU_36h12",),
    "MIP_25h7": ("_generate_mip_style", ("ARUCO_MIP_25h7", 5, 100, 7),
                 dict(seed=25)),
}
DICTS_PATH = os.path.join(DATA_DIR, "ref_dicts.npz")


def add_dicts_reference(out_path=DICTS_PATH):
    """Record ref_dicts.npz with the JAX package on the CPU: for each table
    of DICT_TABLES its packed codes (np.packbits of the [K, nbits] bits),
    grid and max_correction (`<table>_packed`, `_grid`, `_max_correction`);
    for each world of DICT_SCENES the uint8 frame (`<dict>_frame`) and the
    JAX detect_markers ids, corners and valid flags at the bench settings
    with subpixel refinement (`<dict>_ids`, `_corners`, `_valid`). TPU_16h5
    is recorded through get_dictionary("ARUCO_MIP_16h3"), the alias the
    16h3 world uses: the registry generates the same table for each name,
    so the recording runs the generator once."""
    import time

    import jax.numpy as jnp

    from orb_slam2_aruco_tpu.io import synthetic as jsyn
    from orb_slam2_aruco_tpu.ops.aruco import detector as jdet
    from orb_slam2_aruco_tpu.ops.aruco import dictionary as jdict

    t0 = time.perf_counter()
    out = {}
    for table, call in DICT_TABLES.items():
        t1 = time.perf_counter()
        if len(call) == 1:
            d = jdict.get_dictionary(call[0])
        else:
            d = getattr(jdict, call[0])(*call[1], **call[2])
        out[f"{table}_packed"] = np.packbits(d.codes, axis=1)
        out[f"{table}_grid"] = np.asarray(d.grid, np.int32)
        out[f"{table}_num_ids"] = np.asarray(d.num_ids, np.int32)
        out[f"{table}_max_correction"] = np.asarray(d.max_correction,
                                                    np.int32)
        print(f"{table}: {d.num_ids} codes of {d.nbits} bits, "
              f"max_correction {d.max_correction}, "
              f"{time.perf_counter() - t1:.0f} s", flush=True)
    jcfg, world_kw, _, _ = _full_setup()
    acfg = jcfg.aruco
    for dict_name, ids in DICT_SCENES.items():
        if max(ids) >= jdict.get_dictionary(dict_name).num_ids:
            raise ValueError(f"{dict_name}: ids {ids} beyond the table")
        (img,), _ = render_frames(jsyn, dict(world_kw, marker_ids=ids),
                                  jcfg.camera, [DICT_POSE], dict_name)
        det = jdet.detect_markers(
            jnp.asarray(img.astype(np.float32)), dict_name,
            max_quads=acfg.max_quad_candidates,
            adaptive_win=acfg.adaptive_thresh_win,
            adaptive_c=acfg.adaptive_thresh_c,
            min_area=acfg.min_quad_side_px**2, cell_px=acfg.warp_cell_px,
            cc_iters=acfg.cc_iters, downsample=acfg.detect_downsample,
            refine=True, use_pallas_cc=acfg.use_pallas_cc)
        valid = np.asarray(det.valid)
        found = sorted(int(i) for i in np.asarray(det.ids)[valid])
        # every marker of the world decodes; a 16-bit code at distance 5
        # may also be read off the texture, which the port must repeat
        if not set(ids) <= set(found):
            raise RuntimeError(f"{dict_name}: JAX decoded {found}, the "
                               f"world holds {sorted(ids)}")
        out[f"{dict_name}_frame"] = img
        out[f"{dict_name}_ids"] = np.asarray(det.ids, np.int32)
        out[f"{dict_name}_corners"] = np.asarray(det.corners, np.float32)
        out[f"{dict_name}_valid"] = valid
        print(f"{dict_name} world: JAX decoded {found}", flush=True)
    np.savez_compressed(out_path, **out)
    print(f"{out_path}: {os.path.getsize(out_path)} bytes, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)


# __graft_entry__.py's flagship step and its capacity-shaped global BA
GRAFT_PATH = os.path.join(DATA_DIR, "ref_graft.npz")
GRAFT_ITERS = 2
GRAFT_MESH = 8


@contextlib.contextmanager
def jax_exact_segment_sums():
    """JAX's ba_solve with each segment summed on its own
    (jax.ops.segment_sum over the plan's segment ids) instead of as the
    difference of a float32 running cumsum over all edges (optim/ba.py's
    _seg_reduce). At the capacity problem the running cumsum reaches
    ~1e18 (camera blocks of edges at the z = 0.02 cut), so the cumsum's
    differences lose whole segments: the solve as shipped rejects both of
    its LM steps on one device and moves the cameras by 1e5 m on 8. The
    port sums each segment apart (index_add_); this is the JAX arithmetic
    it is held to. Patches the module attribute for the block only."""
    import jax.numpy as jnp

    from orb_slam2_aruco_tpu.optim import ba as jba

    def exact(plan, vals, num_segments):
        E = vals.shape[0]
        seg = jnp.searchsorted(plan.right, jnp.arange(E), side="right")
        ids = jnp.zeros(E, jnp.int32).at[plan.perm].set(
            seg.astype(jnp.int32))
        return jax.ops.segment_sum(vals, ids, num_segments)

    shipped = jba._seg_reduce
    jba._seg_reduce = exact
    try:
        yield
    finally:
        jba._seg_reduce = shipped


def _ulp(x, direction):
    """x moved one float32 ulp toward +inf (direction 1) or -inf (-1)."""
    import jax.numpy as jnp

    return jnp.nextafter(x, jnp.inf if direction > 0 else -jnp.inf)


def add_graft_reference(out_path=GRAFT_PATH):
    """Record ref_graft.npz: JAX's __graft_entry__ on the CPU (the global
    BA on the GRAFT_MESH virtual devices of tests/conftest.py's XLA flag).

      entry_*   entry()'s step, jitted, on its own inputs: the frame's
                valid keypoints (mask, pixels, octaves, descriptors) and
                the step's Rcw, tcw and n_inliers;
      prob_*    make_gba_problem(256, 20000, 16): the index arrays'
                digest (graft_entry_torch.problem_digest) and the chi2
                before the solve;
      shipped_* ba_solve(iters=2) and the 8-device distributed_ba_solve
                as the package ships them (chi2, Rcw, tcw; the single
                solve's points, which it leaves where they were, as the
                largest move);
      exact_*   the same two solves under jax_exact_segment_sums (chi2,
                Rcw, tcw, points): what the port is held to;
      witness_* what one float32 ulp moves the exact single solve (its
                poses' rotations and translations, its points, its
                observations, each one ulp up and down): the
                largest chi2 spread, R and t moves, the smallest share
                of points within 5e-3; and what one ulp on the poses
                moves the chi2 before the solve.
    """
    import time

    import jax.numpy as jnp

    import __graft_entry__ as jg
    from chip_smoke import solve_errors
    from orb_slam2_aruco_tpu.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu.optim import ba as jba
    from orb_slam2_aruco_tpu.parallel import dist_ba as jdist
    from orb_slam2_aruco_tpu.pipeline.frontend import make_frame

    import graft_entry_torch as tg

    t0 = time.perf_counter()
    step, args = jg.entry()
    R, t, n_in = jax.jit(step)(*args)
    cfg = jg._flagship_config()
    frame = jax.jit(lambda im: make_frame(im, camera_from_config(cfg.camera),
                                          cfg))(args[0])
    valid = np.asarray(frame.kp_valid)
    out = dict(entry_valid=valid,
               entry_uv=np.asarray(frame.kp_uv)[valid],
               entry_octave=np.asarray(frame.kp_octave)[valid],
               entry_desc=np.asarray(frame.desc).view(np.int32)[valid],
               entry_R=np.asarray(R), entry_t=np.asarray(t),
               entry_n_inliers=np.asarray(n_in, np.int64))
    print(f"  entry: {int(valid.sum())} keypoints, n_inliers {int(n_in)}",
          flush=True)
    t1 = time.perf_counter()
    prob, cam = jg.make_gba_problem(K=tg.GBA_K, L=tg.GBA_L, M=tg.GBA_M)
    dig = tg.problem_digest(prob)
    chi0 = float(jba._total_chi2(prob, cam)[0])
    chi0_ulp = [float(jba._total_chi2(prob._replace(Rcw=_ulp(prob.Rcw, d)),
                                      cam)[0]) for d in (1, -1)]
    out.update(prob_fields=np.asarray(tg.INDEX_FIELDS),
               prob_sums=np.asarray([dig[f][0] for f in tg.INDEX_FIELDS],
                                    np.int64),
               prob_sha=np.asarray([dig[f][1] for f in tg.INDEX_FIELDS]),
               prob_chi2_0=np.asarray(chi0),
               witness_chi2_0=np.asarray(max(abs(c - chi0) / chi0
                                             for c in chi0_ulp)))
    mesh = jdist.make_mesh(GRAFT_MESH)
    if len(mesh.devices.ravel()) != GRAFT_MESH:
        raise RuntimeError(f"need {GRAFT_MESH} virtual CPU devices "
                           f"(tests/conftest.py's XLA flag)")

    def solves():
        single = jba.ba_solve(prob, cam, iters=GRAFT_ITERS)
        dist = jdist.distributed_ba_solve(prob, cam, mesh, iters=GRAFT_ITERS)
        return single, dist

    def fields(o):
        return (np.asarray(o.Rcw), np.asarray(o.tcw), np.asarray(o.points),
                np.asarray(o.chi2, np.float64))

    s_single, s_dist = solves()
    with jax_exact_segment_sums():
        e_single, e_dist = solves()
        nudged = [jba.ba_solve(prob._replace(**{f: _ulp(getattr(prob, f),
                                                         d)}),
                               cam, iters=GRAFT_ITERS)
                  for f in ("Rcw", "tcw", "points", "e_uv")
                  for d in (1, -1)]
    for pre, o in (("shipped_single_", s_single), ("shipped_dist8_", s_dist),
                   ("exact_single_", e_single), ("exact_dist8_", e_dist)):
        R_, t_, P_, c_ = fields(o)
        out.update({pre + "chi2": c_, pre + "R": R_, pre + "t": t_})
        if pre.startswith("exact_"):
            out[pre + "P"] = P_
        else:
            out[pre + "P_moved"] = np.asarray(np.abs(
                P_ - np.asarray(prob.points)).max())
    errs = [solve_errors(fields(o), fields(e_single)) for o in nudged]
    out.update(witness_chi2=np.asarray(max(e[0] for e in errs)),
               witness_R=np.asarray(max(e[1] for e in errs)),
               witness_t=np.asarray(max(e[2] for e in errs)),
               witness_pts_share=np.asarray(min(e[4] for e in errs)))
    for pre in ("shipped_single_", "shipped_dist8_", "exact_single_",
                "exact_dist8_"):
        print(f"  {pre[:-1]}: chi2 {chi0:.6g} -> "
              f"{float(out[pre + 'chi2']):.6g}", flush=True)
    print(f"  one ulp moves the exact solve's chi2 by up to "
          f"{float(out['witness_chi2']):.2%}, R / t by "
          f"{float(out['witness_R']):.2e} / {float(out['witness_t']):.2e}; "
          f"{float(out['witness_pts_share']):.4%} of its points stay "
          f"within 5e-3; the chi2 before by "
          f"{float(out['witness_chi2_0']):.2e}", flush=True)
    out["seconds"] = np.asarray([t1 - t0, time.perf_counter() - t1])
    np.savez_compressed(out_path, **out)
    print(f"{out_path}: {os.path.getsize(out_path)} bytes; entry "
          f"{t1 - t0:.0f} s, the global BA {time.perf_counter() - t1:.0f} s",
          flush=True)


if __name__ == "__main__":
    modes = ("--regen", "--serving", "--slam", "--loop", "--pipe", "--video",
             "--dicts", "--bench", "--graft")
    if not any(m in sys.argv for m in modes):
        sys.exit("usage: python tests/test_torch_slice.py "
                 "--regen|--serving|--slam|--loop|--pipe [small|full] "
                 "[--parts quad,tb,stream,dstream] | --video | --dicts | "
                 "--bench | --graft")
    sys.path.insert(0, REPO)
    if "--graft" in sys.argv:
        # the distributed solve's virtual devices (tests/conftest.py's flag;
        # read when the CPU backend starts, after this module's import)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   "--xla_force_host_platform_device_count"
                                   "=8").strip()
    picked = tuple(a for a in sys.argv[1:] if a in SETUPS) or ("small",
                                                               "full")
    if "--regen" in sys.argv:
        build_reference_data(picked)
        add_slam_reference(picked)
        add_loop_reference(picked)
        add_pipe_reference(picked)
        if "full" in picked:
            add_bench_reference()
    elif "--serving" in sys.argv:
        parts = SERVING_PARTS
        if "--parts" in sys.argv:
            parts = tuple(sys.argv[sys.argv.index("--parts") + 1].split(","))
        add_serving_reference(picked, parts=parts)
    elif "--slam" in sys.argv:
        add_slam_reference(picked)
    elif "--pipe" in sys.argv:
        add_pipe_reference(picked)
    elif "--video" in sys.argv:
        add_video_reference()
    elif "--dicts" in sys.argv:
        add_dicts_reference()
    elif "--bench" in sys.argv:
        add_bench_reference()
    elif "--graft" in sys.argv:
        add_graft_reference()
    else:
        add_loop_reference(picked)


# ---------------------------------------------------------------------------
# tests: the port's localization against the recorded JAX run
# ---------------------------------------------------------------------------

ROT_TOL_DEG = 0.2     # the slice's stated tolerance against the JAX poses
TRANS_TOL_M = 0.01


def _rot_err_deg(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, d / (2 * np.sqrt(2))))))


def _load_ref(name):
    path = os.path.join(DATA_DIR, f"ref_{name}.npz")
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    return path, ref


def _port_frames(ref):
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic

    cfg = SlamConfig.from_dict(json.loads(str(ref["ref_cfg"])))
    imgs, gt = render_frames(synthetic, json.loads(str(ref["ref_world"])),
                             cfg.camera, ref["ref_loc_params"],
                             cfg.aruco.dictionary)
    return cfg, imgs, gt


def test_port_localization_matches_recorded_jax_run():
    from orb_slam2_aruco_tpu_torch.io import trajectory
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    path, ref = _load_ref("small")
    cfg, imgs, gt = _port_frames(ref)
    np.testing.assert_allclose(np.stack([g[0] for g in gt]), ref["ref_gt_R"])
    system = SlamSystem(cfg, device="cpu")
    system.load_map(path)
    assert system.state is TrackingState.LOST
    for i, img in enumerate(imgs):
        p = system.track_monocular(img, ts=i / 30.0)
        ok = system.state is TrackingState.OK
        assert ok == bool(ref["ref_ok"][i]), i
        if ok:
            assert _rot_err_deg(p[0], ref["ref_R"][i]) < ROT_TOL_DEG, i
            assert np.linalg.norm(p[1] - ref["ref_t"][i]) < TRANS_TOL_M, i
    traj = system.get_trajectory()
    assert [r.frame_id for r in traj] == list(range(len(imgs)))
    assert system.stats["reloc"] == 1
    ok = ref["ref_ok"]
    est = trajectory.camera_centers([r.Rcw for r in traj if r.state is
                                     TrackingState.OK],
                                    [r.tcw for r in traj if r.state is
                                     TrackingState.OK])
    gt_c = trajectory.camera_centers(ref["ref_gt_R"][ok], ref["ref_gt_t"][ok])
    ate = trajectory.ate_rmse(est, gt_c, align=True, with_scale=False)
    ref_ate = float(ref["ref_ate"])
    assert ate <= max(1.5 * ref_ate, ref_ate + 0.005)


def test_jax_system_live_reproduces_the_recording():
    """The JAX SlamSystem, run now on the first 3 recorded frames, gives the
    recorded poses: the reference file and the JAX package agree."""
    from orb_slam2_aruco_tpu.io import synthetic as jsyn
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem, TrackingState

    path, ref = _load_ref("small")
    cfg, world, _, loc = SETUPS["small"]()
    assert json.loads(str(ref["ref_cfg"])) == json.loads(
        json.dumps(dataclasses.asdict(cfg)))
    np.testing.assert_allclose(ref["ref_loc_params"], np.asarray(loc))
    imgs, _ = render_frames(jsyn, world, cfg.camera, loc[:3],
                            cfg.aruco.dictionary)
    system = SlamSystem(cfg)
    system.load_map(path)
    for i, img in enumerate(imgs):
        p = system.track_monocular(img, ts=i / 30.0)
        assert (system.state is TrackingState.OK) == bool(ref["ref_ok"][i])
        assert _rot_err_deg(p[0], ref["ref_R"][i]) < 1e-3
        np.testing.assert_allclose(np.asarray(p[1]), ref["ref_t"][i],
                                   atol=1e-5)


def test_full_reference_file_is_a_complete_recording():
    """ref_full.npz (the card's reference) loads in the port and records a
    localization the port can be held to: every field, all 32 frames."""
    from orb_slam2_aruco_tpu_torch.io import checkpoint

    path, ref = _load_ref("full")
    state = checkpoint.load_map(path, device="cpu")
    cfg, imgs, _ = _port_frames(ref)
    assert state.kf_desc.shape == (cfg.map.max_keyframes,
                                   cfg.orb.num_features, 8)
    assert state.pt_xyz.shape == (cfg.map.max_points, 3)
    assert (cfg.camera.width, cfg.camera.height) == (960, 540)
    assert cfg.aruco.detect_downsample == 2
    assert len(imgs) == 32 and imgs[0].shape == (540, 960)
    assert ref["ref_ok"].all() and ref["ref_R"].shape == (32, 3, 3)
    assert 0.0 < float(ref["ref_ate"]) < 0.05
    assert os.path.getsize(path) + os.path.getsize(
        os.path.join(DATA_DIR, "ref_small.npz")) < 4 * 2**20


def _digest(path, skip):
    """(key count, sha256 over (name, dtype, shape, bytes)) of the keys of
    the npz at `path` that start with none of the prefixes `skip`."""
    import hashlib

    h = hashlib.sha256()
    with np.load(path) as z:
        keys = sorted(k for k in z.files if not k.startswith(skip))
        for k in keys:
            a = z[k]
            for part in (k.encode(), str(a.dtype).encode(),
                         str(a.shape).encode(), a.tobytes()):
                h.update(part)
    return len(keys), h.hexdigest()


# the keys the full-width recordings added later (ref_full's track_batch
# chunk and default serving form, and bench.py's workload): the digests
# below leave them out (tests/test_torch_serve.py holds every older key)
LATER_SERVING_KEYS = {"small": (), "full": ("ref_tb_", "ref_dstream_",
                                            "ref_bench_")}

# sha256 over (name, dtype, shape, bytes) of every key a file held before
# the loop recording (ref_loop_*) was added: --loop must leave them equal
# (the pipelined recording, ref_pipe_*, came later)
PRE_LOOP_DIGESTS = {
    "small": (269, "c77007293266d991db1b87592e69fb69"
                   "e536419b4d07a40f3ba59ef498acc4fe"),
    "full": (83, "e41c4d47296cb4cfa2136be48cf28023"
                 "3b6763a9dfea5aa3ce534f02313dd9d8"),
}


@pytest.mark.parametrize("name", ["small", "full"])
def test_loop_recording_keeps_the_other_keys_byte_equal(name):
    """`--loop` adds the ref_loop_* keys and leaves every other key of the
    file byte-equal; the recording holds a loop closed by marker and the
    BoW-PnP relocalization of a marker-free frame, and in ref_small the
    start-area frame's relocalization by marker (JAX's full-width run
    loses that frame after its loop: ROADMAP C2)."""
    path = os.path.join(DATA_DIR, f"ref_{name}.npz")
    with np.load(path) as z:
        loops = z["ref_loop_loops"]
        reloc = z["ref_loop_reloc_marker"]
    assert (_digest(path, ("ref_loop_", "ref_pipe_")
                    + LATER_SERVING_KEYS[name]) == PRE_LOOP_DIGESTS[name])
    assert len(loops) >= 1 and loops[0, 3] == 1
    kinds = {"small": [0, 1], "full": [0]}[name]
    assert reloc[reloc >= 0].tolist() == kinds


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_matches_jax(with_scale):
    """The port's ATE (float64 Umeyama) against the JAX package's (float32
    Horn alignment) on one noisy trajectory: equal within the float32
    alignment's rounding, far below the 5 mm the card's ATE check allows."""
    from orb_slam2_aruco_tpu.io import trajectory as jtraj
    from orb_slam2_aruco_tpu_torch.io import trajectory

    rng = np.random.default_rng(8)
    gt = np.cumsum(rng.normal(0.0, 0.05, (40, 3)), axis=0)
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                  [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
    est = 1.1 * gt @ R.T + np.array([0.2, -0.1, 0.5])
    est = est + rng.normal(0.0, 0.01, est.shape)
    got = trajectory.ate_rmse(est, gt, align=True, with_scale=with_scale)
    want = jtraj.ate_rmse(est, gt, align=True, with_scale=with_scale)
    assert abs(got - want) < 1e-5
    assert got > 0.005


# the same for every key before the pipelined recording (ref_pipe_*)
PRE_PIPE_DIGESTS = {
    "small": (409, "047e32b9782246ac5d765b4ddd8538f7"
                   "c638672333fd39000ad700c76d0e7449"),
    "full": (108, "d8467fd75b932ae1c8f507dc66b1998d"
                  "9c6129837890707fd1e9477432963d68"),
}


@pytest.mark.parametrize("name", ["small", "full"])
def test_pipe_recording_keeps_the_other_keys_byte_equal(name):
    """`--pipe` adds the ref_pipe_* keys and leaves every other key of the
    file byte-equal (tests/test_torch_pipe.py holds the recordings)."""
    path = os.path.join(DATA_DIR, f"ref_{name}.npz")
    assert (_digest(path, ("ref_pipe_",) + LATER_SERVING_KEYS[name])
            == PRE_PIPE_DIGESTS[name])
    with np.load(path) as z:
        cfg = json.loads(str(z["ref_pipe_cfg"]))
    assert cfg["tracking"]["pipeline_depth"] == PIPE_DEPTH[name]


def test_pipelined_slam_mode_tracks_defers_and_localization_ignores_it():
    """SLAM mode at tracking.pipeline_depth 4 on the CPU: once initialized,
    track_monocular returns device tensors and keeps the frames in flight
    (`_pending`) with their control vectors unread; flush() reads them all
    and gives one record per frame. Localization against a loaded map
    ignores the depth: it tracks frame by frame."""
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    assert SlamConfig().tracking.pipeline_depth == 0
    path, ref = _load_ref("small")
    cfg = pipe_cfg(SlamConfig.from_dict(json.loads(str(ref["ref_cfg"]))), 4)
    imgs, _ = pipe_scene("small", cfg, synthetic)
    system = SlamSystem(cfg, device="cpu")
    n = 8
    for j, img in enumerate(imgs[:n]):
        pose = system.track_monocular(img, ts=j / 30.0)
    assert system.state is TrackingState.OK
    assert isinstance(pose[0], torch.Tensor)
    assert 1 <= len(system._pending) <= 4
    assert len(system.trajectory) == n - len(system._pending)
    system.flush()
    assert not system._pending and not system._map_phase
    assert [r.frame_id for r in system.get_trajectory()] == list(range(n))

    system.load_map(path)
    loc, _ = _port_frames(ref)[1:]
    for i, img in enumerate(loc[:3]):
        p = system.track_monocular(img, ts=100.0 + i / 30.0)
        assert not system._pending
        assert (p is not None) == bool(ref["ref_ok"][i])
        if p is not None:
            assert isinstance(p[0], np.ndarray)


def test_entry_points_default_to_the_card(monkeypatch):
    """SlamSystem, checkpoint.load_map and StagedSource run on the card
    unless told otherwise, and raise (no CPU fallback) without one."""
    import inspect

    import orb_slam2_aruco_tpu_torch as pkg
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.io import checkpoint
    from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    for fn in (SlamSystem.__init__, checkpoint.load_map,
               StagedSource.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(pkg._torch.cuda, "is_available", lambda: False)
    path, _ = _load_ref("small")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SlamSystem(SlamConfig())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        checkpoint.load_map(path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        StagedSource([])
    assert SlamSystem(SlamConfig(), device="cpu").device.type == "cpu"
