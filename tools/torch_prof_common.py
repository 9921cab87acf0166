"""What the port's profilers (tools/torch_*.py) share: the command line
(--device, --small, --map), the card's line, the timers, the scenes, the
frontend's stages and the track_batch call.

    --device cuda   (the default) needs a CUDA GPU and raises without one;
                    the kernels are built from the package's kernels/csrc
    --device cpu    runs the same code on the CPU (times are the CPU's)
    --small         ref_small's configuration (320x240, 300 features, 16
                    keyframes) and its 12 map frames and map, instead of
                    bench.py's (960x540, data/ref_full.npz's map); and
                    2 frames and one rep where --b and --reps are not given
    --b B, --reps R (the tools that time a loop over frames) B frames and
                    R timed runs instead of the tool's defaults
    --map BASE      (the tools that track against a map) BASE.npz and the
                    frames in BASE_frames.npz, as
                    tools/torch_build_bench_map.py writes them, instead of
                    the data file's map and frames
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
DATA = os.path.join(HERE, "orb_slam2_aruco_tpu_torch", "data")


def parser(doc: str, map_arg: bool = False,
           counts: bool = False) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    if map_arg:
        ap.add_argument("--map", default=None,
                        help="BASE of BASE.npz and BASE_frames.npz")
    if counts:
        ap.add_argument("--b", type=int, default=None, help="frames")
        ap.add_argument("--reps", type=int, default=None, help="timed runs")
    return ap


def counts(args, b: int, reps: int):
    """(frames, reps): --b and --reps where given, else (2, 1) with --small
    and the tool's (b, reps) without."""
    return (args.b or (2 if args.small else b),
            args.reps or (1 if args.small else reps))


def start(device):
    """The device (raises without a GPU unless it is the CPU), its kernels
    built; prints the card's name and power limit as nvidia-smi gives them
    ("cpu" on the CPU) and returns that line."""
    import bench_torch
    from orb_slam2_aruco_tpu_torch import require_device

    dev = require_device(device)
    if dev.type == "cuda":
        from orb_slam2_aruco_tpu_torch.kernels import build

        build.build_all()
    name, limit = bench_torch.card(dev)
    line = name if limit is None else f"{name}, {limit}"
    print(line, flush=True)
    return dev, line


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_wall_ms(fn, device, reps, agg=min):
    """(event ms, wall ms) of fn() over `reps` runs after one warm-up run,
    each aggregated by `agg` (the least by default): between CUDA events
    around the call on the card (they bracket the device work and the host
    gaps the call leaves), and on the host's clock around the call and the
    wait for its last event (on the CPU both are the host's clock)."""
    import torch

    fn()
    sync(device)
    events, walls = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            t1 = time.perf_counter()
            events.append(a.elapsed_time(b))
        else:
            fn()
            t1 = time.perf_counter()
            events.append((t1 - t0) * 1e3)
        walls.append((t1 - t0) * 1e3)
    return agg(events), agg(walls)


def event_ms(fn, device, reps):
    """The least milliseconds of fn() between CUDA events (event_wall_ms)."""
    return event_wall_ms(fn, device, reps)[0]


def null_call(imgs):
    """A null launch: one reduction over the chunk."""
    return lambda: imgs.float().sum()


def null_ms(imgs, device, reps):
    """event_ms of the null launch."""
    return event_ms(null_call(imgs), device, reps)


def measure(calls, device, reps, null=(0.0, 0.0), per=1, agg=min):
    """{name: (event ms, wall ms)} of each zero-argument call (event_wall_ms)
    less the null launch's pair, divided by `per` (the frames of a chunk)."""
    rows = {}
    for name, fn in calls.items():
        ev, wall = event_wall_ms(fn, device, reps, agg)
        rows[name] = ((ev - null[0]) / per, (wall - null[1]) / per)
    return rows


def columns(rows):
    """({name: event ms}, {name: wall ms}) of measure's rows."""
    return ({k: v[0] for k, v in rows.items()},
            {k: v[1] for k, v in rows.items()})


def scene(device, small: bool, map_base=None):
    """(cfg, uint8 frames, path of the map file): bench.py's configuration,
    its 32-frame sweep (bench_torch.bench_scene) and data/ref_full.npz (the
    JAX package's depth-4 SLAM pass over that sweep: the bench map); with
    small, ref_small's configuration, its 12 map frames and
    data/ref_small.npz; with map_base, the configuration, then
    map_base.npz and the frames of map_base_frames.npz."""
    if map_base is not None:
        import numpy as np

        cfg = scene(device, small)[0]
        with np.load(map_base + "_frames.npz") as z:
            frames = list(z["frames"])
        return cfg, frames, map_base + ".npz"
    if not small:
        import bench_torch

        cfg, frames = bench_torch.bench_scene(device)
        return cfg, frames, os.path.join(DATA, "ref_full.npz")
    import numpy as np

    from orb_slam2_aruco_tpu_torch import require_device
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic

    require_device(device)
    path = os.path.join(DATA, "ref_small.npz")
    with np.load(path) as z:
        cfg = SlamConfig.from_dict(json.loads(str(z["ref_cfg"])))
        w = json.loads(str(z["ref_world"]))
        params = z["ref_map_params"]
    world = synthetic.build_world(
        w["marker_ids"], dict_name=cfg.aruco.dictionary,
        marker_size=w["marker_size"], grid_cols=w["grid_cols"],
        spacing=w["spacing"], px_per_m=w["px_per_m"])
    frames = []
    for x, y, d, yaw, pitch in params:
        R, t = synthetic.look_at_plane_pose((x, y), d, yaw=yaw, pitch=pitch)
        frames.append(np.clip(synthetic.render_view(world, cfg.camera, R, t),
                              0, 255).astype(np.uint8))
    return cfg, frames, path


def primed_system(cfg, frames, path, device):
    """(system, pose): a SlamSystem on `device` holding the map at `path`,
    in localization mode, and what its track_monocular of frames[0]
    returned (None where the frame did not localize)."""
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    system = SlamSystem(cfg, device=device)
    system.load_map(path)
    system.activate_localization_mode()
    return system, system.track_monocular(frames[0], ts=0.0)


def warm_system(cfg, frames, path, device):
    """primed_system's system after an OK first frame; raises otherwise."""
    system, pose = primed_system(cfg, frames, path, device)
    if pose is None:
        raise RuntimeError("the first frame did not localize against the map")
    return system


def chunk(frames, n, device):
    """[n, H, W] uint8 frames on `device`: frame k is frames[k % len]."""
    import numpy as np
    import torch

    return torch.as_tensor(np.stack([frames[k % len(frames)]
                                     for k in range(n)])).to(device)


def pan_frames(cfg, n_markers, n):
    """The uint8 frames tools/prof_stages.py and tools/profile_detect.py
    render: the bench world's layout holding its first n_markers markers,
    seen from 2 m while the camera pans 5 cm a frame (frame i at
    x = 0.5 + 0.05 i)."""
    import numpy as np

    import bench_torch
    from orb_slam2_aruco_tpu_torch.io import synthetic

    world = synthetic.build_world(bench_torch.MARKER_IDS[:n_markers],
                                  px_per_m=500.0, spacing=0.6, grid_cols=4,
                                  marker_size=0.165)
    frames = []
    for i in range(n):
        R, t = synthetic.look_at_plane_pose((0.5 + 0.05 * i, 0.3), 2.0,
                                            yaw=0.05, pitch=0.04)
        frames.append(np.clip(synthetic.render_view(world, cfg.camera, R, t),
                              0, 255).astype(np.uint8))
    return frames


# make_frame's ORB steps in its own order (FAST before the blur)
ORB_STAGES = ("pyramid", "fast", "blur", "patches", "angles", "describe")


def orb_upto(img, cfg, upto, order=ORB_STAGES):
    """make_frame's ORB part of one frame img [H, W], run as make_frame
    runs it (K1 once over every level, K2 once), through the steps of
    `order` up to and including `upto`. Returns {step: its outputs}: the
    levels, their Keypoints, blurred levels, patches, angles and packed
    descriptors, per level."""
    import torch

    from orb_slam2_aruco_tpu_torch.ops import fast, image, orb
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import level_quotas

    o = cfg.orb
    quotas = level_quotas(o.num_features, o.num_levels, o.scale_factor)
    have = {}

    def keypoints():
        levels = have["pyramid"]
        scores = fast.fast_score_nms_levels(levels, o.fast_threshold,
                                            o.fast_min_threshold)
        return [fast.detect_level(
            lvl, o.fast_threshold, o.fast_min_threshold,
            cell_size=o.cell_size, per_cell_k=8, max_kps=q,
            edge_margin=o.patch_radius + 1, score=s)
            for lvl, s, q in zip(levels, scores, quotas)]

    steps = {
        "pyramid": lambda: image.build_pyramid(
            img.to(torch.float32), o.num_levels, o.scale_factor),
        "fast": keypoints,
        "blur": lambda: [image.gaussian_blur(lvl, o.blur_ksize, o.blur_sigma)
                         for lvl in have["pyramid"]],
        "patches": lambda: orb.extract_patches_levels(
            have["blur"], [kp.xy for kp in have["fast"]]).split(quotas),
        "angles": lambda: [orb.angles_from_patches(p)
                           for p in have["patches"]],
        "describe": lambda: [orb.describe_patches(p, a) for p, a in zip(
            have["patches"], have["angles"])],
    }
    for name in order[:order.index(upto) + 1]:
        have[name] = steps[name]()
    return have


def detect(gray, a, refine):
    """ops/aruco/detector.detect_markers on a float32 frame as make_frame
    calls it with the ArUco configuration `a`, refining or not."""
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector

    return detector.detect_markers(
        gray, a.dictionary, max_quads=a.max_quad_candidates,
        adaptive_win=a.adaptive_thresh_win, adaptive_c=a.adaptive_thresh_c,
        min_area=a.min_quad_side_px**2, cell_px=a.warp_cell_px,
        cc_iters=a.cc_iters, downsample=a.detect_downsample, refine=refine,
        use_pallas_cc=a.use_pallas_cc)


# the detector's steps as tools/profile_detect.py cuts them
DETECT_STAGES = ("thresh", "quads", "decode", "refine")


def detect_upto(gray, a, upto, fused=True):
    """The detector's steps on a float32 frame up to and including `upto`
    of DETECT_STAGES, as detect_markers runs them: the adaptive threshold,
    the quad proposal on its majority downsample by a.detect_downsample
    (quad_candidates_fused, K3, when fused, else the plain-CC
    quad_candidates) with the quads within 3 px of the border dropped,
    decode_quads, then refine_corners_lines of every quad (detect_markers
    refines the first 16 and drops repeated ids). Returns the last step's
    output."""
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector

    ds = a.detect_downsample
    binary = detector.adaptive_threshold(gray, a.adaptive_thresh_win,
                                         a.adaptive_thresh_c)
    if upto == "thresh":
        return binary
    if ds > 1:
        binary = detector.downsample_majority(binary, ds)
    min_area = a.min_quad_side_px**2 / (ds * ds)
    if fused:
        quads, _, qvalid = detector.quad_candidates_fused(
            binary, a.max_quad_candidates, min_area=min_area)
    else:
        quads, _, qvalid = detector.quad_candidates(
            binary, a.max_quad_candidates, min_area=min_area,
            cc_iters=a.cc_iters)
    quads = quads * float(ds) + (ds - 1) / 2.0
    h, w = gray.shape
    margin = 3.0
    qvalid = qvalid & ((quads[..., 0] >= margin)
                       & (quads[..., 0] <= w - 1 - margin)
                       & (quads[..., 1] >= margin)
                       & (quads[..., 1] <= h - 1 - margin)).all(dim=-1)
    if upto == "quads":
        return quads, qvalid
    det = detector.decode_quads(gray, quads, qvalid, a.dictionary,
                                cell_px=a.warp_cell_px)
    if upto == "decode":
        return det
    return detector.refine_corners_lines(gray, det.corners)


def track_batch_call(state, imgs, R, t, last, obs, ref_kf, cam, cfg):
    """A zero-argument call of tracking.track_batch on the chunk imgs from
    pose (R, t) with no velocity, `last` the last frame and `obs` its
    observed points (tools/prof_track_batch.py:64-76,
    tools/prof_tpu_all.py:187-200)."""
    import torch

    from orb_slam2_aruco_tpu_torch.pipeline import tracking

    dev = imgs.device
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    no_vel = torch.zeros((), dtype=torch.bool, device=dev)
    ref = torch.as_tensor(ref_kf, device=dev)
    return lambda: tracking.track_batch(
        state, imgs, R, t, eye, zero, no_vel, last.kp_uv, last.desc, obs,
        last.kp_valid, last.kp_octave, last.kp_angle, ref, cam, cfg)


def report_chunk(rows, b, extra, width=30):
    """report() of measure's rows over a chunk of b frames, each row's ms
    per frame printed first; the JSON holds the chunk size and ms per
    chunk, wall ms per chunk and ms per frame."""
    ms, wall = columns(rows)
    per_frame = {k: v / b for k, v in ms.items()}
    for k, v in per_frame.items():
        print(f"{k:{width}s}: {v:9.3f} ms/frame", flush=True)
    return report(rows, {**extra, "b": b, "ms_per_chunk": ms,
                         "wall_ms_per_chunk": wall,
                         "ms_per_frame": per_frame})


def json_numbers(x):
    """Every number in a JSON value."""
    if isinstance(x, dict):
        return [n for v in x.values() for n in json_numbers(v)]
    if isinstance(x, list):
        return [n for v in x for n in json_numbers(v)]
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return [x]
    return []


def report(rows, extra, width=34):
    """Print one 'name: ms' line per row (a measure row: 'name: ms (wall
    ms)'), then the JSON object last."""
    for name, ms in rows.items():
        if isinstance(ms, tuple):
            print(f"{name:{width}s}: {ms[0]:9.3f} ms  (wall {ms[1]:9.3f} ms)",
                  flush=True)
        else:
            print(f"{name:{width}s}: {ms:9.3f} ms", flush=True)
    print(json.dumps(extra), flush=True)
    return extra
