"""What the port's profilers share (tools/torch_profile_mapping.py,
tools/torch_prof_stream_host.py, tools/torch_profile_chunk.py,
tools/torch_scaling_bench.py): the command line (--device, --small), the
card's line, the timer and the two scenes.

    --device cuda   (the default) needs a CUDA GPU and raises without one;
                    the kernels are built from the package's kernels/csrc
    --device cpu    runs the same code on the CPU (times are the CPU's)
    --small         ref_small's configuration (320x240, 300 features, 16
                    keyframes) and its 12 map frames and map, instead of
                    bench.py's (960x540, data/ref_full.npz's map)
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


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    return ap


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


def event_ms(fn, device, reps):
    """The least milliseconds of fn() over `reps` runs after one warm-up
    run: between CUDA events around the call on the card (they bracket
    the device work and the host gaps the call leaves), on the host's
    clock around the call on the CPU."""
    import torch

    fn()
    sync(device)
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def null_ms(imgs, device, reps):
    """event_ms of a null launch (one reduction over the chunk)."""
    return event_ms(lambda: imgs.float().sum(), device, reps)


def scene(device, small: bool):
    """(cfg, uint8 frames, path of the map file): bench.py's configuration,
    its 32-frame sweep (bench_torch.bench_scene) and data/ref_full.npz (the
    JAX package's depth-4 SLAM pass over that sweep: the bench map); with
    small, ref_small's configuration, its 12 map frames and
    data/ref_small.npz."""
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


def warm_system(cfg, frames, path, device):
    """A SlamSystem on `device` holding the map at `path`, in localization
    mode, after one OK track_monocular of frames[0]."""
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    system = SlamSystem(cfg, device=device)
    system.load_map(path)
    system.activate_localization_mode()
    if system.track_monocular(frames[0], ts=0.0) is None:
        raise RuntimeError("the first frame did not localize against the map")
    return system


def report(rows, extra, width=34):
    """Print one 'name: ms' line per row, then the JSON object last."""
    for name, ms in rows.items():
        print(f"{name:{width}s}: {ms:9.3f} ms", flush=True)
    print(json.dumps(extra), flush=True)
    return extra
