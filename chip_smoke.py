#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives orb_slam2_aruco_tpu_torch's main path — localization against a saved
map — at the bench configuration (960x540, 1000 ORB features, 8 levels,
detect_downsample=2, 256-keyframe / 20000-point map capacity), in phases:

  1. device   CUDA must be available (no CPU fallback); prints the card's
              name and power limit as nvidia-smi reports them.
  2. build    compiles the three CUDA kernels from kernels/csrc (one nvcc
              per source, all at once).
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the main path gives it on a rendered 960x540 frame:
              K1 FAST on the 8 pyramid levels, K2 patches at each level's
              keypoint quota, K3 connected components on the 270x480
              half-resolution binary. Outputs must be equal (K1: in the
              unmasked interior). Median times from CUDA events.
  4. slice    SlamSystem.load_map(data/ref_full.npz) + track_monocular on
              the 32 recorded frames (rendered here by the port's
              io/synthetic). States must equal the JAX package's, poses
              within 0.2 deg / 1 cm of its poses, and the ATE at most
              max(1.5 x, +5 mm) of its ATE. Every kernel must have launched
              during this run (launch counts are zeroed just before it).
  5. report   one {"kernels": [...]} JSON line, the nvidia-smi line, and as
              the last line {"ok": true, "device": {...}}.

Any failed phase exits non-zero before the last line is printed.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "orb_slam2_aruco_tpu_torch"
DEVICE = "cuda"

# tolerance of the slice against the JAX package's recorded localization
ROT_TOL_DEG = 0.2
TRANS_TOL_M = 0.01

KERNEL_META = {
    "fast": ("orb_slam2_aruco_tpu_torch/kernels/csrc/fast.cu",
             "orb_slam2_aruco_tpu/ops/pallas_fast.py:119"),
    "patches": ("orb_slam2_aruco_tpu_torch/kernels/csrc/patches.cu",
                "orb_slam2_aruco_tpu/ops/pallas_patches.py:61"),
    "cc_fused": ("orb_slam2_aruco_tpu_torch/kernels/csrc/cc_fused.cu",
                 "orb_slam2_aruco_tpu/ops/pallas_cc_fused.py:185"),
}


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
    w = json.loads(str(ref["ref_world"]))
    world = synthetic.build_world(
        w["marker_ids"], dict_name=cfg.aruco.dictionary,
        marker_size=w["marker_size"], grid_cols=w["grid_cols"],
        spacing=w["spacing"], px_per_m=w["px_per_m"])
    imgs = []
    for x, y, d, yaw, pitch in ref["ref_loc_params"]:
        R, t = synthetic.look_at_plane_pose((x, y), d, yaw=yaw, pitch=pitch)
        imgs.append(np.clip(synthetic.render_view(world, cfg.camera, R, t),
                            0, 255).astype(np.uint8))
    return path, cfg, ref, imgs


def kernel_phase(cfg, img_np):
    """Each kernel against its plain version at the main path's shapes.
    Returns {name: (max_abs_err, ms, plain_ms)}; ms are per frame (K1 and
    K2 summed over the 8 pyramid levels)."""
    import torch

    from orb_slam2_aruco_tpu_torch.ops import cc_fused, fast, image, orb
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import level_quotas

    ocfg = cfg.orb
    gray = torch.as_tensor(img_np).cuda().float()
    levels = image.build_pyramid(gray, ocfg.num_levels, ocfg.scale_factor)
    out = {}

    # K1: FAST score + NMS on the 8 levels
    err = 0.0
    for lvl in levels:
        a = fast.fast_score_nms_cuda(lvl, ocfg.fast_threshold,
                                     ocfg.fast_min_threshold)
        b = fast.fast_score_nms_torch(lvl, ocfg.fast_threshold,
                                      ocfg.fast_min_threshold)
        torch.cuda.synchronize()
        inner = (slice(3, -3), slice(3, -3))
        if not torch.equal(a[inner], b[inner]):
            n = int((a[inner] != b[inner]).sum())
            raise PhaseError(f"K1 fast differs from its plain version at "
                             f"{n} interior pixels of a {tuple(lvl.shape)} "
                             f"level")
        err = max(err, float((a - b).abs().max()))
    t_args = (ocfg.fast_threshold, ocfg.fast_min_threshold)
    ms = cuda_ms(lambda: [fast.fast_score_nms_cuda(l, *t_args)
                          for l in levels])
    plain = cuda_ms(lambda: [fast.fast_score_nms_torch(l, *t_args)
                             for l in levels])
    out["fast"] = (err, ms, plain)
    phase("kernels", f"K1 fast: equal to plain on {len(levels)} levels "
          f"{[tuple(l.shape) for l in levels]}; {ms:.4f} ms vs plain "
          f"{plain:.4f} ms per frame")

    # K2: patches at each level's keypoint quota
    quotas = level_quotas(ocfg.num_features, ocfg.num_levels,
                          ocfg.scale_factor)
    jobs = []
    for lvl, q in zip(levels, quotas):
        kp = fast.detect_level(lvl, ocfg.fast_threshold,
                               ocfg.fast_min_threshold,
                               cell_size=ocfg.cell_size, per_cell_k=8,
                               max_kps=q, edge_margin=ocfg.patch_radius + 1)
        blurred = image.gaussian_blur(lvl, ocfg.blur_ksize, ocfg.blur_sigma)
        y0, x0 = orb.patch_corners(blurred.shape, kp.xy)
        jobs.append((blurred, y0, x0))
    for blurred, y0, x0 in jobs:
        a = orb.extract_patches_cuda(blurred, y0, x0)
        b = orb.extract_patches_torch(blurred, y0, x0)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise PhaseError("K2 patches differ from their plain version")
    ms = cuda_ms(lambda: [orb.extract_patches_cuda(*j) for j in jobs])
    plain = cuda_ms(lambda: [orb.extract_patches_torch(*j) for j in jobs])
    out["patches"] = (0.0, ms, plain)
    phase("kernels", f"K2 patches: equal to plain for quotas {quotas}; "
          f"{ms:.4f} ms vs plain {plain:.4f} ms per frame")

    # K3: CC + bbox on the half-resolution binary of the frame
    acfg = cfg.aruco
    binary = detector.adaptive_threshold(gray, acfg.adaptive_thresh_win,
                                         acfg.adaptive_thresh_c)
    binary = detector.downsample_majority(binary, acfg.detect_downsample)
    a = cc_fused.cc_fused_cuda(binary)
    b = cc_fused.cc_fused_torch(binary)
    torch.cuda.synchronize()
    if a[3] != b[3] or not all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])):
        raise PhaseError("K3 cc_fused differs from its plain version")
    ms = cuda_ms(lambda: cc_fused.cc_fused_cuda(binary))
    plain = cuda_ms(lambda: cc_fused.cc_fused_torch(binary))
    out["cc_fused"] = (0.0, ms, plain)
    phase("kernels", f"K3 cc_fused: lab/bw/bh/Wp equal to plain on "
          f"{tuple(binary.shape)} ({int(binary.sum())} foreground px); "
          f"{ms:.4f} ms vs plain {plain:.4f} ms per frame")
    return out


def rot_err_deg(Ra, Rb):
    import numpy as np

    # chordal distance |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2)
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, d / (2.0 * np.sqrt(2.0))))))


def slice_phase(path, cfg, ref, imgs):
    """The main path: load the map, localize the 32 frames. Returns the
    kernel launch counts of this run."""
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
    kernels.reset_launch_counts()
    tracking.SYNCS["count"] = 0
    torch.cuda.synchronize()
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
    phase("slice", f"kernel launches in the main path: {counts}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise PhaseError(f"kernels never launched by the main path: "
                         f"{missing}")

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
    for i, img in enumerate(imgs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = make_frame(torch.as_tensor(img).to(DEVICE), split.cam, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        split._step_frame(frame, i, i / 30.0)
        torch.cuda.synchronize()
        fe.append(t1 - t0)
        tr.append(time.perf_counter() - t1)
    phase("slice", f"split over frames 2-{len(imgs) - 1}: frontend "
          f"(make_frame) median {statistics.median(fe[2:]) * 1000:.2f} ms, "
          f"tracking median {statistics.median(tr[2:]) * 1000:.2f} ms per "
          f"frame")
    return counts


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"FAIL: {PKG}/ not found beside chip_smoke.py", flush=True)
        return 1
    sys.path.insert(0, HERE)
    try:
        import torch

        smi = device_phase()
        build_phase()
        path, cfg, ref, imgs = load_reference()
        kres = kernel_phase(cfg, imgs[0])
        counts = slice_phase(path, cfg, ref, imgs)
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1], "launches": counts[name],
         "max_abs_err": kres[name][0], "ms": kres[name][1],
         "plain_ms": kres[name][2], "held_against_plain": "ok"}
        for name in KERNEL_META
    ]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
