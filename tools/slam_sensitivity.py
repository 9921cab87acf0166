#!/usr/bin/env python3
"""How far SLAM mode's free-running result moves when its input moves by
one float32 ulp, in the JAX package itself, beside the port's distance
from the JAX run, on the small reference configuration (CPU).

    JAX_PLATFORMS=cpu python3 tools/slam_sensitivity.py [--scenes recorded,shifted]

For each scene it runs the JAX SlamSystem at pipeline_depth 0 over the 12
map frames of tests/test_torch_slice.py's small setup:

  * `jax`: the reference run;
  * `jax again`: the same run a second time (is JAX deterministic?);
  * `jax +1ulp`: every frame's keypoint coordinates (`Frame.kp_uv`, float32)
    moved up by one ulp before the frame is stepped;
  * `port`: the port's SlamSystem on the CPU over the same frames.

and prints, for each run against `jax`: the worst pose difference, the
first frame whose pose is more than 0.5 deg / 2 cm off, whether every
state is equal, the keyframe-insert frames, the valid point count and the
ATE. Then, step by step from the recorded JAX states (ref_slam_step_*, as
tests/test_torch_slam_slice.py steps the port), each step's pose
difference from the recorded pose: JAX on the recorded frame (0 if the
state loads whole), JAX on the frame moved by one ulp, and the port.
Last, for one step (--witness-frame, default 10, the one where the port
is furthest from JAX), the tracking cascade in its two halves: the port's
seed pose against JAX's, JAX's own refinement started from the port's
seed, and how far JAX's seed moves when the keypoints move by 1-8 ulp. Scene `recorded` is the recording's trajectory (ref_small.npz);
`shifted` is the same sweep half a frame later (SMALL_SHIFTED_PARAMS,
ref_slam_shift_*). About 4 min
on 6 CPU threads.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROT_DEG, TRANS_M = 0.5, 0.02


def _scene(name):
    import test_torch_slice

    cfg, world, map_params, _ = test_torch_slice.SETUPS["small"]()
    if name == "shifted":
        map_params = test_torch_slice.SMALL_SHIFTED_PARAMS
    return test_torch_slice.slam_cfg(cfg), world, map_params


def _run(system, make_frame, as_input, imgs, nudge=None):
    """Step every frame at depth 0: (states, poses, insert frames, points)."""
    states, poses, inserts = [], [], []
    for i, img in enumerate(imgs):
        frame = make_frame(as_input(img), system.cam, system.cfg)
        if nudge is not None:
            frame = nudge(frame)
        before = system.stats["kf_inserted"]
        fid = system.frame_id
        system.frame_id += 1
        p = system._step_frame(frame, fid, i / 30.0)
        states.append(system.state.value)
        poses.append(None if p is None else
                     (np.asarray(p[0], np.float64), np.asarray(p[1],
                                                               np.float64)))
        if system.stats["kf_inserted"] > before:
            inserts.append(i)
    return states, poses, inserts, int(np.asarray(system.map.pt_valid).sum())


def _ate(states, poses, gt):
    from orb_slam2_aruco_tpu_torch.io import trajectory

    idx = [i for i, p in enumerate(poses) if p is not None and states[i] == 2]
    est = trajectory.camera_centers([poses[i][0] for i in idx],
                                    [poses[i][1] for i in idx])
    ref = trajectory.camera_centers([gt[i][0] for i in idx],
                                    [gt[i][1] for i in idx])
    return trajectory.ate_rmse(est, ref, align=True, with_scale=False)


def _compare(run, ref):
    from test_torch_slice import _rot_err_deg

    worst_r = worst_t = 0.0
    first = None
    for i, (p, q) in enumerate(zip(run[1], ref[1])):
        if p is None or q is None:
            continue
        r = _rot_err_deg(p[0], q[0])
        t = float(np.linalg.norm(p[1] - q[1]))
        worst_r, worst_t = max(worst_r, r), max(worst_t, t)
        if first is None and (r > ROT_DEG or t > TRANS_M):
            first = i
    return worst_r, worst_t, first


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="recorded,shifted")
    ap.add_argument("--witness-frame", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from orb_slam2_aruco_tpu.io import synthetic as jsyn
    from orb_slam2_aruco_tpu.pipeline import frontend as jfrontend
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem as JaxSystem
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.pipeline import frontend as tfrontend
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    import test_torch_slice

    def up_one_ulp(frame):
        return frame._replace(kp_uv=jnp.nextafter(frame.kp_uv, jnp.inf))

    for scene in args.scenes.split(","):
        cfg, world, params = _scene(scene)
        imgs, gt = test_torch_slice.render_frames(
            jsyn, world, cfg.camera, params, cfg.aruco.dictionary)
        tcfg = SlamConfig.from_dict(dataclasses.asdict(cfg))
        runs = {}
        for name, nudge in (("jax", None), ("jax again", None),
                            ("jax +1ulp", up_one_ulp)):
            t0 = time.perf_counter()
            runs[name] = _run(JaxSystem(cfg), jfrontend.make_frame,
                              jnp.asarray, imgs, nudge)
            runs[name] += (time.perf_counter() - t0,)
        t0 = time.perf_counter()
        runs["port"] = _run(SlamSystem(tcfg, device="cpu"),
                            tfrontend.make_frame,
                            lambda a: torch.as_tensor(a), imgs)
        runs["port"] += (time.perf_counter() - t0,)
        ref = runs["jax"]
        print(f"scene {scene}: {len(imgs)} frames", flush=True)
        for name, run in runs.items():
            r, t, first = _compare(run, ref)
            print(f"  {name:10s} states equal {run[0] == ref[0]}; inserts "
                  f"{run[2]}; points {run[3]}; ATE "
                  f"{_ate(run[0], run[1], gt) * 1000:.3f} mm; vs jax worst "
                  f"{r:.4f} deg / {t * 100:.4f} cm, first frame beyond "
                  f"{ROT_DEG} deg / {TRANS_M * 100:.0f} cm: {first}; "
                  f"{run[4]:.0f} s", flush=True)
    _steps(up_one_ulp)
    _seed_witness(args.witness_frame)
    return 0


def _jax_frame(step, name):
    import jax.numpy as jnp

    from orb_slam2_aruco_tpu.pipeline.frontend import Frame

    if not step[f"has_{name}"]:
        return None
    return Frame(**{f: jnp.asarray(step[f"{name}_{f}"])
                    for f in Frame._fields})


def _jax_load(system, step):
    """Set the JAX SlamSystem to a recorded state (the JAX twin of
    tests/test_torch_slam_slice.py's `_load_step`)."""
    import jax.numpy as jnp

    from orb_slam2_aruco_tpu.pipeline.system import TrackingState
    from orb_slam2_aruco_tpu.worldmap.state import MapState
    from test_torch_slice import STEP_SCALARS

    system.map = MapState(**{f: jnp.asarray(step[f"map_{f}"])
                             for f in MapState._fields})
    for a in STEP_SCALARS:
        v = int(step[a])
        setattr(system, a, TrackingState(v) if a == "state" else v)
    system.init_ts = float(step["init_ts"])
    system._kf_valid_host = step["kf_valid_host"].copy()
    system.kf_ts64 = step["kf_ts64"].copy()
    system.last_frame = _jax_frame(step, "last_frame")
    system.init_frame = _jax_frame(step, "init_frame")
    system.last_obs = (jnp.asarray(step["last_obs"])
                       if step["has_last_obs"] else None)
    for name in ("last_pose", "vel"):
        setattr(system, name, (jnp.asarray(step[f"{name}_R"]),
                               jnp.asarray(step[f"{name}_t"]))
                if step[f"has_{name}"] else None)


def _steps(nudge):
    """Per recorded step of the recorded scene: the pose difference from the
    recorded JAX pose of JAX stepped from the recorded state (as is, and
    with the frame nudged) and of the port."""
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem as JaxSystem
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    import test_torch_slam_slice as slam_slice
    from test_torch_slice import _rot_err_deg

    ref = slam_slice._ref()
    cfg = slam_slice._cfg(ref)

    def err(pose, i):
        if pose is None:
            return "-"
        dt = np.linalg.norm(np.asarray(pose[1]) - ref["ref_slam_t"][i])
        return (f"{_rot_err_deg(pose[0], ref['ref_slam_R'][i]):.4f} deg / "
                f"{dt * 100:.4f} cm")

    print("steps from the recorded JAX states, pose vs the recorded pose:",
          flush=True)
    jsys = JaxSystem(_scene("recorded")[0])
    tsys = SlamSystem(cfg, device="cpu")
    for i in range(len(ref["ref_slam_state"])):
        step = slam_slice._step(ref, i)
        out = []
        for f in (lambda fr: fr, nudge):
            _jax_load(jsys, step)
            jsys.frame_id = i + 1
            out.append(jsys._step_frame(f(_jax_frame(step, "frame")), i,
                                        i / 30.0))
        slam_slice._load_step(tsys, step)
        tsys.frame_id = i + 1
        out.append(tsys._step_frame(slam_slice._frame(step, "frame"), i,
                                    i / 30.0))
        print(f"  frame {i}: jax {err(out[0], i)}; jax +1ulp "
              f"{err(out[1], i)}; port {err(out[2], i)}", flush=True)


def _seed_witness(i):
    """The tracking cascade of recorded step i in its two halves: the seed
    (marker seed + motion-model track) and the local-map refinement. Prints
    the port's seed against JAX's, JAX's refinement started from the
    port's seed against both final poses, and how far JAX's own seed moves
    when the frame's keypoints move by 1, 2, 4 and 8 ulp."""
    import jax.numpy as jnp
    import torch

    from orb_slam2_aruco_tpu.geometry.lie import se3_compose as jax_compose
    from orb_slam2_aruco_tpu.pipeline import tracking as jtrack
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem as JaxSystem
    from orb_slam2_aruco_tpu_torch.geometry.lie import se3_compose
    from orb_slam2_aruco_tpu_torch.pipeline import tracking as ttrack
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    import test_torch_slam_slice as slam_slice
    from test_torch_slice import _rot_err_deg

    ref = slam_slice._ref()
    step = slam_slice._step(ref, i)
    jsys = JaxSystem(_scene("recorded")[0])
    _jax_load(jsys, step)
    tsys = SlamSystem(slam_slice._cfg(ref), device="cpu")
    slam_slice._load_step(tsys, step)
    ref_kf = int(step["ref_kf"])

    def jax_seed(frame):
        lf, (Rl, tl), (vR, vt) = jsys.last_frame, jsys.last_pose, jsys.vel
        Rp, tp = jax_compose(vR, vt, Rl, tl)
        return jtrack._cascade_seed(
            jsys.map, frame, Rp, tp, Rl, tl, lf.kp_uv, lf.desc,
            jsys.last_obs, lf.kp_valid, lf.kp_octave, lf.kp_angle,
            jnp.asarray(ref_kf), jsys.cam, jsys.cfg)

    def jax_refine(frame, seed):
        tr, slots, old, ok_a, need_ref = seed
        return jtrack._cascade_refine(jsys.map, frame, tr, slots, old, ok_a,
                                      need_ref, jnp.asarray(ref_kf),
                                      jsys.cam, jsys.cfg)

    jframe = _jax_frame(step, "frame")
    jseed = jax_seed(jframe)
    jout = jax_refine(jframe, jseed)
    lf, (Rl, tl), (vR, vt) = tsys.last_frame, tsys.last_pose, tsys.vel
    Rp, tp = se3_compose(vR, vt, Rl, tl)
    tframe = slam_slice._frame(step, "frame")
    tseed = ttrack._cascade_seed(
        tsys.map, tframe, Rp, tp, Rl, tl, lf.kp_uv, lf.desc, tsys.last_obs,
        lf.kp_valid, lf.kp_octave, lf.kp_angle, torch.tensor(ref_kf),
        tsys.cam, tsys.cfg)
    tout = ttrack._cascade_refine(tsys.map, tframe, *tseed,
                                  torch.tensor(ref_kf), tsys.cam, tsys.cfg)
    tr = tseed[0]
    cross = jax_refine(jframe, (jtrack.TrackResult(
        jnp.asarray(tr.Rcw.numpy()), jnp.asarray(tr.tcw.numpy()),
        jnp.asarray(tr.obs_point.numpy().astype(np.int32)),
        jnp.asarray(int(tr.n_inliers)), jnp.asarray(int(tr.n_matches))),)
        + jseed[1:])
    R = lambda x: np.asarray(x.Rcw)   # noqa: E731
    print(f"frame {i}, the cascade in halves: seed inliers JAX "
          f"{int(jseed[0].n_inliers)}, port {int(tr.n_inliers)}, port seed "
          f"{_rot_err_deg(R(jseed[0]), R(tr)):.4f} deg from JAX's; final "
          f"inliers JAX {int(jout.n_inliers)}, port {int(tout.n_inliers)}, "
          f"port {_rot_err_deg(R(jout), R(tout)):.4f} deg from JAX; JAX's "
          f"refinement from the port's seed: {int(cross.n_inliers)} inliers,"
          f" {_rot_err_deg(R(jout), R(cross)):.4f} deg from JAX's final, "
          f"{_rot_err_deg(R(tout), R(cross)):.4f} deg from the port's",
          flush=True)
    for k in (1, 2, 4, 8):
        uv = jframe.kp_uv
        for _ in range(k):
            uv = jnp.nextafter(uv, jnp.inf)
        moved = jframe._replace(kp_uv=uv)
        seed = jax_seed(moved)
        out = jax_refine(moved, seed)
        print(f"  JAX with the keypoints {k} ulp up: seed "
              f"{_rot_err_deg(R(jseed[0]), R(seed[0])):.4f} deg from its "
              f"own, final {int(out.n_inliers)} inliers, "
              f"{_rot_err_deg(R(jout), R(out)):.4f} deg", flush=True)


if __name__ == "__main__":
    sys.exit(main())
