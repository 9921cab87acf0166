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

Each file is a valid map checkpoint (the JAX and the port's load_map read
it) with the reference arrays under `ref_*` keys. Regenerate with

    python tests/test_torch_slice.py --regen [small|full]
"""

from __future__ import annotations

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "orb_slam2_aruco_tpu_torch", "data")


# ---------------------------------------------------------------------------
# the two reference setups
# ---------------------------------------------------------------------------


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
    n = 12

    def pose(u):   # continuous frame parameter of tests/test_smoke.py
        return (0.3 + 0.4 * u / n, 0.22, 1.3,
                0.1 * np.sin(2 * np.pi * u / n), 0.05)

    map_params = [pose(i) for i in range(n)]
    loc_params = [pose(i + 0.5) for i in range(2, 10)]
    return cfg, world, map_params, loc_params


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


def render_frames(syn, world_kw, camc, params, dict_name="ARUCO"):
    """uint8 frames and ground-truth poses for (x, y, dist, yaw, pitch)
    render parameters; `syn` is either package's io.synthetic."""
    world = syn.build_world(world_kw["marker_ids"], dict_name=dict_name,
                            marker_size=world_kw["marker_size"],
                            grid_cols=world_kw["grid_cols"],
                            spacing=world_kw["spacing"],
                            px_per_m=world_kw["px_per_m"])
    poses = [syn.look_at_plane_pose((x, y), d, yaw=yaw, pitch=pitch)
             for x, y, d, yaw, pitch in params]
    imgs = [np.clip(syn.render_view(world, camc, R, t), 0, 255)
            .astype(np.uint8) for R, t in poses]
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


if __name__ == "__main__":
    if "--regen" not in sys.argv:
        sys.exit("usage: python tests/test_torch_slice.py --regen "
                 "[small|full]")
    sys.path.insert(0, REPO)
    picked = [a for a in sys.argv[1:] if a in SETUPS]
    build_reference_data(tuple(picked) or ("small", "full"))


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
    system = SlamSystem(cfg)
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
    state = checkpoint.load_map(path)
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


def test_slam_mode_is_not_ported_yet():
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    system = SlamSystem(SlamConfig())
    with pytest.raises(NotImplementedError, match="slice 2"):
        system.track_monocular(np.zeros((540, 960), np.uint8), ts=0.0)
