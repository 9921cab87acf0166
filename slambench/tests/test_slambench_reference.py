"""The frozen scene and the comparison: the renderer and the world against
the program's synthetic renderer, the dictionary against the program's,
the counts against the program's pyramid, and the comparison's verdict on
the truth and on a perturbed pose and map."""

import json
import os

import numpy as np
import pytest
import torch

import generator
from reference import compare, kernels, scene

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
TUM = os.path.join(BENCH, "configs", "tum1-640x480.json")


def small_world(seed=5, noise=25.0):
    """A 4 x 2 marker wall drawn as the program's build_world draws it."""
    rng = np.random.default_rng(seed)
    ids = [3, 17, 42, 99, 7, 23, 55, 88]
    px_per_m, spacing, margin = 400.0, 0.5, 0.5
    bounds = (-margin, -margin, 3 * spacing + margin, spacing + margin)
    (ht, wt), (hb, wb) = scene.texture_shape(*bounds, px_per_m)
    blocks = rng.uniform(90, 170, size=(hb, wb)).astype(np.float32)
    noise_a = rng.normal(0, noise, size=(ht, wt)).astype(np.float32)
    centers = [((i % 4) * spacing, (i // 4) * spacing) for i in range(8)]
    w = scene.build_world(ids, centers, 0.165, bounds, px_per_m,
                          torch.as_tensor(blocks), torch.as_tensor(noise_a))
    return w, ids, dict(px_per_m=px_per_m, spacing=spacing, margin=margin)


def test_world_equals_the_programs_build_world():
    from orb_slam2_aruco_tpu_torch.io import synthetic
    w, ids, kw = small_world()
    ref = synthetic.build_world(ids, marker_size=0.165, grid_cols=4,
                                spacing=kw["spacing"],
                                extent_margin=kw["margin"],
                                px_per_m=kw["px_per_m"], texture_noise=25.0,
                                seed=5)
    assert np.array_equal(w.texture.numpy(), ref.texture)


def test_renderer_matches_render_view_at_zero_distortion():
    from orb_slam2_aruco_tpu_torch.config import CameraConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic
    w, ids, kw = small_world()
    mw = synthetic.MarkerWorld(w.texture.numpy(), w.x_min, w.y_min,
                               w.px_per_m, [], "ARUCO")
    cam = dict(fx=300.0, fy=301.0, cx=160.5, cy=119.5, dist=[0.0] * 5,
               width=320, height=240)
    camc = CameraConfig(fx=300.0, fy=301.0, cx=160.5, cy=119.5,
                        width=320, height=240)
    r = scene.Renderer(w, cam)
    for xy, yaw, pitch in [((0.75, 0.25), 0.1, 0.05), ((0.5, 0.4), -0.2, 0.0)]:
        R, t = scene.look_at_plane_pose(xy, 1.6, yaw=yaw, pitch=pitch)
        a = r.render(R, t).numpy()
        b = synthetic.render_view(mw, camc, R.astype(np.float32),
                                  t.astype(np.float32))
        assert np.abs(a - b).max() < 0.05


def test_distortion_is_inverted():
    """The renderer's rays, distorted again, land on their pixels (TUM1's
    coefficients, every pixel)."""
    with open(TUM) as f:
        cam = generator.camera_of(json.load(f))
    rays = scene._undistort_rays(cam, "cpu").double().numpy()
    xd = scene.distort(cam, rays[..., :2])
    u = xd[..., 0] * cam["fx"] + cam["cx"]
    v = xd[..., 1] * cam["fy"] + cam["cy"]
    H, W = cam["height"], cam["width"]
    vv, uu = np.mgrid[0:H, 0:W]
    assert np.abs(u - uu).max() < 1e-3 and np.abs(v - vv).max() < 1e-3


def test_dictionary_and_ids():
    from orb_slam2_aruco_tpu_torch.ops.aruco.dictionary import get_dictionary
    assert np.array_equal(scene.aruco_codes(), get_dictionary("ARUCO").codes)
    ids = scene.distinct_ids()
    assert len(ids) >= 64


def test_frozen_counts_follow_the_programs_frame():
    from orb_slam2_aruco_tpu_torch.ops.image import pyramid_shapes
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import level_quotas
    assert kernels.pyramid_shapes(376, 1241, 8, 1.2) == \
        pyramid_shapes(376, 1241, 8, 1.2)
    assert kernels.level_quotas(2000, 8, 1.2) == level_quotas(2000, 8, 1.2)
    with open(TUM) as f:
        b = kernels.frame_bounds(json.load(f)["slam"])
    assert set(b) == set(kernels.KERNEL_NAMES) and min(b.values()) > 0


def truth_case():
    """A wall, true poses of a small orbit, and the map and detections a
    perfect program would give, in a map frame turned and moved from the
    world's."""
    w, _, _ = small_world()
    cam = dict(fx=300.0, fy=300.0, cx=160.0, cy=120.0, dist=[0.0] * 5,
               width=320, height=240)
    poses = {fid: scene.look_at_plane_pose(
        (0.75 + 0.2 * np.cos(a), 0.25 + 0.1 * np.sin(a)), 1.0,
        yaw=0.1 * np.sin(a)) for fid, a in enumerate(np.linspace(0, 6, 12))}
    Rmw, _ = scene.look_at_plane_pose((0.3, -0.2), 0.5, yaw=0.4, pitch=0.2)
    tmw = np.asarray([0.1, -0.3, 0.7])

    def to_map(R, t):
        return R @ Rmw.T, t - R @ Rmw.T @ tmw

    posed = [(fid, to_map(*p)) for fid, p in poses.items()]
    kfs = [0, 4, 8]
    mp = dict(kf_frame_id=np.asarray(kfs),
              kf_Rcw=np.stack([to_map(*poses[k])[0] for k in kfs]),
              kf_tcw=np.stack([to_map(*poses[k])[1] for k in kfs]),
              mk_id=np.asarray(w.ids),
              mk_Rwm=np.stack([Rmw] * len(w.ids)),
              mk_twm=np.stack([Rmw @ np.r_[c, 0.0] + tmw for c in w.centers]),
              pt_xyz=(np.c_[np.random.default_rng(1).uniform(0, 1.5, (50, 2)),
                            np.zeros(50)] @ Rmw.T + tmw))
    samples = []
    for fid, (R, t) in poses.items():
        uv, whole, part = compare.in_view(w, cam, R, t)
        seen = np.flatnonzero(whole)
        if not len(seen):
            continue
        tcm = np.stack([R @ np.r_[w.centers[i], 0.0] + t for i in seen])
        samples.append((fid, np.asarray(w.ids)[seen], uv[seen],
                        np.ones(len(seen), bool), tcm))
    assert len(samples) >= 6
    return w, cam, poses, posed, mp, samples


LIMITS = {"pose_err_max_cm": 5.0, "kf_err_max_cm": 5.0,
          "marker_pos_max_cm": 5.0, "detect_pos_p90_cm": 5.0,
          "lost_pct": 5.0}


def test_the_truth_is_correct():
    w, cam, truth, posed, mp, samples = truth_case()
    n = compare.compare(w, cam, truth, posed, mp, samples)
    assert compare.judge(n, LIMITS)[0]
    for k in LIMITS:
        assert n[k] < 1e-6, k
    assert n["point_plane_p90_cm"] < 1e-6 and n["corner_max_px"] < 1e-6


@pytest.mark.parametrize("what", ["pose", "turned", "keyframes",
                                  "markers", "detections", "lost"])
def test_a_perturbed_answer_is_rejected(what):
    w, cam, truth, posed, mp, samples = truth_case()
    shift = np.asarray([0.0, 0.1, 0.0])
    turn, _ = scene.look_at_plane_pose((0, 0), 0.0, yaw=0.05)
    if what == "pose":
        posed = [(fid, (R, t + shift)) for fid, (R, t) in posed]
    elif what == "turned":
        # a turn about the camera centre moves no centre
        posed = [(fid, (turn @ R, turn @ t)) for fid, (R, t) in posed]
    elif what == "keyframes":
        mp["kf_tcw"] = mp["kf_tcw"] + shift
        mp["kf_tcw"][0] -= 2 * shift
    elif what == "markers":
        mp["mk_twm"] = mp["mk_twm"].copy()
        mp["mk_twm"][0] += shift
    elif what == "detections":
        samples = [(f, i, c, v, tcm * 1.1) for f, i, c, v, tcm in samples]
    else:
        posed = posed[:2] + [(fid, None) for fid, _ in posed[2:]]
    n = compare.compare(w, cam, truth, posed, mp, samples)
    ok, rows = compare.judge(n, LIMITS)
    assert not ok, rows
