"""track_full's routes: eager on the CPU and in SLAM mode, two captured CUDA
graphs on the card in localization mode (pipeline/tracking.py).

The CPU tests hold the route choice, the `GRAPH` counter, `graph_key` and
the table of captured keys (with the capture faked). The tests marked
`cuda` build a map in SLAM mode at the benchmark's TUM1 and KITTI 00-02
settings (slambench/configs/), localize 14 frames against it through the
facade and hold every replay to the eager route on the same card, bit for
bit, the fallbacks included. This file imports no jax (the GPU machine has
none):

    python -m pytest tests/test_torch_tracking_graph.py --noconftest -q
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.config import SlamConfig
from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
from orb_slam2_aruco_tpu_torch.io import synthetic
from orb_slam2_aruco_tpu_torch.optim import pose_opt
from orb_slam2_aruco_tpu_torch.pipeline import frontend, tracking
from orb_slam2_aruco_tpu_torch.pipeline.system import (
    SlamSystem,
    TrackingState,
)
from orb_slam2_aruco_tpu_torch.utils import telemetry
from orb_slam2_aruco_tpu_torch.worldmap.state import MapState, empty_map

torch.set_num_threads(1)    # as in test_torch_slice.py: small CPU tensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"tum1": "tum1-640x480.json", "kitti": "kitti00-1241x376.json"}


def bench_config(name):
    """The benchmark's configuration `name` (slambench/configs/) as run."""
    with open(os.path.join(REPO, "slambench", "configs", CONFIGS[name])) as f:
        return SlamConfig.from_dict(json.load(f)["slam"])


def counted(fn):
    """(fn(), the change of tracking.GRAPH over the call)."""
    before = dict(tracking.GRAPH)
    out = fn()
    return out, {k: tracking.GRAPH[k] - before[k] for k in before}


def _assert_results_equal(got, want):
    """Every field of two FullTrackResults equal, bit for bit."""
    for f in tracking.FullTrackResult._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), (f, (a != b).sum().item())


# ---------------------------------------------------------------------------
# the CPU: eager, the key, and the table of captured keys
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_inputs():
    """(state, frame, args, cam, cfg): TUM1's camera at half size with 400
    features, an empty map of small capacity, a rendered frame, the
    identity pose and the frame itself as the last one, no point seen."""
    cfg = bench_config("tum1")
    c = cfg.camera
    cfg = cfg.replace(
        camera=dataclasses.replace(c, fx=c.fx / 2, fy=c.fy / 2, cx=c.cx / 2,
                                   cy=c.cy / 2, width=320, height=240),
        orb=dataclasses.replace(cfg.orb, num_features=400),
        map=dataclasses.replace(cfg.map, max_keyframes=8, max_points=512))
    cam = camera_from_config(cfg.camera)
    world = synthetic.build_world(list(range(1, 17)), marker_size=0.187,
                                  grid_cols=4, spacing=0.6, px_per_m=500.0)
    R, t = synthetic.look_at_plane_pose((0.9, 0.8), 2.3)
    img = torch.as_tensor(np.clip(synthetic.render_view(
        world, cfg.camera, R, t), 0, 255).astype(np.uint8))
    frame = frontend.make_frame(img, cam, cfg)
    R, t = torch.as_tensor(R), torch.as_tensor(t)
    args = (R, t, R, t, *tracking._frame_context(
        frame, torch.full_like(frame.kp_octave, -1)), torch.tensor(0))
    return empty_map(cfg, "cpu"), frame, args, cam, cfg


@pytest.mark.parametrize("final_map", [True, False],
                         ids=["localization", "slam"])
def test_track_full_on_the_cpu_stays_eager(cpu_inputs, final_map):
    state, frame, args, cam, cfg = cpu_inputs
    graphs = dict(tracking._GRAPHS)
    out, moved = counted(lambda: tracking.track_full(
        state, frame, *args, cam, cfg, final_map=final_map))
    assert moved == {"capture": 0, "replay": 0, "eager": 1}
    assert tracking._GRAPHS == graphs
    assert not tracking._graph_route(state, final_map)
    _assert_results_equal(out, tracking._track_full_eager(
        state, frame, *args, cam, cfg, final_map))


def _changed(what, state, frame, args, cam, cfg):
    """track_full's inputs with one thing that a capture depends on
    changed: (state, frame, args, cam, cfg, final_map, seed_budget)."""
    final_map, seed_budget = True, False
    if what == "map":                # the same values in another tensor
        state = state._replace(pt_xyz=state.pt_xyz.clone())
    elif what == "map_shape":
        state = state._replace(pt_desc=state.pt_desc[:-1])
    elif what == "shape":
        frame = frame._replace(**{f: getattr(frame, f)[:-1] for f in (
            "kp_uv", "kp_octave", "kp_angle", "desc", "kp_valid")})
    elif what == "dtype":
        args = (*args[:-1], args[-1].to(torch.int32))
    elif what == "camera":           # the same values in other tensors
        cam = camera_from_config(cfg.camera)
    elif what == "camera_size":
        cam = cam._replace(width=cam.width - 1)
    elif what == "final_map":
        final_map = False
    elif what == "seed_budget":
        seed_budget = True
    else:
        group = getattr(cfg, what)
        field = {"orb": "fast_threshold", "aruco": "min_quad_side_px",
                 "matcher": "search_radius_motion", "optim": "chi2_mono",
                 "tracking": "min_inliers_track"}[what]
        cfg = cfg.replace(**{what: dataclasses.replace(
            group, **{field: getattr(group, field) + 1})})
    return state, frame, args, cam, cfg, final_map, seed_budget


@pytest.mark.parametrize("what", [
    "map", "map_shape", "shape", "dtype", "camera", "camera_size",
    "final_map", "seed_budget", "orb", "aruco", "matcher", "optim",
    "tracking"])
def test_graph_key_separates(cpu_inputs, what):
    key = tracking.graph_key(*cpu_inputs)
    other = tracking.graph_key(*_changed(what, *cpu_inputs))
    assert other != key
    # another map under the same shapes and settings is the same entry
    # with another map: it replaces the entry
    assert (other[0] == key[0]) == (what == "map")


def test_graph_key_holds_for_other_pixels_poses_and_counts(cpu_inputs):
    """Another frame of the same shapes, other poses and last-frame
    context, new visible / found counts and a configuration equal to the
    first in what the cascade reads share the key: the replay copies them
    in."""
    state, frame, args, cam, cfg = cpu_inputs
    frame2 = frontend.Frame(*(t.clone() for t in frame))._replace(
        kp_uv=frame.kp_uv + 3.0, mk_valid=torch.zeros_like(frame.mk_valid))
    R = torch.as_tensor(synthetic.look_at_plane_pose((0.2, 0.4), 1.9,
                                                     yaw=0.1)[0])
    args2 = (R, args[1] + 0.5, R, args[3] - 0.5,
             *(t.clone() for t in args[4:6]),
             torch.zeros_like(args[6]), *(t.clone() for t in args[7:10]),
             torch.tensor(3))
    state2 = state._replace(pt_visible=state.pt_visible + 1.0,
                            pt_found=state.pt_found + 2.0)
    cfg2 = SlamConfig.from_dict(cfg.to_dict()).replace(
        retrieval=dataclasses.replace(cfg.retrieval, num_words=64),
        loop=dataclasses.replace(cfg.loop, consistency_threshold=5))
    assert (tracking.graph_key(state2, frame2, args2, cam, cfg2)
            == tracking.graph_key(state, frame, args, cam, cfg))


class _FakeGraphs:
    """What the table holds for a key, without a card."""

    def __init__(self, maps):
        self.maps, self.replays = maps, 0

    def replay(self, state, frame, args):
        self.replays += 1
        return "replayed"


def test_a_new_map_replaces_the_entry_of_its_key(cpu_inputs, monkeypatch):
    """The table's bookkeeping with the card's route forced and the capture
    faked: a key's first call captures, the next replays, new counts still
    replay, another map under the same shapes and settings captures anew
    and takes the old map's place, other settings take an entry of their
    own."""
    state, frame, args, cam, cfg = cpu_inputs
    table = {}
    monkeypatch.setattr(tracking, "_GRAPHS", table)
    monkeypatch.setattr(tracking, "_graph_route", lambda st, fm: fm)
    monkeypatch.setattr(
        tracking, "_capture",
        lambda st, fr, a, cm, cf, maps, fm: ("captured", _FakeGraphs(maps)))

    def call(st, c=cfg):
        return counted(lambda: tracking.track_full(st, frame, *args, cam, c,
                                                   final_map=True))

    assert call(state) == ("captured", {"capture": 1, "replay": 0,
                                        "eager": 0})
    assert call(state) == ("replayed", {"capture": 0, "replay": 1,
                                        "eager": 0})
    counts = state._replace(pt_visible=state.pt_visible + 1.0)
    assert call(counts)[1] == {"capture": 0, "replay": 1, "eager": 0}
    (head, maps_a), = [(h, g.maps) for h, g in table.items()]
    assert table[head].replays == 2
    other = MapState(*(t.clone() for t in state))
    assert call(other)[1] == {"capture": 1, "replay": 0, "eager": 0}
    assert list(table) == [head]
    assert table[head].maps == tracking.graph_key(other, frame, args, cam,
                                                  cfg)[1] != maps_a
    assert call(other)[1] == {"capture": 0, "replay": 1, "eager": 0}
    assert call(state)[1] == {"capture": 1, "replay": 0, "eager": 0}
    cfg2 = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, min_inliers_track=cfg.tracking.min_inliers_track + 1))
    assert call(state, cfg2)[1] == {"capture": 1, "replay": 0, "eager": 0}
    assert len(table) == 2
    # SLAM mode never enters the table
    _, moved = counted(lambda: tracking.track_full(
        state, frame, *args, cam, cfg, final_map=False))
    assert moved == {"capture": 0, "replay": 0, "eager": 1}
    assert len(table) == 2


# ---------------------------------------------------------------------------
# the card: replays against the eager route
# ---------------------------------------------------------------------------

# per configuration: the wall (markers, markers per row, spacing in m), the
# SLAM-mode map sweep and the localization sweep, each (from [x, y], to,
# frames, distance in m, yaw from and to), as the benchmark's traffic mixes
# lay them out (slambench/traffic/), shorter
SCENES = {
    "tum1": dict(markers=16, cols=4, spacing=0.6,
                 map=((0.3, 0.7), (1.5, 0.7), 32, 2.0, (-0.25, 0.25)),
                 loc=((0.6, 0.9), (1.2, 0.9), 14, 2.0, (0.15, -0.15))),
    "kitti": dict(markers=8, cols=8, spacing=1.4,
                  map=((0.0, 0.0), (5.6, 0.0), 40, 2.0, (0.0, 0.0)),
                  loc=((1.4, 0.0), (3.4, 0.0), 14, 2.3, (-0.15, 0.15))),
}


def _sweep(world, cfg, spec):
    (x0, y0), (x1, y1), n, dist, (a0, a1) = spec
    imgs = []
    for i in range(n):
        f = i / (n - 1)
        R, t = synthetic.look_at_plane_pose(
            (x0 + f * (x1 - x0), y0 + f * (y1 - y0)), dist,
            yaw=a0 + f * (a1 - a0))
        imgs.append(np.clip(synthetic.render_view(world, cfg.camera, R, t),
                            0, 255).astype(np.uint8))
    return imgs


def _spans():
    return {s: telemetry.SPAN_CALLS.get("tracking." + s, 0)
            for s in ("retry", "refkf")}


def _call(fn):
    """(fn(), tracking.GRAPH's change, the retry / refkf spans' calls, K5's
    launches and kernel-route LM calls over the call)."""
    spans = _spans()
    k5, lm = kernels.launch_counts["pose_lm"], pose_opt.LM_CALLS["kernel"]
    out, moved = counted(fn)
    took = {k: v - spans[k] for k, v in _spans().items()}
    return (out, moved, took, kernels.launch_counts["pose_lm"] - k5,
            pose_opt.LM_CALLS["kernel"] - lm)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def localized(request):
    """Per configuration: a map built in SLAM mode on the card, then
    14 frames localized through the facade with every track_full call
    recorded as (args, kwargs, result, GRAPH's change, fallbacks taken, K5
    launches, kernel LM calls), and a copy of each result made right after
    its call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the captured cascade runs K5, which "
                    "has no CPU or interpret mode")
    cfg, sc = bench_config(request.param), SCENES[request.param]
    world = synthetic.build_world(
        list(range(1, sc["markers"] + 1)),
        marker_size=cfg.aruco.marker_size, grid_cols=sc["cols"],
        spacing=sc["spacing"], extent_margin=1.2, px_per_m=500.0)
    system = SlamSystem(cfg, device="cuda")
    before = dict(tracking.GRAPH)
    for i, img in enumerate(_sweep(world, cfg, sc["map"])):
        system.track_monocular(img, ts=i / 30.0)
    slam_moved = {k: tracking.GRAPH[k] - before[k] for k in before}
    assert system.state is TrackingState.OK and system.n_keyframes >= 3
    system.activate_localization_mode()
    calls = []
    real = tracking.track_full

    def spy(*a, **k):
        rec = _call(lambda: real(*a, **k))
        calls.append((a, k, *rec, [t.clone() for t in rec[0]]))
        return rec[0]

    tracking.track_full = spy
    try:
        poses = [system.track_monocular(img, ts=10.0 + i / 30.0)
                 for i, img in enumerate(_sweep(world, cfg, sc["loc"]))]
    finally:
        tracking.track_full = real
    torch.cuda.synchronize()
    return cfg, system, slam_moved, poses, calls


@pytest.mark.cuda
def test_slam_mode_stays_eager_on_the_card(localized):
    _, system, slam_moved, _, calls = localized
    assert slam_moved["capture"] == slam_moved["replay"] == 0
    assert slam_moved["eager"] >= 20
    a, k = calls[-1][:2]
    graphs = dict(tracking._GRAPHS)
    out, moved, *_ = _call(lambda: tracking.track_full(
        *a[:-1], final_map=False))
    assert moved == {"capture": 0, "replay": 0, "eager": 1}
    assert tracking._GRAPHS == graphs
    _assert_results_equal(out, tracking._track_full_eager(*a[:-1]))


@pytest.mark.cuda
def test_replayed_cascade_equals_the_eager_route(localized):
    """Every localized frame: the first call of the key captures, the rest
    replay, and each result equals the eager route's on the same inputs."""
    _, _, _, poses, calls = localized
    assert sum(p is not None for p in poses) == len(poses) == len(calls)
    routes = [moved for _, _, _, moved, *_ in calls]
    assert routes[0]["eager"] == 0 and routes[0]["replay"] == 0
    assert all(m == {"capture": 0, "replay": 1, "eager": 0}
               for m in routes[1:])
    for a, k, out, *_ in calls:
        assert k == {} and a[-1] is True            # final_map
        _assert_results_equal(out, tracking._track_full_eager(*a, **k))
        assert int(out.n_inliers) >= 30


# what each input of _fallback_inputs makes the cascade take: (retries,
# reference-keyframe tracks)
FALLBACKS = {"retry": (1, 0), "refkf": (0, 1), "both": (1, 1)}


def _fallback_inputs(a, case):
    """The last localized frame's inputs made to take the fallbacks.
    "retry": only 18 of the last frame's points kept, so that the motion
    model matches fewer than 20 and retries, and keeps enough inliers.
    "refkf": every keypoint moved 12 pixels in a seeded direction, so that
    the motion model still matches in its window but no point stays an
    inlier. "both": no point of the last frame kept and the markers
    hidden, so that the retry matches nothing either."""
    state, frame, R_pred, t_pred, R_last, t_last, *last, ref_kf = a[:13]
    obs = last[2]
    if case == "retry":
        keep = torch.cumsum((obs >= 0).to(torch.int64), 0) <= 18
        last[2] = torch.where(keep, obs, -1)
    elif case == "refkf":
        gen = torch.Generator(device=obs.device)
        gen.manual_seed(24)
        ang = 2 * np.pi * torch.rand(obs.shape, generator=gen,
                                     device=obs.device)
        frame = frame._replace(kp_uv=frame.kp_uv + 12.0 * torch.stack(
            [torch.cos(ang), torch.sin(ang)], dim=-1))
    else:
        last[2] = torch.full_like(obs, -1)
        frame = frame._replace(mk_good=torch.zeros_like(frame.mk_good))
    return (state, frame, R_pred, t_pred, R_last, t_last, *last, ref_kf,
            *a[13:])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_frames_replay_equal_to_the_eager_route(localized, case):
    """Frames that take the widened-window retry, the reference-keyframe
    track, or both: the fallbacks run eagerly between the two graphs, and
    the result equals the eager route's; each fallback adds one K5 launch
    to the replay's two."""
    ins = _fallback_inputs(localized[4][-1][0], case)
    out, moved, took, k5, lm = _call(lambda: tracking.track_full(*ins))
    assert moved == {"capture": 0, "replay": 1, "eager": 0}
    assert (took["retry"], took["refkf"]) == FALLBACKS[case]
    assert k5 == lm == 2 + took["retry"] + took["refkf"]
    _assert_results_equal(out, tracking._track_full_eager(*ins))


@pytest.mark.cuda
def test_a_result_returned_earlier_is_unchanged_by_later_replays(localized):
    _, _, _, _, calls = localized
    a = calls[-1][0]
    for _ in range(3):
        tracking.track_full(*a)
    torch.cuda.synchronize()
    for *_, out, _, _, _, _, copy in calls:
        assert all(torch.equal(x, y) for x, y in zip(out, copy))


@pytest.mark.cuda
def test_each_replay_counts_two_k5_launches(localized):
    _, _, _, _, calls = localized
    for _, _, _, moved, took, k5, lm, _ in calls:
        assert k5 == lm == 2 + took["retry"] + took["refkf"], (moved, took)


@pytest.mark.cuda
def test_a_new_map_captures_anew_and_drops_the_old_entry(localized):
    _, _, _, _, calls = localized
    a = calls[-1][0]
    state = a[0]
    other = MapState(*(t.clone() for t in state))
    head, maps = tracking.graph_key(state, a[1], a[2:13], *a[13:15])
    assert tracking._GRAPHS[head].maps == maps
    n = len(tracking._GRAPHS)
    ins = (other, *a[1:])
    out, moved, *_ = _call(lambda: tracking.track_full(*ins))
    assert moved == {"capture": 1, "replay": 0, "eager": 0}
    assert len(tracking._GRAPHS) == n
    assert tracking._GRAPHS[head].maps != maps
    _assert_results_equal(out, tracking._track_full_eager(*ins))
    again, moved, *_ = _call(lambda: tracking.track_full(*ins))
    assert moved == {"capture": 0, "replay": 1, "eager": 0}
    _assert_results_equal(again, out)
    # the first map captures again
    _, moved, *_ = _call(lambda: tracking.track_full(*a))
    assert moved == {"capture": 1, "replay": 0, "eager": 0}
