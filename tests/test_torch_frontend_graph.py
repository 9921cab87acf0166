"""make_frame's routes: eager on the CPU, two captured CUDA graphs on the
card (pipeline/frontend.py).

The CPU tests hold the route choice, the `GRAPH` counter and `graph_key`.
The tests marked `cuda` run the card's route at the benchmark's TUM1 and
KITTI 00-02 camera settings (slambench/configs/) against the eager route on
the same card. This file imports no jax (the GPU machine has none):

    python -m pytest tests/test_torch_frontend_graph.py --noconftest -q
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
from orb_slam2_aruco_tpu_torch.pipeline import frontend

torch.set_num_threads(1)    # as in test_torch_slice.py: small CPU tensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"tum1": "tum1-640x480.json", "kitti": "kitti00-1241x376.json"}


def bench_config(name):
    """The benchmark's configuration `name` (slambench/configs/) as run."""
    with open(os.path.join(REPO, "slambench", "configs", CONFIGS[name])) as f:
        return SlamConfig.from_dict(json.load(f)["slam"])


def small_config():
    """TUM1's camera at half size with 400 features: a CPU frame in ~1 s."""
    cfg = bench_config("tum1")
    c = cfg.camera
    return cfg.replace(
        camera=dataclasses.replace(c, fx=c.fx / 2, fy=c.fy / 2, cx=c.cx / 2,
                                   cy=c.cy / 2, width=320, height=240),
        orb=dataclasses.replace(cfg.orb, num_features=400))


def rendered(cfg, n):
    """n uint8 views of a 4x4 marker wall, each from another place."""
    world = synthetic.build_world(list(range(1, 17)), marker_size=0.187,
                                  grid_cols=4, spacing=0.6, px_per_m=500.0)
    out = []
    for k in range(n):
        R, t = synthetic.look_at_plane_pose((0.5 + 0.25 * k, 0.8), 2.3,
                                            yaw=0.04 * k - 0.06)
        out.append(torch.as_tensor(np.clip(synthetic.render_view(
            world, cfg.camera, R, t), 0, 255).astype(np.uint8)))
    return out


def counted(fn):
    """(fn(), the change of frontend.GRAPH over the call)."""
    before = dict(frontend.GRAPH)
    out = fn()
    return out, {k: frontend.GRAPH[k] - before[k] for k in before}


# ---------------------------------------------------------------------------
# the CPU: eager, and the key a capture is made for
# ---------------------------------------------------------------------------


def test_make_frame_on_the_cpu_stays_eager():
    cfg = small_config()
    cam = camera_from_config(cfg.camera)
    img = rendered(cfg, 1)[0]
    graphs = dict(frontend._GRAPHS)
    frame, moved = counted(lambda: frontend.make_frame(img, cam, cfg))
    assert moved == {"capture": 0, "replay": 0, "eager": 1}
    assert frontend._GRAPHS == graphs
    assert frame.mk_valid.sum() >= 2 and frame.kp_valid.sum() >= 100
    eager = frontend._make_frame_eager(img, cam, cfg)
    for f in frontend.Frame._fields:
        assert torch.equal(getattr(frame, f), getattr(eager, f)), f


def test_the_cpu_route_times_both_halves_once_a_call():
    from orb_slam2_aruco_tpu_torch.utils import telemetry

    cfg = small_config()
    cam = camera_from_config(cfg.camera)
    img = rendered(cfg, 1)[0]
    calls = {n: telemetry.SPAN_CALLS[n]
             for n in ("frontend.orb", "frontend.aruco")}
    frontend.make_frame(img, cam, cfg)
    assert all(telemetry.SPAN_CALLS[n] == c + 1 for n, c in calls.items())


def _changed(what, img, cam, cfg):
    """(img, cam, cfg) with one thing that make_frame depends on changed."""
    if what == "shape":
        return img[:-8], cam, cfg
    if what == "dtype":
        return img.to(torch.float32), cam, cfg
    if what == "orb":
        return img, cam, cfg.replace(orb=dataclasses.replace(
            cfg.orb, fast_threshold=cfg.orb.fast_threshold + 1))
    if what == "aruco":
        return img, cam, cfg.replace(aruco=dataclasses.replace(
            cfg.aruco, detect_downsample=2))
    if what == "retrieval":
        return img, cam, cfg.replace(retrieval=dataclasses.replace(
            cfg.retrieval, num_words=cfg.retrieval.num_words // 2))
    if what == "camera":     # the same values in other tensors
        return img, camera_from_config(cfg.camera), cfg
    if what == "camera_size":
        return img, cam._replace(width=cam.width - 1), cfg
    raise ValueError(what)


@pytest.mark.parametrize("what", ["shape", "dtype", "orb", "aruco",
                                  "retrieval", "camera", "camera_size"])
def test_graph_key_separates(what):
    cfg = small_config()
    cam = camera_from_config(cfg.camera)
    img = torch.zeros((240, 320), dtype=torch.uint8)
    assert (frontend.graph_key(*_changed(what, img, cam, cfg))
            != frontend.graph_key(img, cam, cfg))


def test_graph_key_holds_for_other_pixels_and_equal_settings():
    """Another image of the same shape and dtype, the same camera and a
    configuration equal to the first (another object, or other settings
    that make_frame does not read) share the key."""
    cfg = small_config()
    cam = camera_from_config(cfg.camera)
    a = torch.zeros((240, 320), dtype=torch.uint8)
    b = torch.full((240, 320), 200, dtype=torch.uint8)
    other = SlamConfig.from_dict(cfg.to_dict()).replace(
        tracking=dataclasses.replace(cfg.tracking, pipeline_depth=4))
    assert frontend.graph_key(b, cam, other) == frontend.graph_key(a, cam,
                                                                   cfg)


# ---------------------------------------------------------------------------
# the card: replays against the eager route
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the captured frame runs K1-K3, which "
                    "have no CPU or interpret mode")
    return torch.device("cuda")


def _frames(name, device, n=4):
    cfg = bench_config(name)
    return cfg, [im.to(device) for im in rendered(cfg, n)]


def _assert_frames_equal(got, want):
    """Every field equal, bit for bit: a replay runs the eager route's
    kernels on the same inputs."""
    for f in frontend.Frame._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), (f, (a != b).sum().item())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_replayed_frames_equal_the_eager_route(cuda_device, name):
    cfg, imgs = _frames(name, cuda_device)
    cam = camera_from_config(cfg.camera, cuda_device)
    first, moved = counted(lambda: frontend.make_frame(imgs[0], cam, cfg))
    assert moved == {"capture": 1, "replay": 0, "eager": 0}
    _assert_frames_equal(first, frontend._make_frame_eager(imgs[0], cam,
                                                           cfg))
    seen = 0
    for img in imgs:
        frame, moved = counted(lambda: frontend.make_frame(img, cam, cfg))
        assert moved == {"capture": 0, "replay": 1, "eager": 0}
        _assert_frames_equal(frame, frontend._make_frame_eager(img, cam, cfg))
        seen += int(frame.mk_valid.sum())
    assert seen >= 4


@pytest.mark.cuda
def test_a_frame_returned_earlier_is_unchanged_by_later_calls(cuda_device):
    cfg, imgs = _frames("tum1", cuda_device)
    cam = camera_from_config(cfg.camera, cuda_device)
    kept = [frontend.make_frame(img, cam, cfg) for img in imgs]
    copies = [[t.clone() for t in f] for f in kept]
    for img in reversed(imgs):
        frontend.make_frame(img, cam, cfg)
    torch.cuda.synchronize()
    for f, c in zip(kept, copies):
        assert all(torch.equal(a, b) for a, b in zip(f, c))


@pytest.mark.cuda
def test_each_replay_counts_one_launch_of_k1_k2_and_k3(cuda_device):
    cfg, imgs = _frames("kitti", cuda_device)
    cam = camera_from_config(cfg.camera, cuda_device)
    kernels.reset_launch_counts()
    frontend.make_frame(imgs[0], cam, cfg)           # capture: one each
    assert kernels.launch_counts == {"fast": 1, "patches": 1, "cc_fused": 1,
                                     "cc_propagate": 0, "pose_lm": 0}
    for img in imgs:
        frontend.make_frame(img, cam, cfg)
    n = 1 + len(imgs)
    assert kernels.launch_counts == {"fast": n, "patches": n, "cc_fused": n,
                                     "cc_propagate": 0, "pose_lm": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["shape", "camera", "orb", "aruco"])
def test_a_new_key_captures_anew(cuda_device, what):
    cfg, imgs = _frames("tum1", cuda_device, n=2)
    cam = camera_from_config(cfg.camera, cuda_device)
    frontend.make_frame(imgs[0], cam, cfg)
    img2, cam2, cfg2 = _changed(what, imgs[1], cam, cfg)
    if what == "camera":
        cam2 = camera_from_config(cfg.camera, cuda_device)
    frame, moved = counted(lambda: frontend.make_frame(img2, cam2, cfg2))
    assert moved == {"capture": 1, "replay": 0, "eager": 0}
    _assert_frames_equal(frame, frontend._make_frame_eager(img2, cam2, cfg2))
    again, moved = counted(lambda: frontend.make_frame(img2, cam2, cfg2))
    assert moved == {"capture": 0, "replay": 1, "eager": 0}
    _assert_frames_equal(again, frame)
    # the first key still replays
    _, moved = counted(lambda: frontend.make_frame(imgs[0], cam, cfg))
    assert moved == {"capture": 0, "replay": 1, "eager": 0}
