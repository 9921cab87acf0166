"""The port's viewers against the JAX package: viz/framedrawer.py (frame
overlay, top-down map view, PNG encoder) and viz/viewer.py (the map
snapshot and the HTTP viewer), and the video CLI's viewer tick.

Stated tolerances: images, PNG bytes and map snapshots equal to JAX's on
the same inputs (the ref_full map, a recorded 25h7 frame); the HTTP round
trip and the cross-origin rejection as tests/test_viewer.py:71,109 hold
them for JAX.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu.viz import framedrawer as jdraw
from orb_slam2_aruco_tpu.viz import viewer as jview
from orb_slam2_aruco_tpu.worldmap.state import MapState as JMap
from orb_slam2_aruco_tpu_torch.viz import framedrawer as tdraw
from orb_slam2_aruco_tpu_torch.viz import viewer as tview
from orb_slam2_aruco_tpu_torch.worldmap.state import (
    MapState as TMap,
    state_from_numpy,
)

from test_torch_slice import DATA_DIR, VIDEO_PATH


def _maps(name="full"):
    with np.load(os.path.join(DATA_DIR, f"ref_{name}.npz")) as z:
        arrays = {f: z[f] for f in TMap._fields}
    return (state_from_numpy(arrays),
            JMap(**{f: jnp.asarray(v) for f, v in arrays.items()}))


@pytest.fixture(scope="module")
def frame():
    with np.load(VIDEO_PATH) as z:
        return z["frames"][8]


def test_draw_frame_equals_jax(frame):
    rng = np.random.default_rng(5)
    H, W = frame.shape
    uv = rng.uniform([-5, -5], [W + 5, H + 5], (300, 2)).astype(np.float32)
    uv[:10] = 0.0                            # padded keypoints are skipped
    tracked = rng.random(300) < 0.5
    corners = rng.uniform([0, 0], [W, H], (6, 4, 2)).astype(np.float32)
    valid = np.asarray([1, 0, 1, 1, 0, 1], bool)
    want, winfo = jdraw.draw_frame(frame, uv, tracked, corners, valid)
    got, info = tdraw.draw_frame(torch.as_tensor(frame), torch.as_tensor(uv),
                                 torch.as_tensor(tracked),
                                 torch.as_tensor(corners),
                                 torch.as_tensor(valid))
    np.testing.assert_array_equal(got, want)
    assert info == winfo and info["n_markers"] == 4
    got, info = tdraw.draw_frame(frame.astype(np.float32), uv, tracked)
    want, winfo = jdraw.draw_frame(frame.astype(np.float32), uv, tracked)
    np.testing.assert_array_equal(got, want)
    assert info == winfo
    assert tdraw.encode_png(got) == jdraw.encode_png(want)


@pytest.mark.parametrize("name", ["full", "small"])
def test_map_view_and_png_equal_jax(tmp_path, name):
    tm, jm = _maps(name)
    for kw in ({}, {"size": 320, "axes": (0, 1)}):
        want = jdraw.draw_map_topdown(jm, **kw)
        got = tdraw.draw_map_topdown(tm, **kw)
        np.testing.assert_array_equal(got, want)
        assert tdraw.encode_png(got) == jdraw.encode_png(want)
    tdraw.save_png(str(tmp_path / "m.png"), got)
    assert (tmp_path / "m.png").read_bytes() == jdraw.encode_png(want)
    # an empty map draws the blank canvas
    empty = tm._replace(kf_valid=torch.zeros_like(tm.kf_valid),
                        pt_valid=torch.zeros_like(tm.pt_valid),
                        mk_valid=torch.zeros_like(tm.mk_valid))
    assert (tdraw.draw_map_topdown(empty, size=64) == 255).all()


@pytest.mark.parametrize("kw", [{}, {"max_points": 100, "covis_min_weight": 5,
                                     "max_edges": 1}])
def test_snapshot_map_equals_jax(kw):
    tm, jm = _maps("full")
    want = jview.snapshot_map(jm, **kw)
    got = tview.snapshot_map(tm, **kw)
    assert json.dumps(got) == json.dumps(want)
    assert len(got["kf_centers"]) == int(tm.kf_valid.sum())
    assert len(got["markers"]) == int(tm.mk_valid.sum()) > 0


def _post(base, msg, origin=None):
    headers = {"Origin": origin} if origin else {}
    req = urllib.request.Request(base + "/control",
                                 data=json.dumps(msg).encode(),
                                 headers=headers, method="POST")
    return urllib.request.urlopen(req, timeout=5)


def test_viewer_http_roundtrip():
    tm, jm = _maps("full")
    v = tview.MapViewer(port=0)
    try:
        frame = np.zeros((24, 32, 3), np.uint8)
        frame[4:8, 4:8] = 255
        Rcw = torch.eye(3)
        tcw = torch.tensor([0.0, 0.0, -3.0])
        v.update(map_state=tm, frame_rgb=frame, cam_Rcw=Rcw, cam_tcw=tcw,
                 status="state: OK")
        base = f"http://127.0.0.1:{v.port}"
        html = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"Show Aruco" in html and b"Localization Mode" in html
        st = json.loads(urllib.request.urlopen(base + "/state",
                                               timeout=5).read())
        assert st["status"] == "state: OK" and st["seq"] == 1
        assert st["map"] == json.loads(json.dumps(jview.snapshot_map(jm)))
        assert st["cam"]["c"] == [0.0, 0.0, 3.0]          # -Rwc @ tcw
        png = urllib.request.urlopen(base + "/frame.png", timeout=5).read()
        assert png == jdraw.encode_png(frame)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/missing", timeout=5)
        assert e.value.code == 404
        # menu toggle -> poll_controls (the Viewer->Tracking flag protocol)
        _post(base, {"cmd": "localization", "value": True})
        assert v.poll_controls() == {"localization": True}
        assert v.poll_controls() == {}                    # one-shot drain
    finally:
        v.close()


def test_viewer_rejects_cross_origin_control():
    v = tview.MapViewer(port=0)
    try:
        base = f"http://127.0.0.1:{v.port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, {"cmd": "reset", "value": True},
                  origin="http://evil.example")
        assert e.value.code == 403
        assert v.poll_controls() == {}
        _post(base, {"cmd": "reset", "value": True},
              origin=f"http://127.0.0.1:{v.port}")
        assert v.poll_controls() == {"reset": True}
        _post(base, {"cmd": "reset", "value": False})    # no Origin: the CLI
        assert v.poll_controls() == {"reset": False}
    finally:
        v.close()


def test_viewer_tick_publishes_a_system_and_applies_controls(frame):
    """The video CLI's tick with the port's SlamSystem: its map snapshot
    every `snapshot_every` updates, its status line, the raw frame while
    LOST, and the UI's localization / reset commands."""
    from orb_slam2_aruco_tpu_torch import config as tconfig
    from orb_slam2_aruco_tpu_torch.examples.mono_video import _viewer_tick
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    with np.load(os.path.join(DATA_DIR, "ref_small.npz")) as z:
        cfg = tconfig.SlamConfig.from_dict(json.loads(str(z["ref_cfg"])))
    system = SlamSystem(cfg, device="cpu")
    system.load_map(os.path.join(DATA_DIR, "ref_small.npz"))
    v = tview.MapViewer(port=0, snapshot_every=2)
    try:
        base = f"http://127.0.0.1:{v.port}"
        img = torch.as_tensor(frame[:240, :320])
        _viewer_tick(v, system, img)
        st = json.loads(urllib.request.urlopen(base + "/state",
                                               timeout=5).read())
        assert st["status"] == (
            f"state: LOST\nKFs: {system.n_keyframes}  MPs: "
            f"{int(system.map.pt_valid.sum())}  markers: "
            f"{int(system.map.mk_valid.sum())}\nframe: 0  mode: LOC")
        assert len(st["map"]["kf_centers"]) == int(system.map.kf_valid.sum())
        png = urllib.request.urlopen(base + "/frame.png", timeout=5).read()
        gray = np.repeat(frame[:240, :320, None], 3, axis=-1)
        assert png == jdraw.encode_png(gray)
        _post(base, {"cmd": "localization", "value": False})
        _viewer_tick(v, system, img, publish_frame=False)
        assert not system.localization_only
        _post(base, {"cmd": "reset", "value": True})
        _viewer_tick(v, system, img, publish_frame=False)
        assert system.state is TrackingState.NO_IMAGES_YET
        assert int(system.map.kf_valid.sum()) == 0
    finally:
        v.close()
