"""The port's real-footage entry point against the JAX package: the camera
file parsers, the cv2 sources, the native quad proposer and the video CLI
(`python -m orb_slam2_aruco_tpu_torch.examples.mono_video`) over the
recorded 25h7 fly-by of orb_slam2_aruco_tpu_torch/data/ref_video.npz
(`python tests/test_torch_slice.py --video`).

Stated tolerances: CameraConfigs, source frames, timestamps and native
quads equal to JAX's; the CLI's pass-1 state per frame, keyframe count,
keyframe frame ids and pass-2 tracked frames equal to the JAX CLI's
recorded run, its pass-2 poses within the SLAM limit (0.5 deg / 2 cm) and
its ATE at most max(1.5 x JAX, JAX + 5 mm) and below the JAX test's
0.12 m.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

import torch

from orb_slam2_aruco_tpu.io import ingest as jingest
from orb_slam2_aruco_tpu.ops.aruco import native as jnative
from orb_slam2_aruco_tpu_torch.config import CameraConfig
from orb_slam2_aruco_tpu_torch.io import ingest as tingest
from orb_slam2_aruco_tpu_torch.ops.aruco import native as tnative

from test_torch_slice import REPO, VIDEO_PATH, _rot_err_deg

cv2 = pytest.importorskip("cv2")
sys.path.insert(0, os.path.join(REPO, "tools"))

from independent_seq import write_dataset, write_video  # noqa: E402

SLAM_ROT_DEG, SLAM_TRANS_M = 0.5, 0.02


@pytest.fixture(scope="module")
def ref():
    with np.load(VIDEO_PATH) as z:
        return {k: z[k] for k in z.files}


def _poses(ref):
    return list(zip(ref["gt_R"], ref["gt_t"]))


def _asdict(c):
    return json.loads(json.dumps(dataclasses.asdict(c)))


def test_camera_files_parse_as_in_jax(tmp_path, ref):
    write_dataset(str(tmp_path), ref["frames"][:2], _poses(ref)[:2], ref["K"])
    calib = str(tmp_path / "calib.yml")
    for size in (None, (240, 180), (640, 480)):
        want = jingest.camera_from_opencv_yaml(calib, out_size=size)
        got = tingest.camera_from_opencv_yaml(calib, out_size=size)
        assert _asdict(got) == _asdict(want), size
    assert got.width == 640 and abs(got.fx - ref["K"][0, 0] * 4 / 3) < 1e-9
    slam_yml = tmp_path / "slam.yaml"
    slam_yml.write_text(
        "%YAML:1.0\n# ORB-SLAM settings\nCamera.fx: 384.5\nCamera.fy: 383.25"
        "\nCamera.cx: 240.0  # principal point\nCamera.cy: 180.5\n"
        "Camera.k1: -0.1\nCamera.p2: 0.002\nCamera.width: 480\n"
        "Camera.height: 360\nCamera.fps: 25.0\nCamera.RGB: 1\n"
        "Camera.name: cam0\n")
    want = jingest.camera_from_slam_yaml(str(slam_yml))
    got = tingest.camera_from_slam_yaml(str(slam_yml))
    assert _asdict(got) == _asdict(want)
    assert got.dist == (-0.1, 0.0, 0.0, 0.002, 0.0) and got.fps == 25.0
    bare = tmp_path / "bare.yaml"
    bare.write_text("Camera.fx: 1\nCamera.fy: 1\nCamera.cx: 0\nCamera.cy: 0\n")
    assert _asdict(tingest.camera_from_slam_yaml(str(bare))) == _asdict(
        jingest.camera_from_slam_yaml(str(bare)))
    bare.write_text("Camera.fx: 1\n")
    with pytest.raises(ValueError, match="missing"):
        tingest.camera_from_slam_yaml(str(bare))


def test_sources_yield_jax_frames(tmp_path, ref):
    frames = ref["frames"][:6]
    write_dataset(str(tmp_path), frames, _poses(ref)[:6], ref["K"])
    jcam = jingest.camera_from_opencv_yaml(str(tmp_path / "calib.yml"))
    tcam = tingest.camera_from_opencv_yaml(str(tmp_path / "calib.yml"))
    images = str(tmp_path / "images")
    times = str(tmp_path / "times.txt")
    small = dataclasses.replace(tcam, width=240, height=180)
    cases = [
        (jingest.ImageFolderSource(images, jcam, times_file=times),
         tingest.ImageFolderSource(images, tcam, times_file=times)),
        (jingest.ImageFolderSource(images, jcam),
         tingest.ImageFolderSource(images, tcam)),
        (jingest.ImageFolderSource(images, dataclasses.replace(
            jcam, width=240, height=180)),
         tingest.ImageFolderSource(images, small)),
    ]
    vid = str(tmp_path / "seq.avi")
    write_video(vid, frames)
    cases.append((jingest.VideoSource(vid, jcam),
                  tingest.VideoSource(vid, tcam)))
    for want_src, got_src in cases:
        want, got = list(want_src), list(got_src)
        assert len(got) == len(want) == 6
        for (gw, tw), (gg, tg) in zip(want, got):
            assert gg.dtype == np.uint8 and gg.shape == gw.shape
            np.testing.assert_array_equal(gg, gw)
            assert tg == tw
    # the image folder is lossless: the recorded frames come back
    np.testing.assert_array_equal(list(cases[0][1])[3][0], frames[3])
    # a color image is converted as the reference converts it
    color = np.repeat(frames[0][..., None], 3, axis=-1)
    color[..., 2] //= 2
    np.testing.assert_array_equal(
        tingest._to_gray(color, (480, 360), cv2),
        jingest._to_gray(color, (480, 360), cv2))
    with pytest.raises(FileNotFoundError):
        list(tingest.VideoSource(str(tmp_path / "missing.avi"), tcam))


def test_cv2_paths_raise_without_cv2(tmp_path, monkeypatch, ref):
    cam = CameraConfig(width=480, height=360)
    (tmp_path / "a.png").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "cv2", None)
    for fn in (lambda: list(tingest.VideoSource("x.avi", cam)),
               lambda: list(tingest.ImageFolderSource(str(tmp_path), cam)),
               lambda: tingest.camera_from_opencv_yaml("calib.yml")):
        with pytest.raises(ImportError, match="needs opencv-python"):
            fn()
    yml = tmp_path / "slam.yaml"
    yml.write_text("Camera.fx: 2\nCamera.fy: 2\nCamera.cx: 1\nCamera.cy: 1\n")
    assert tingest.camera_from_slam_yaml(str(yml)).fx == 2.0


def test_find_quads_native_equals_jax(tmp_path, monkeypatch, ref):
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector as tdet
    from test_aruco import _render_frontal

    if not jnative.available():
        pytest.skip("native library not built")
    assert tnative.available()
    _, img, _, _ = _render_frontal()
    for im, kw in ((img, dict(min_area=300.0)),
                   (ref["frames"][8].astype(np.float32), {})):
        got = tnative.find_quads_native(im, **kw)
        np.testing.assert_array_equal(got, jnative.find_quads_native(im, **kw))
    quads = tnative.find_quads_native(img, min_area=300.0)
    assert len(quads) >= 4
    qpad = np.zeros((32, 4, 2), np.float32)
    qpad[:len(quads)] = quads[:32]
    det = tdet.decode_quads(torch.as_tensor(np.asarray(img, np.float32)),
                            torch.as_tensor(qpad),
                            torch.arange(32) < len(quads), "ARUCO")
    assert {int(i) for i in det.ids if i >= 0} == {3, 17, 42, 99}
    # without the committed library the binding builds the source at first
    # use (tests/test_torch_api.py); when that build fails it says so, with
    # the compiler's error
    monkeypatch.setattr(tnative, "_LIB_PATH", str(tmp_path / "libquadfind.so"))
    broken = tmp_path / "quadfind.cpp"
    broken.write_text('#error "no quad finder here"\n')
    monkeypatch.setattr(tnative, "_SRC_PATH", str(broken))
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "build"))
    tnative._load.cache_clear()
    try:
        assert not tnative.available()
        with pytest.raises(RuntimeError,
                           match="unavailable(.|\n)*no quad finder here"):
            tnative.find_quads_native(img)
    finally:
        monkeypatch.undo()
        tnative._load.cache_clear()
    assert tnative.available()


def test_video_cli_matches_the_jax_cli(tmp_path, monkeypatch, ref):
    """The port's CLI on the CPU over the recorded frames, read back
    losslessly from an image folder (at the frame rate's timestamps, as the
    video file gave them) with the OpenCV calibration file."""
    from orb_slam2_aruco_tpu_torch.examples import mono_video
    from orb_slam2_aruco_tpu_torch.io import trajectory

    frames = ref["frames"]
    n = len(frames)
    write_dataset(str(tmp_path), frames, _poses(ref), ref["K"])
    runs = []
    real_run = mono_video.run
    monkeypatch.setattr(mono_video, "run",
                        lambda *a: runs.append(real_run(*a)) or runs[-1])
    out = str(tmp_path / "traj.tum")
    kf_out = str(tmp_path / "kf.tum")
    rc = mono_video.main(
        ["--images", str(tmp_path / "images"), "--camera",
         str(tmp_path / "calib.yml"), "--out", out, "--kf-out", kf_out,
         "--device", "cpu"] + json.loads(str(ref["args"])))
    assert rc == 0
    run, = runs
    slam = run["system"]
    assert run["frames"] == n
    state = np.full(n, -1, np.int32)
    for r in slam.get_trajectory():
        if r.frame_id < n:
            state[r.frame_id] = r.state.value
    np.testing.assert_array_equal(state, ref["state"])
    assert slam.n_keyframes == int(ref["n_kf"])
    fids, _, _, _ = slam.keyframe_trajectory()
    np.testing.assert_array_equal(fids, ref["kf_fid"])
    ok = np.asarray([p is not None for p in run["pass2"]])
    np.testing.assert_array_equal(ok, ref["pass2_ok"])
    R = np.stack([p[0] for p in run["pass2"] if p is not None])
    t = np.stack([p[1] for p in run["pass2"] if p is not None])
    for a, b, c, d in zip(R, ref["pass2_R"][ok], t, ref["pass2_t"][ok]):
        assert _rot_err_deg(a, b) <= SLAM_ROT_DEG
        assert np.linalg.norm(c - d) <= SLAM_TRANS_M
    ate = trajectory.ate_rmse(
        trajectory.camera_centers(R, t),
        trajectory.camera_centers(ref["gt_R"][ok], ref["gt_t"][ok]),
        align=True, with_scale=False)
    want = float(ref["ate"])
    assert ate <= max(1.5 * want, want + 0.005) and ate < 0.12, (ate, want)
    # the writers: pass 2's trajectory, pass 1's beside it, the keyframes
    stamps, _, _ = trajectory.load_tum(out)
    assert len(stamps) == int(ok.sum())
    assert len(trajectory.load_tum(out + ".pass1.tum")[0]) == int(
        (ref["state"] == 2).sum())
    assert len(trajectory.load_tum(kf_out)[0]) == int(ref["n_kf"])
