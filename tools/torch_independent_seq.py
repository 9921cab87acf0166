"""Independently-rendered ArUco validation sequences: the port of
tools/independent_seq.py, on orb_slam2_aruco_tpu_torch's dictionaries and
trajectory writer.

Renders a marker-wall fly-by using ONLY OpenCV + NumPy math — marker bitmaps
from cv2.aruco.generateImageMarker, projection via cv2.warpPerspective with a
plane homography H = K [r1 r2 t] S — i.e. a completely separate code path
from orb_slam2_aruco_tpu_torch.io.synthetic (different renderer, different
marker rasterizer, different interpolation). Adds sensor noise, motion
blur, an exposure ramp and off-plane tilt. Needs cv2 (opencv-python): every
function raises its ImportError without it.

Usage as a library (tests) or CLI:
  python tools/torch_independent_seq.py --out DIR --frames 30
then:
  python -m orb_slam2_aruco_tpu_torch.examples.mono_video \
      --images DIR/images --camera DIR/calib.yml --out DIR/indep.tum
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _cv2_dictionary(dict_name):
    """cv2.aruco dictionary for the renderer. Predefined cv2 names pass
    through; "ARUCO_MIP_25h7" (no cv2 predefined equivalent — the samsung7
    dictionary, reference README.md:12) builds a custom cv2.aruco.Dictionary
    from the port's code table, so the RENDERER is still OpenCV's
    independent generateImageMarker path."""
    import cv2.aruco as ar

    if dict_name == "ARUCO_MIP_25h7":
        from orb_slam2_aruco_tpu_torch.ops.aruco import dictionary as dct

        d = dct.get_dictionary("ARUCO_MIP_25h7")
        bits = np.stack([c.reshape(5, 5).astype(np.uint8) for c in d.codes])
        byte_list = np.stack(
            [ar.Dictionary.getByteListFromBits(b)[0] for b in bits]
        )
        return ar.Dictionary(byte_list, 5)
    return ar.getPredefinedDictionary(getattr(ar, dict_name))


def write_video(path, frames, fps=30.0):
    """Encode frames to a video file (MJPG avi — the codec every cv2 build
    ships) for the mono_cvcam-style --video entry point."""
    import cv2

    h, w = frames[0].shape
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h),
                         isColor=False)
    if not vw.isOpened():
        raise RuntimeError(f"VideoWriter failed for {path}")
    for f in frames:
        vw.write(f)
    vw.release()


def build_wall(ids, marker_px=120, gap_px=60, dict_name="DICT_ARUCO_ORIGINAL",
               seed=0, cols=4):
    """Wall texture image [Hw, Ww] uint8 with markers pasted on a noise
    background, plus each marker's center in wall pixels."""
    import cv2.aruco as ar

    rng = np.random.default_rng(seed)
    rows = (len(ids) + cols - 1) // cols
    cell = marker_px + gap_px
    H = rows * cell + gap_px
    W = cols * cell + gap_px
    wall = (rng.uniform(90, 200, size=(H, W))).astype(np.uint8)
    # low-frequency texture so FAST finds corners everywhere
    import cv2

    tex = cv2.resize(
        rng.uniform(0, 255, size=(H // 12, W // 12)).astype(np.uint8), (W, H),
        interpolation=cv2.INTER_CUBIC,
    )
    wall = (0.55 * wall + 0.45 * tex).astype(np.uint8)
    d = _cv2_dictionary(dict_name)
    centers = {}
    for k, mid in enumerate(ids):
        r, c = divmod(k, cols)
        y0 = gap_px + r * cell
        x0 = gap_px + c * cell
        m = ar.generateImageMarker(d, mid, marker_px)
        # thin white quiet zone (printed-marker convention)
        q = marker_px // 15
        wall[y0 - q : y0 + marker_px + q, x0 - q : x0 + marker_px + q] = 255
        wall[y0 : y0 + marker_px, x0 : x0 + marker_px] = m
        centers[mid] = (x0 + marker_px / 2.0, y0 + marker_px / 2.0)
    return wall, centers


def render_sequence(n_frames=30, width=640, height=480, marker_size=0.165,
                    marker_px=120, ids=(3, 17, 42, 99, 7, 23, 55, 88),
                    dict_name="DICT_ARUCO_ORIGINAL", noise_sigma=4.0,
                    blur_px=1, exposure_ramp=0.25, tilt=0.06, seed=0):
    """Returns (frames [n][H,W] uint8, poses [(Rcw, tcw)], K, meters_per_px).

    World frame: wall plane z=0, x right, y down (wall pixel axes scaled to
    meters). Camera looks at the wall from z = -standoff, panning in x.
    """
    import cv2

    wall, _ = build_wall(ids, marker_px=marker_px, dict_name=dict_name,
                         seed=seed)
    mpp = marker_size / marker_px               # meters per wall pixel
    Hw, Ww = wall.shape
    fx = fy = 0.8 * width
    cx, cy = width / 2.0, height / 2.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    S = np.array([[mpp, 0, 0], [0, mpp, 0], [0, 0, 1.0]])  # wallpx -> meters

    standoff = 14.0 * marker_size
    x_span = (Ww * mpp) * 0.35
    x0 = Ww * mpp * 0.3
    y_look = Hw * mpp * 0.45
    rng = np.random.default_rng(seed + 1)
    frames, poses = [], []
    for i in range(n_frames):
        t01 = i / max(n_frames - 1, 1)
        cam_x = x0 + x_span * t01
        yaw = tilt * np.sin(2 * np.pi * t01)
        pitch = 0.5 * tilt * np.cos(2 * np.pi * t01)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        Rcw = Rx @ Ry
        cam_center = np.array([cam_x, y_look, -standoff])
        tcw = -Rcw @ cam_center
        # plane z=0: pixel = K [r1 r2 t] [X Y 1]^T, wall px -> world via S
        Hmat = K @ np.column_stack([Rcw[:, 0], Rcw[:, 1], tcw]) @ S
        view = cv2.warpPerspective(
            wall, Hmat, (width, height), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=140,
        ).astype(np.float32)
        if blur_px > 0:
            k = 2 * blur_px + 1
            view = cv2.GaussianBlur(view, (k, k), 0.8 * blur_px)
        gain = 1.0 + exposure_ramp * np.sin(np.pi * t01)
        view = view * gain + rng.normal(0, noise_sigma, view.shape)
        frames.append(np.clip(view, 0, 255).astype(np.uint8))
        poses.append((Rcw.astype(np.float32), tcw.astype(np.float32)))
    return frames, poses, K, mpp


def write_dataset(out_dir, frames, poses, K, fps=30.0):
    """images/ + times.txt (reference LoadImages convention) + calib.yml +
    gt.tum ground truth."""
    import cv2

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    stems = []
    h, w = frames[0].shape
    for i, f in enumerate(frames):
        stem = f"{int(i / fps * 1e6):010d}"
        cv2.imwrite(os.path.join(img_dir, stem + ".png"), f)
        stems.append(stem)
    with open(os.path.join(out_dir, "times.txt"), "w") as fo:
        fo.write("\n".join(stems) + "\n")
    fs = cv2.FileStorage(os.path.join(out_dir, "calib.yml"),
                         cv2.FILE_STORAGE_WRITE)
    fs.write("camera_matrix", K)
    fs.write("distortion_coefficients", np.zeros((1, 5)))
    fs.write("image_width", w)
    fs.write("image_height", h)
    fs.release()
    from orb_slam2_aruco_tpu_torch.io import trajectory

    trajectory.save_tum(
        os.path.join(out_dir, "gt.tum"),
        [i / fps for i in range(len(poses))],
        [p[0] for p in poses], [p[1] for p in poses],
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--noise", type=float, default=4.0)
    args = ap.parse_args()
    frames, poses, K, _ = render_sequence(
        n_frames=args.frames, width=args.width, height=args.height,
        noise_sigma=args.noise,
    )
    write_dataset(args.out, frames, poses, K)
    print(f"wrote {len(frames)} frames -> {args.out}")


if __name__ == "__main__":
    main()
