"""Frame / map visualization as rendered images (no GUI dependency).

Port of orb_slam2_aruco_tpu/viz/framedrawer.py. It replaces FrameDrawer +
MapDrawer + Viewer (reference src/FrameDrawer.cc, src/MapDrawer.cc,
src/Viewer.cc — Pangolin/OpenCV windows): here the drawers
return numpy RGB images the caller can save or stream. Keypoint/marker
overlays mirror FrameDrawer::DrawFrame (tracked = green boxes, markers
outlined, status text as a side-channel dict); the map view is a top-down
orthographic projection of points, keyframe frusta, and marker quads
(MapDrawer::DrawMapPoints/DrawKeyFrames/DrawAruco). Everything is numpy on
the host; tensors (the map, a frame's keypoints) are read from the device
once per call, off the hot path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.worldmap.state import MapState


def host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _put_square(img, x, y, half, color):
    h, w = img.shape[:2]
    x0, x1 = max(0, x - half), min(w, x + half + 1)
    y0, y1 = max(0, y - half), min(h, y + half + 1)
    if x1 <= x0 or y1 <= y0:
        return
    img[y0:y1, x0] = color
    img[y0:y1, x1 - 1] = color
    img[y0, x0:x1] = color
    img[y1 - 1, x0:x1] = color


def _draw_line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).astype(int)
    ys = np.linspace(p0[1], p1[1], n + 1).astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def draw_frame(
    gray: np.ndarray,
    kp_uv: np.ndarray,
    kp_tracked: np.ndarray,
    mk_corners: Optional[np.ndarray] = None,
    mk_valid: Optional[np.ndarray] = None,
    mk_ids: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Dict]:
    """Current-frame overlay (FrameDrawer::DrawFrame). Returns (rgb, info)."""
    g = np.clip(host(gray), 0, 255).astype(np.uint8)
    rgb = np.stack([g, g, g], axis=-1)
    green = np.asarray([0, 255, 0], np.uint8)
    blue = np.asarray([80, 80, 255], np.uint8)
    red = np.asarray([255, 60, 60], np.uint8)
    kp = host(kp_uv)
    tracked = host(kp_tracked)
    for i in range(kp.shape[0]):
        x, y = int(kp[i, 0]), int(kp[i, 1])
        if x == 0 and y == 0:
            continue
        _put_square(rgb, x, y, 3, green if tracked[i] else blue)
    n_mk = 0
    if mk_corners is not None:
        mc = host(mk_corners)
        mv = host(mk_valid)
        for a in range(mc.shape[0]):
            if not mv[a]:
                continue
            n_mk += 1
            for c in range(4):
                _draw_line(rgb, mc[a, c], mc[a, (c + 1) % 4], red)
    info = {"n_keypoints": int((kp != 0).any(axis=1).sum()),
            "n_tracked": int(tracked.sum()), "n_markers": n_mk}
    return rgb, info


def draw_map_topdown(
    state: MapState,
    size: int = 640,
    axes=(0, 2),
) -> np.ndarray:
    """Orthographic top-down map view (MapDrawer equivalent): points (black),
    keyframes (blue squares + heading line), markers (red quads)."""
    img = np.full((size, size, 3), 255, np.uint8)
    pts = host(state.pt_xyz)[host(state.pt_valid)]
    kf_R = host(state.kf_Rcw)[host(state.kf_valid)]
    kf_t = host(state.kf_tcw)[host(state.kf_valid)]
    mk_t = host(state.mk_twm)[host(state.mk_valid)]
    centers = (
        np.einsum("kji,kj->ki", kf_R, -kf_t) if len(kf_R) else np.zeros((0, 3))
    )
    all_xy = np.concatenate(
        [pts[:, axes] if len(pts) else np.zeros((0, 2)),
         centers[:, axes] if len(centers) else np.zeros((0, 2)),
         mk_t[:, axes] if len(mk_t) else np.zeros((0, 2))], axis=0
    )
    if len(all_xy) == 0:
        return img
    lo = all_xy.min(axis=0) - 0.3
    hi = all_xy.max(axis=0) + 0.3
    scale = (size - 20) / max(float((hi - lo).max()), 1e-6)

    def to_px(xy):
        p = (xy - lo) * scale + 10
        return p.astype(int)

    for p in pts[:, axes] if len(pts) else []:
        x, y = to_px(p)
        if 0 <= x < size and 0 <= y < size:
            img[y, x] = (40, 40, 40)
    for c in centers[:, axes] if len(centers) else []:
        x, y = to_px(c)
        _put_square(img, x, y, 4, np.asarray([0, 0, 255], np.uint8))
    for m in mk_t[:, axes] if len(mk_t) else []:
        x, y = to_px(m)
        _put_square(img, x, y, 6, np.asarray([255, 0, 0], np.uint8))
    return img


def encode_png(rgb: np.ndarray) -> bytes:
    """Minimal in-memory PNG encoder (no imaging dependency)."""
    import struct
    import zlib

    h, w = rgb.shape[:2]
    raw = b"".join(
        b"\x00" + rgb[y].astype(np.uint8).tobytes() for y in range(h)
    )

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def save_png(path: str, rgb: np.ndarray) -> None:
    """Minimal PNG writer (no imaging dependency)."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
