"""The benchmark's frozen scene: a textured marker wall, its renderer and its
own truth.

A plain copy of the port's synthetic renderer (the plane world of
`build_world` and the ray cast of `render_view`), written in PyTorch so that
set-up renders every frame on the device from the seed, and extended by the
camera's published distortion: each pixel's distorted coordinate is
inverted by fixed-point iteration, as `cv::undistortPoints` does, and the ray
through it is cast onto the plane z = 0. It imports nothing of the program.

Conventions (those of the port's io/synthetic.py): world points on the wall
have z = 0, the camera looks along +z from z < 0, the texture's rows follow
world +y, and a marker's corners c0..c3 lie at (cx - h, cy - h), (cx + h,
cy - h), (cx + h, cy + h), (cx - h, cy + h) for a marker of side 2h centred
at (cx, cy).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

# the original ArUco dictionary: 1024 ids of 5 x 5 bits, each row two bits of
# the id written as one of four 5-bit words (ArUco's classic encoding)
_ARUCO_WORDS = np.asarray([[1, 0, 0, 0, 0], [1, 0, 1, 1, 1],
                           [0, 1, 0, 0, 1], [0, 1, 1, 1, 0]], dtype=np.uint8)
UNDISTORT_ITERS = 20
MIN_ID_BITS = 3


def aruco_codes() -> np.ndarray:
    """[1024, 25] uint8: the bits of each classic ArUco id, row by row."""
    codes = np.zeros((1024, 25), dtype=np.uint8)
    for marker_id in range(1024):
        for row in range(5):
            two = (marker_id >> (2 * (4 - row))) & 0b11
            codes[marker_id, row * 5:row * 5 + 5] = _ARUCO_WORDS[two]
    return codes


def distinct_ids() -> np.ndarray:
    """The ids whose code, seen at any of its four rotations, differs in at
    least MIN_ID_BITS bits from every other id at every rotation and from
    its own other rotations: no such marker decodes as another id or
    another turn when a bit or two are read wrong."""
    codes = aruco_codes()
    rot = np.stack([np.stack([np.rot90(c.reshape(5, 5), -k).reshape(-1)
                              for k in range(4)]) for c in codes])
    flat = rot.reshape(-1, 25).astype(np.int16)
    dist = (flat[:, None, :] != flat[None, :, :]).sum(-1)
    np.fill_diagonal(dist, 99)
    nearest = dist.reshape(1024, 4, -1).min(axis=(1, 2))
    return np.flatnonzero(nearest >= MIN_ID_BITS)


@dataclasses.dataclass
class World:
    """A textured plane with square markers: the texture on its device, the
    world rectangle it covers and each marker's id and centre."""

    texture: torch.Tensor          # [Ht, Wt] float32, 0..255
    x_min: float
    y_min: float
    px_per_m: float
    ids: List[int]
    centers: np.ndarray            # [n, 2] float64 world (x, y)
    marker_size: float

    def corners(self) -> np.ndarray:
        """[n, 4, 3] float64 world corners of every marker, c0..c3."""
        h = self.marker_size / 2.0
        off = np.asarray([[-h, -h], [h, -h], [h, h], [-h, h]])
        xy = self.centers[:, None, :] + off[None]
        return np.concatenate([xy, np.zeros(xy.shape[:2] + (1,))], axis=-1)


def texture_shape(x_min, y_min, x_max, y_max, px_per_m):
    """(rows, cols) of the texture, and of its grid of 8 x 8 blocks."""
    wt = int((x_max - x_min) * px_per_m)
    ht = int((y_max - y_min) * px_per_m)
    return (ht, wt), (ht // 8 + 1, wt // 8 + 1)


def build_world(ids: Sequence[int], centers, marker_size: float, bounds,
                px_per_m: float, blocks: torch.Tensor,
                noise: torch.Tensor) -> World:
    """The wall over `bounds` = (x_min, y_min, x_max, y_max): 8 x 8 blocks of
    grey levels `blocks` (drawn uniform on 90..170) plus the per-texel
    `noise`, clipped to 60..200, then each marker pasted in: a white quiet
    zone, the black border and its bits, as the port's build_world pastes
    them."""
    x_min, y_min, x_max, y_max = bounds
    (ht, wt), _ = texture_shape(x_min, y_min, x_max, y_max, px_per_m)
    tex = blocks.repeat_interleave(8, 0).repeat_interleave(8, 1)[:ht, :wt]
    tex = torch.clamp(tex + noise, 60.0, 200.0)
    codes = aruco_codes()
    G = 5 + 2
    centers = np.asarray(centers, dtype=np.float64).reshape(-1, 2)
    for mid, (cx, cy) in zip(ids, centers):
        bits = codes[mid].reshape(5, 5)
        cxp, cyp = (cx - x_min) * px_per_m, (cy - y_min) * px_per_m
        half_px = marker_size / 2.0 * px_per_m
        quiet = int(half_px * 1.4)
        x0, y0 = int(cxp - quiet), int(cyp - quiet)
        x1, y1 = int(cxp + quiet), int(cyp + quiet)
        tex[max(0, y0):y1, max(0, x0):x1] = 255.0
        cell_px = 2.0 * half_px / G
        mx0, my0 = cxp - half_px, cyp - half_px
        for gy in range(G):
            for gx in range(G):
                border = gx == 0 or gy == 0 or gx == G - 1 or gy == G - 1
                v = 0.0 if border or not bits[gy - 1, gx - 1] else 255.0
                ax0 = int(round(mx0 + gx * cell_px))
                ax1 = int(round(mx0 + (gx + 1) * cell_px))
                ay0 = int(round(my0 + gy * cell_px))
                ay1 = int(round(my0 + (gy + 1) * cell_px))
                tex[max(0, ay0):ay1, max(0, ax0):ax1] = v
    return World(tex, x_min, y_min, px_per_m, [int(i) for i in ids],
                 centers, marker_size)


def distort(cam: dict, xn: np.ndarray) -> np.ndarray:
    """Radial-tangential distortion of normalized coordinates [..., 2]
    (float64), the camera's published model."""
    k1, k2, p1, p2, k3 = cam["dist"]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def _undistort_rays(cam: dict, device) -> torch.Tensor:
    """[H, W, 3] float32 camera rays (x, y, 1) through each pixel's centre,
    its distortion inverted by fixed-point iteration (cv::undistortPoints),
    in float64."""
    H, W = cam["height"], cam["width"]
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                          torch.arange(W, dtype=torch.float64, device=device),
                          indexing="ij")
    x0 = (u - cam["cx"]) / cam["fx"]
    y0 = (v - cam["cy"]) / cam["fy"]
    x, y = x0, y0
    k1, k2, p1, p2, k3 = cam["dist"]
    if any(cam["dist"]):
        for _ in range(UNDISTORT_ITERS):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (x0 - dx) / radial
            y = (y0 - dy) / radial
    return torch.stack([x, y, torch.ones_like(x)], dim=-1).to(torch.float32)


class Renderer:
    """Renders the world from camera poses; the pixel rays are computed once
    per camera."""

    def __init__(self, world: World, cam: dict, background: float = 128.0):
        self.world, self.cam, self.background = world, cam, background
        self.rays = _undistort_rays(cam, world.texture.device)

    def render(self, Rcw, tcw) -> torch.Tensor:
        """[H, W] float32 grey levels seen from the pose x_cam = Rcw x_world
        + tcw (the ray cast of the port's render_view)."""
        w = self.world
        dev = w.texture.device
        Rcw = torch.as_tensor(np.asarray(Rcw, np.float32), device=dev)
        tcw = torch.as_tensor(np.asarray(tcw, np.float32), device=dev)
        c = -(Rcw.T @ tcw)
        d = self.rays @ Rcw
        dz = d[..., 2]
        dz_safe = torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
        lam = -c[2] / dz_safe
        valid = (lam > 0.05) & (dz.abs() > 1e-6)
        tx = (c[0] + lam * d[..., 0] - w.x_min) * w.px_per_m
        ty = (c[1] + lam * d[..., 1] - w.y_min) * w.px_per_m
        ht, wt = w.texture.shape
        inside = valid & (tx >= 0) & (tx < wt - 1) & (ty >= 0) & (ty < ht - 1)
        tx0 = torch.clamp(torch.floor(tx), 0, wt - 2).to(torch.int64)
        ty0 = torch.clamp(torch.floor(ty), 0, ht - 2).to(torch.int64)
        fx = torch.clamp(tx - tx0, 0, 1)
        fy = torch.clamp(ty - ty0, 0, 1)
        t = w.texture
        img = (t[ty0, tx0] * (1 - fx) * (1 - fy) + t[ty0, tx0 + 1] * fx * (1 - fy)
               + t[ty0 + 1, tx0] * (1 - fx) * fy
               + t[ty0 + 1, tx0 + 1] * fx * fy)
        return torch.where(inside, img, torch.full_like(img, self.background))

    def render_u8(self, Rcw, tcw) -> torch.Tensor:
        """The frame as a camera delivers it: uint8, clipped and truncated
        as `np.clip(img, 0, 255).astype(np.uint8)`."""
        return torch.clamp(self.render(Rcw, tcw), 0, 255).to(torch.uint8)


def look_at_plane_pose(cam_xy, distance: float, yaw: float = 0.0,
                       pitch: float = 0.0, roll: float = 0.0):
    """(Rcw, tcw) float64 of a camera at (x, y, -distance), turned by
    Rz(roll) Rx(pitch) Ry(yaw) from looking straight at the wall."""
    ca, sa = np.cos(yaw), np.sin(yaw)
    ry = np.asarray([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
    cp, sp = np.cos(pitch), np.sin(pitch)
    rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    cr, sr = np.cos(roll), np.sin(roll)
    rz = np.asarray([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    Rcw = rz @ rx @ ry
    center = np.asarray([cam_xy[0], cam_xy[1], -distance], dtype=np.float64)
    return Rcw, -Rcw @ center
