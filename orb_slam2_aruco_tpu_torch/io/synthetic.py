"""Synthetic marker-world renderer (numpy): ground-truth frames for tests
and the on-card smoke run.

Port of orb_slam2_aruco_tpu/io/synthetic.py — the same numpy code, so a
world and a view rendered here are bit-identical to the JAX package's (the
JAX module imports its dictionary module, and through it jax, which the
card's machine does not have). Conventions (plane z = 0, texture y down,
marker corner order) are documented in the JAX module. `inject_drift`
displaces a SlamSystem's late map by a known rigid transform, the
controlled drift of the loop-closure scenes
(tests/test_pipeline.py::test_full_system_loop_closure).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from orb_slam2_aruco_tpu_torch.config import CameraConfig
from orb_slam2_aruco_tpu_torch.ops.aruco.dictionary import get_dictionary


@dataclasses.dataclass
class MarkerSpec:
    marker_id: int
    center_xy: Tuple[float, float]
    size: float


@dataclasses.dataclass
class MarkerWorld:
    texture: np.ndarray
    x_min: float
    y_min: float
    px_per_m: float
    markers: List[MarkerSpec]
    dict_name: str

    def world_to_tex(self, x, y):
        return (x - self.x_min) * self.px_per_m, (y - self.y_min) * self.px_per_m

    def marker_corners_world(self, spec: MarkerSpec) -> np.ndarray:
        cx, cy = spec.center_xy
        h = spec.size / 2.0
        return np.asarray([[cx - h, cy - h, 0.0], [cx + h, cy - h, 0.0],
                           [cx + h, cy + h, 0.0], [cx - h, cy + h, 0.0]],
                          dtype=np.float32)


def build_world(marker_ids: Sequence[int], dict_name: str = "ARUCO",
                marker_size: float = 0.165, grid_cols: int = 4,
                spacing: float = 0.5, extent_margin: float = 0.5,
                px_per_m: float = 600.0, texture_noise: float = 25.0,
                seed: int = 0) -> MarkerWorld:
    """A grid of markers on a textured plane."""
    rng = np.random.default_rng(seed)
    n = len(marker_ids)
    rows = -(-n // grid_cols)
    specs = []
    for i, mid in enumerate(marker_ids):
        r, c = divmod(i, grid_cols)
        specs.append(MarkerSpec(mid, (c * spacing, r * spacing), marker_size))
    x_min = -extent_margin
    y_min = -extent_margin
    x_max = (grid_cols - 1) * spacing + extent_margin
    y_max = (rows - 1) * spacing + extent_margin
    wt = int((x_max - x_min) * px_per_m)
    ht = int((y_max - y_min) * px_per_m)
    tex = rng.uniform(90, 170, size=(ht // 8 + 1, wt // 8 + 1)).astype(np.float32)
    tex = np.kron(tex, np.ones((8, 8), dtype=np.float32))[:ht, :wt]
    tex += rng.normal(0, texture_noise, size=tex.shape).astype(np.float32)
    tex = np.clip(tex, 60, 200)

    world = MarkerWorld(tex, x_min, y_min, px_per_m, specs, dict_name)
    d = get_dictionary(dict_name)
    G = d.grid + 2
    for spec in specs:
        bitsmat = d.bit_matrix(spec.marker_id)
        cxp, cyp = world.world_to_tex(*spec.center_xy)
        half_px = spec.size / 2.0 * px_per_m
        quiet = int(half_px * 1.4)
        x0, y0 = int(cxp - quiet), int(cyp - quiet)
        x1, y1 = int(cxp + quiet), int(cyp + quiet)
        tex[max(0, y0):y1, max(0, x0):x1] = 255.0
        cell_px = 2.0 * half_px / G
        mx0 = cxp - half_px
        my0 = cyp - half_px
        for gy in range(G):
            for gx in range(G):
                border = gx == 0 or gy == 0 or gx == G - 1 or gy == G - 1
                if border:
                    v = 0.0
                else:
                    v = 255.0 if bitsmat[gy - 1, gx - 1] else 0.0
                ax0 = int(round(mx0 + gx * cell_px))
                ax1 = int(round(mx0 + (gx + 1) * cell_px))
                ay0 = int(round(my0 + gy * cell_px))
                ay1 = int(round(my0 + (gy + 1) * cell_px))
                tex[max(0, ay0):ay1, max(0, ax0):ax1] = v
    return world


def render_view(world: MarkerWorld, cam: CameraConfig, Rcw: np.ndarray,
                tcw: np.ndarray, background: float = 128.0) -> np.ndarray:
    """Render the plane world from a camera pose (x_cam = Rcw x_world +
    tcw). Returns [H, W] float32 grayscale."""
    H, W = cam.height, cam.width
    u = np.arange(W, dtype=np.float32)
    v = np.arange(H, dtype=np.float32)
    uu, vv = np.meshgrid(u, v)
    xn = (uu - cam.cx) / cam.fx
    yn = (vv - cam.cy) / cam.fy
    d_cam = np.stack([xn, yn, np.ones_like(xn)], axis=-1)
    Rwc = Rcw.T
    c = -Rwc @ tcw
    d_world = d_cam @ Rcw
    dz = d_world[..., 2]
    dz_safe = np.where(np.abs(dz) < 1e-9, 1e-9, dz)
    lam = -c[2] / dz_safe
    valid = (lam > 0.05) & (np.abs(dz) > 1e-6)
    px = c[0] + lam * d_world[..., 0]
    py = c[1] + lam * d_world[..., 1]
    tx, ty = world.world_to_tex(px, py)
    ht, wt = world.texture.shape
    inside = valid & (tx >= 0) & (tx < wt - 1) & (ty >= 0) & (ty < ht - 1)
    tx0 = np.clip(np.floor(tx).astype(np.int32), 0, wt - 2)
    ty0 = np.clip(np.floor(ty).astype(np.int32), 0, ht - 2)
    fx = np.clip(tx - tx0, 0, 1)
    fy = np.clip(ty - ty0, 0, 1)
    t = world.texture
    img = (t[ty0, tx0] * (1 - fx) * (1 - fy) + t[ty0, tx0 + 1] * fx * (1 - fy)
           + t[ty0 + 1, tx0] * (1 - fx) * fy + t[ty0 + 1, tx0 + 1] * fx * fy)
    return np.where(inside, img, background).astype(np.float32)


def look_at_plane_pose(cam_xy: Tuple[float, float], distance: float,
                       yaw: float = 0.0, pitch: float = 0.0,
                       roll: float = 0.0):
    """Camera pose looking at the plane from z = -distance (world ->
    cam)."""

    def rx(a):
        return np.asarray([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                           [0, np.sin(a), np.cos(a)]])

    def ry(a):
        return np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                           [-np.sin(a), 0, np.cos(a)]])

    def rz(a):
        return np.asarray([[np.cos(a), -np.sin(a), 0],
                           [np.sin(a), np.cos(a), 0], [0, 0, 1]])

    Rcw = (rz(roll) @ rx(pitch) @ ry(yaw)).astype(np.float32)
    ccenter = np.asarray([cam_xy[0], cam_xy[1], -distance], dtype=np.float32)
    tcw = (-Rcw @ ccenter).astype(np.float32)
    return Rcw, tcw


def inject_drift(system, cutoff_fid: int, Rd, td):
    """Displace the map segment a SlamSystem built after frame
    `cutoff_fid`, and its tracking context, by the world transform D
    (X' = Rd X + td), as tests/test_pipeline.py's helper does on the JAX
    package's map: the points the segment's keyframes are the reference
    of and the markers only they observe move by D, the tracking context
    by Tcw' = Tcw D^-1, and the keyframes to R' = R Rd, t' = t - R' td (the
    helper turns them by Rd, not Rd^T: the segment comes out 2 angle(Rd)
    off its points, more drift to close)."""
    import torch

    st = system.map
    dev = st.kf_Rcw.device
    Rd = torch.as_tensor(np.asarray(Rd, np.float32)).to(dev)
    td = torch.as_tensor(np.asarray(td, np.float32)).to(dev)
    late_kf = st.kf_valid & (st.kf_frame_id > cutoff_fid)
    R2 = st.kf_Rcw @ Rd
    t2 = st.kf_tcw - (R2 @ td[:, None])[..., 0]
    ref = torch.clamp(st.pt_ref_kf, 0, st.K - 1)
    late_pt = st.pt_valid & (st.pt_ref_kf >= 0) & late_kf[ref]
    obs = (st.kf_mk_slot >= 0) & st.kf_mk_valid & st.kf_valid[:, None]
    M = st.M

    def observed(mask):
        hit = torch.zeros(M + 1, dtype=torch.bool, device=dev)
        return hit.index_fill_(0, torch.where(mask, st.kf_mk_slot, M)
                               .reshape(-1), True)[:M]

    late_mk = (st.mk_valid & observed(obs)
               & ~observed(obs & ~late_kf[:, None]))
    system.map = st._replace(
        kf_Rcw=torch.where(late_kf[:, None, None], R2, st.kf_Rcw),
        kf_tcw=torch.where(late_kf[:, None], t2, st.kf_tcw),
        pt_xyz=torch.where(late_pt[:, None], st.pt_xyz @ Rd.T + td,
                           st.pt_xyz),
        mk_Rwm=torch.where(late_mk[:, None, None], Rd @ st.mk_Rwm,
                           st.mk_Rwm),
        mk_twm=torch.where(late_mk[:, None], st.mk_twm @ Rd.T + td,
                           st.mk_twm))
    Rl, tl = system.last_pose
    Rl2 = Rl @ Rd.T
    system.last_pose = (Rl2, tl - Rl2 @ td)
