"""The flagship per-frame step and the capacity-shaped global BA of the
PyTorch + CUDA port: the port of __graft_entry__.py.

    entry(device)              -> (step, example_args)
    make_gba_problem(K, L, M)  -> (BAProblem, Camera)
    dryrun_multichip(n)        -> the distributed BA's result at capacity

Imports torch, numpy and orb_slam2_aruco_tpu_torch, nothing of the JAX
package. Every function runs on the card unless it is given
device="cpu" (or, for dryrun_multichip, a list of CPU devices), and raises
without a GPU otherwise. The numpy draws are the JAX file's, in its order,
so the same seed gives the same map, image and problem.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch import require_device

# the map the flagship step tracks against: its first ENTRY_POINTS points
ENTRY_POINTS = 512
# the production global-BA problem: the flagship map's capacity
GBA_K, GBA_L, GBA_M = 256, 20000, 16
OBS_PER_CAM = 1000
DRYRUN_ITERS = 2


def _flagship_config():
    """JAX's 960x540 camera on SlamConfig()'s defaults (detect_downsample
    1: K3 at 540x960)."""
    from orb_slam2_aruco_tpu_torch.config import CameraConfig, SlamConfig

    camc = CameraConfig(
        fx=500.0, fy=500.0, cx=480.0, cy=270.0, dist=(0, 0, 0, 0, 0),
        width=960, height=540,
    )
    return SlamConfig().replace(camera=camc)


def entry(device="cuda"):
    """(step, example_args): the per-frame tracking step - ORB pyramid
    extraction + ArUco detect/decode/IPPE + BoW + map-point projection
    matching + pose LM - and its inputs: a uniform-noise 540x960 float32
    image, a capacity map holding ENTRY_POINTS random points, the identity
    pose. step(img, state, Rcw0, tcw0) -> (Rcw, tcw, n_inliers)."""
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame
    from orb_slam2_aruco_tpu_torch.worldmap.state import empty_map

    dev = require_device(device)
    cfg = _flagship_config()
    cam = camera_from_config(cfg.camera, dev)
    state = empty_map(cfg, dev)
    # a small populated map so the matching and optimization do real work
    rng = np.random.default_rng(0)
    L = ENTRY_POINTS
    pts = np.stack(
        [rng.uniform(-2, 2, L), rng.uniform(-1, 1, L), rng.uniform(2, 5, L)],
        axis=-1,
    ).astype(np.float32)
    desc = rng.integers(0, 2**32, (L, 8), dtype=np.uint32).view(np.int32)
    pt_xyz, pt_valid, pt_desc = (state.pt_xyz.clone(),
                                 state.pt_valid.clone(),
                                 state.pt_desc.clone())
    pt_xyz[:L] = torch.as_tensor(pts, device=dev)
    pt_valid[:L] = True
    pt_desc[:L] = torch.as_tensor(desc, device=dev)
    state = state._replace(pt_xyz=pt_xyz, pt_valid=pt_valid, pt_desc=pt_desc)

    def step(img, state, Rcw0, tcw0):
        frame = make_frame(img, cam, cfg)
        slots = tracking.bind_markers(state, frame)
        obs0 = torch.full((frame.kp_uv.shape[0],), -1, dtype=torch.int64,
                          device=img.device)
        tr, _ = tracking.track_local_map(state, frame, slots, Rcw0, tcw0,
                                         obs0, cam, cfg)
        return tr.Rcw, tr.tcw, tr.n_inliers

    img = torch.as_tensor(
        rng.uniform(0, 255, (cfg.camera.height, cfg.camera.width)).astype(
            np.float32), device=dev)
    example_args = (img, state,
                    torch.eye(3, dtype=torch.float32, device=dev),
                    torch.zeros(3, dtype=torch.float32, device=dev))
    return step, example_args


def _project(cam, Rcw, tcw, kf, X):
    """Pixels of world points X [E, 3] in cameras kf [E], as the JAX file
    computes them: p = R X + t, (fx p_x / z + cx, fy p_y / z + cy). XLA
    takes R X as a chain of fused multiply-adds (r0 x0, then r1 x1 + that,
    then r2 x2 + that, each rounded once); the chain is taken here in
    float64, where a float32 product is exact, and rounded to float32
    after each step, so the observations are JAX's bit for bit given the
    same poses."""
    R, Xd = Rcw[kf], X[:, None, :].double()
    p = R[..., 0] * X[:, None, 0]
    for j in (1, 2):
        p = (R[..., j].double() * Xd[..., j] + p.double()).float()
    p = p + tcw[kf]
    z = p[:, 2]
    return torch.stack([cam.fx * p[:, 0] / z + cam.cx,
                        cam.fy * p[:, 1] / z + cam.cy], dim=-1)


def make_gba_problem(K: int, L: int, M: int, seed: int = 0, device="cuda"):
    """(BAProblem, Camera): the synthetic global-BA problem at a given
    scale (the dry run's production shapes, tools/torch_scaling_bench.py):
    K cameras on a rotating, advancing path, L points of which each camera
    sees min(L, OBS_PER_CAM) at random, M markers seen at their 4 corners
    by every camera. Cameras 0 and 1 are fixed; the points start 1 cm
    off."""
    from orb_slam2_aruco_tpu_torch.config import CameraConfig
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.geometry.lie import so3_exp
    from orb_slam2_aruco_tpu_torch.optim import ba
    from orb_slam2_aruco_tpu_torch.optim.residuals import (
        marker_corner_points_world,
    )

    dev = require_device(device)
    f32, i64 = torch.float32, torch.int64
    cam = camera_from_config(
        CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                     dist=(0, 0, 0, 0, 0), width=320, height=240), dev)
    rng = np.random.default_rng(seed)
    xyz = torch.as_tensor(np.stack(
        [rng.uniform(-2, 2, L), rng.uniform(-1, 1, L), rng.uniform(3, 6, L)],
        axis=-1).astype(np.float32), device=dev)
    Rcw = so3_exp(torch.tensor([[0.02 * k, 0.05 * k, 0.0] for k in range(K)],
                               dtype=f32, device=dev))
    tcw = torch.tensor([[0.1 * k, 0.0, 0.05 * k] for k in range(K)],
                       dtype=f32, device=dev)
    # sparse observations like a real map: each camera sees obs_per_cam
    # random points (a full K x L grid would be 5M edges at capacity)
    obs_per_cam = min(L, OBS_PER_CAM)
    e_kf = torch.arange(K, device=dev).repeat_interleave(obs_per_cam)
    e_pt = torch.as_tensor(np.stack(
        [rng.permutation(L)[:obs_per_cam] for _ in range(K)]).reshape(-1),
        dtype=i64, device=dev)
    e_uv = _project(cam, Rcw, tcw, e_kf, xyz[e_pt])
    side = torch.full((M,), 0.165, dtype=f32, device=dev)
    Rwm = torch.eye(3, dtype=f32, device=dev).repeat(M, 1, 1)
    twm = torch.tensor([[m - 0.5, 0.0, 4.0] for m in range(M)], dtype=f32,
                       device=dev)
    cw = marker_corner_points_world(Rwm, twm, side).reshape(-1, 3)
    m_kf = torch.arange(K, device=dev).repeat_interleave(M * 4)
    m_uv = _project(cam, Rcw, tcw, m_kf, cw.repeat(K, 1))
    m_marker = torch.arange(M, device=dev).repeat_interleave(4).repeat(K)
    m_corner = torch.arange(4, device=dev).repeat(K * M)
    E, F = e_kf.shape[0], m_kf.shape[0]
    cam_free = torch.ones(K, dtype=f32, device=dev)
    cam_free[:2] = 0.0
    prob = ba.BAProblem(
        Rcw=Rcw, tcw=tcw, points=xyz + 0.01, Rwm=Rwm, twm=twm,
        marker_side=side, e_kf=e_kf, e_pt=e_pt, e_uv=e_uv,
        e_info=torch.ones(E, dtype=f32, device=dev),
        e_mask=torch.ones(E, dtype=f32, device=dev),
        m_kf=m_kf, m_marker=m_marker, m_corner=m_corner, m_uv=m_uv,
        m_info=torch.full((F,), 25.0, dtype=f32, device=dev),
        m_mask=torch.ones(F, dtype=f32, device=dev),
        cam_free=cam_free, pt_free=torch.ones(L, dtype=f32, device=dev),
        marker_free=torch.ones(M, dtype=f32, device=dev),
    )
    return prob, cam


INDEX_FIELDS = ("e_kf", "e_pt", "m_kf", "m_marker", "m_corner")


def problem_digest(prob) -> dict:
    """{field: (sum, sha256 hex of the int64 little-endian bytes)} of a
    BAProblem's index arrays (torch tensors on any device, or arrays of
    either package): equal digests, equal index arrays."""
    out = {}
    for f in INDEX_FIELDS:
        x = getattr(prob, f)
        a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        a = a.astype("<i8")
        out[f] = (int(a.sum()), hashlib.sha256(a.tobytes()).hexdigest())
    return out


def dryrun_multichip(n_devices: int, devices=None):
    """The distributed global BA (observation-sharded edges, partial sums
    added on the lead device, the reduced system solved by matrix-free
    PCG) at the production shapes - the flagship map capacity: K=256
    keyframes, L=20000 points, M=16 markers, 256k point edges - for
    DRYRUN_ITERS LM iterations over make_mesh(n_devices, devices): every
    CUDA device, or the given list (repeats allowed: ["cuda:0"] * n on one
    card, ["cpu"] * n on the CPU). Raises when the mesh has fewer than
    n_devices entries (a dry run asked for n shards never solves fewer) or
    the chi2 is not finite. Returns the BAResult, on the mesh's first
    device."""
    from orb_slam2_aruco_tpu_torch.parallel import dist_ba

    mesh = dist_ba.make_mesh(n_devices, devices)
    if len(mesh) < n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}): the mesh has "
                         f"{len(mesh)} entries; pass devices= to repeat one")
    prob, cam = make_gba_problem(K=GBA_K, L=GBA_L, M=GBA_M, device=mesh[0])
    out = dist_ba.distributed_ba_solve(prob, cam, mesh, iters=DRYRUN_ITERS)
    if not bool(torch.isfinite(out.chi2)):
        raise RuntimeError("distributed BA produced a non-finite chi2")
    return out
