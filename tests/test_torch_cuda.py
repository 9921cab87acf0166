"""The hand-written CUDA kernels against their plain PyTorch versions.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere. This
file imports no jax (the GPU machine has none), so it also runs there
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The input builders here are shared with tests/test_torch_kernels.py, which
holds the plain versions to the JAX package's Pallas kernels on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.kernels import build
from orb_slam2_aruco_tpu_torch.ops import cc_fused, cc_propagate, fast, orb
from orb_slam2_aruco_tpu_torch.optim import pose_opt

torch.set_num_threads(1)    # as in test_torch_slice.py: small CPU tensors

T_HI, T_LO = 20.0, 7.0


def rendered_level():
    from orb_slam2_aruco_tpu_torch.io import synthetic
    from orb_slam2_aruco_tpu_torch.config import CameraConfig

    camc = CameraConfig(fx=300.0, fy=300.0, cx=100.0, cy=75.0,
                        width=203, height=151)
    world = synthetic.build_world([3, 17], px_per_m=700.0, spacing=0.45,
                                  grid_cols=2)
    R, t = synthetic.look_at_plane_pose((0.2, 0.0), 1.0, yaw=0.05)
    return np.clip(synthetic.render_view(world, camc, R, t), 0, 255)


def rings(rng, h, w):
    img = np.zeros((h, w), bool)
    for _ in range(6):
        s = int(rng.integers(8, 24))
        y, x = int(rng.integers(0, h - s)), int(rng.integers(0, w - s))
        img[y:y + s, x:x + s] = True
        img[y + 2:y + s - 2, x + 2:x + s - 2] = False
    return img


def spiral(n=64):
    """A 1-px square spiral: its label has to turn ~30 corners, far more
    than 3 rounds of the fixed-round algorithm can carry."""
    img = np.zeros((n, n), bool)
    y = x = n // 2
    dy, dx = 0, 1
    step = 2
    while True:
        for _ in range(2):
            for _ in range(step):
                if not (0 <= y < n and 0 <= x < n):
                    return img
                img[y, x] = True
                y, x = y + dy, x + dx
            dy, dx = dx, -dy
        step += 2


def init_labels(binary):
    """K4's input: flat index on foreground, the sentinel H*W elsewhere."""
    h, w = binary.shape
    return np.where(binary, np.arange(h * w).reshape(h, w),
                    h * w).astype(np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode (chip_smoke.py runs them)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fast_cuda_matches_plain(cuda_device):
    img = torch.as_tensor(rendered_level().astype(np.float32),
                          device=cuda_device)
    got = fast.fast_score_nms_cuda(img, T_HI, T_LO)     # the L = 1 launch
    want = fast.fast_score_nms_torch(img, T_HI, T_LO)
    assert torch.equal(got[3:-3, 3:-3], want[3:-3, 3:-3])


@pytest.mark.cuda
@pytest.mark.parametrize("thresholds", [(T_HI, T_LO), (5.0, 12.0)])
def test_fast_levels_cuda_matches_plain(cuda_device, thresholds):
    """One launch for the bench's 8 levels, with t_hi above and below t_lo,
    equal to the plain version in every level's interior."""
    levels = bench_pyramid(cuda_device)
    kernels.reset_launch_counts()
    got = fast.fast_score_nms_levels(levels, *thresholds)
    assert kernels.launch_counts["fast"] == 1
    found = 0
    for lvl, g in zip(levels, got):
        want = fast.fast_score_nms_torch(lvl, *thresholds)
        assert torch.equal(g[3:-3, 3:-3], want[3:-3, 3:-3])
        found += int((g > 1e6).sum())
    assert found > 0                                # bonus corners too


@pytest.mark.cuda
def test_fast_levels_cuda_tiny_levels_are_zero(cuda_device):
    """Levels narrower or shorter than 7 px have no pixel inside the 3-px
    border: all zeros, in one launch with a normal level, and no fault."""
    rng = np.random.default_rng(12)
    shapes = [(40, 70), (5, 40), (40, 6), (1, 1), (6, 6), (7, 7)]
    levels = [torch.as_tensor(rng.uniform(0, 255, s).astype(np.float32),
                              device=cuda_device) for s in shapes]
    got = fast.fast_score_nms_levels(levels, T_HI, T_LO)
    torch.cuda.synchronize()
    assert [tuple(g.shape) for g in got] == shapes
    assert torch.equal(got[0][3:-3, 3:-3], fast.fast_score_nms_torch(
        levels[0], T_HI, T_LO)[3:-3, 3:-3])
    for g in got[1:-1]:
        assert not g.any()
    assert torch.equal(got[-1], fast.fast_score_nms_torch(levels[-1], T_HI,
                                                          T_LO))


@pytest.mark.cuda
def test_patches_cuda_matches_plain(cuda_device):
    rng = np.random.default_rng(5)
    img = torch.as_tensor(rng.uniform(0, 255, (123, 217)).astype(np.float32),
                          device=cuda_device)
    y0 = torch.as_tensor(rng.integers(0, 91, 50).astype(np.int32),
                         device=cuda_device)
    x0 = torch.as_tensor(rng.integers(0, 185, 50).astype(np.int32),
                         device=cuda_device)
    assert torch.equal(orb.extract_patches_cuda(img, y0, x0),
                       orb.extract_patches_torch(img, y0, x0))


def bench_pyramid(device):
    """The bench's 8 pyramid levels of a rendered 960x540 frame (widths
    960, 800, 667, 556, ...)."""
    from orb_slam2_aruco_tpu_torch.config import CameraConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic
    from orb_slam2_aruco_tpu_torch.ops import image

    world = synthetic.build_world([3, 17, 42, 99], px_per_m=500.0,
                                  spacing=0.6)
    R, t = synthetic.look_at_plane_pose((0.6, 0.3), 1.6, yaw=0.05)
    frame = np.clip(synthetic.render_view(world, CameraConfig(), R, t),
                    0, 255).astype(np.float32)
    return image.build_pyramid(torch.as_tensor(frame, device=device), 8, 1.2)


def bench_levels(device):
    """The bench's 8 pyramid levels, blurred, and their FAST keypoints at
    the bench's quotas (1000 features)."""
    from orb_slam2_aruco_tpu_torch.ops import image
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import level_quotas

    blurred, xys = [], []
    for lvl, q in zip(bench_pyramid(device), level_quotas(1000, 8, 1.2)):
        kp = fast.detect_level(lvl, T_HI, T_LO, 32, 8, q, 16)
        blurred.append(image.gaussian_blur(lvl))
        xys.append(kp.xy)
    return blurred, xys


@pytest.mark.cuda
def test_patches_levels_cuda_matches_plain(cuda_device):
    blurred, xys = bench_levels(cuda_device)
    assert [l.shape[1] for l in blurred][:3] == [960, 800, 667]
    # keypoints on .5 steps and past every edge, on the card's rounding
    h, w = blurred[2].shape
    odd = torch.tensor([[16.5, 17.5], [17.5, 16.5], [-30.0, 5.5],
                        [w + 30.0, h - 15.5], [w - 16.5, h + 30.0],
                        [2.5, -7.0]], device=cuda_device)
    xys[2] = torch.cat([xys[2], odd])
    kernels.reset_launch_counts()
    got = orb.extract_patches_levels(blurred, xys)
    assert kernels.launch_counts["patches"] == 1
    assert torch.equal(got, orb.extract_patches_levels_torch(blurred, xys))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["marker_rings", "spiral", "rings_540x960",
                                  "random_61x133"])
def test_cc_cuda_matches_plain(cuda_device, case):
    rng = np.random.default_rng(6)
    if case == "marker_rings":
        binary = rings(rng, 270, 480)
    elif case == "rings_540x960":
        binary = rings(rng, 540, 960)
    elif case == "random_61x133":                   # padded to 64x256
        binary = rng.uniform(size=(61, 133)) < 0.45
    else:
        binary = spiral()                           # does not converge
    binary = torch.as_tensor(binary, device=cuda_device)
    got = cc_fused.cc_fused_cuda(binary)
    want = cc_fused.cc_fused_torch(binary)
    assert got[3] == want[3]
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("prop_steps", [1, 2, 3])
def test_cc_cuda_prop_steps_match_plain(cuda_device, prop_steps):
    rng = np.random.default_rng(9)
    binary = rng.uniform(size=(270, 480)) < 0.45
    binary[:64, :64] = spiral()
    binary = torch.as_tensor(binary, device=cuda_device)
    for rounds in (1, 3):
        got = cc_fused.cc_fused_cuda(binary, rounds, prop_steps)
        want = cc_fused.cc_fused_torch(binary, rounds, prop_steps)
        assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    with pytest.raises(ValueError, match="shared memory"):
        cc_fused.cc_fused_cuda(binary, 3, 30)


@pytest.mark.cuda
@pytest.mark.parametrize("k_steps", [8, 16])
@pytest.mark.parametrize("shape", [(270, 480), (540, 960), (61, 133)])
@pytest.mark.parametrize("case", ["random", "spiral", "marker_rings"])
def test_cc_propagate_cuda_matches_plain(cuda_device, case, shape, k_steps):
    """The clustered kernel (8 CTAs per 128-px tile, no padded copy) on
    tile multiples and ragged shapes, after 1 and 3 sweeps."""
    rng = np.random.default_rng(7)
    h, w = shape
    if case == "random":
        binary = rng.uniform(size=shape) < 0.45
    elif case == "spiral":
        binary = np.zeros(shape, bool)
        n = min(h, w, 200)
        binary[:n, :n] = spiral(n)
    else:
        binary = rings(rng, h, w)
    labels = torch.as_tensor(init_labels(binary), device=cuda_device)
    for passes in (1, 3):
        got = cc_propagate.cc_propagate_cuda(labels, passes, k_steps, 128)
        want = cc_propagate.cc_propagate_torch(labels, passes, k_steps, 128)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cc_propagate_raises_without_its_library(cuda_device, monkeypatch):
    """On a CUDA tensor the dispatcher launches the kernel or raises; it
    never falls back to the plain version."""
    def missing(name):
        raise RuntimeError(f"CUDA kernel build failed: {name}")

    monkeypatch.setattr(build, "launcher", missing)
    labels = torch.as_tensor(init_labels(spiral(64)), device=cuda_device)
    with pytest.raises(RuntimeError, match="build failed"):
        cc_propagate.cc_propagate(labels, 1, 16, 128)


@pytest.mark.cuda
def test_each_cuda_launch_is_counted_once(cuda_device):
    img = torch.rand((64, 160), device=cuda_device) * 255
    kernels.reset_launch_counts()
    levels = [img, img[:, :80].contiguous()] * 4
    fast.fast_score_nms_levels(levels, T_HI, T_LO)   # 8 levels, one launch
    xy = torch.tensor([[40.0, 30.0]], device=cuda_device)
    orb.extract_patches_levels(levels, [xy] * 8)     # 8 levels, one launch
    cc_fused.cc_fused(img > 128)
    labels = torch.as_tensor(init_labels(spiral(64)), device=cuda_device)
    cc_propagate.cc_propagate(labels, 3, 16, 128)    # one launch per sweep
    from test_torch_pose_lm_kernel import pose_problem
    pose_opt.optimize_pose(**pose_problem(1, n=64, a=4,
                                          device=cuda_device))  # one launch
    fast.fast_score_nms_torch(img, T_HI, T_LO)       # plain: not counted
    assert kernels.launch_counts == {"fast": 1, "patches": 1, "cc_fused": 1,
                                     "cc_propagate": 3, "pose_lm": 1}


@pytest.mark.cuda
def test_chunk_makes_no_hidden_synchronizing_call(cuda_device):
    """One 16-frame chunk of the small configuration in the serving form
    (extrapolate seeds, one pass: track_batch without a host read), under
    torch's sync debug mode, makes at most chip_smoke.MAX_DEBUG_SYNCS
    synchronizing calls: the chunk's one control read."""
    import dataclasses
    import json
    import os

    import chip_smoke
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic
    from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "orb_slam2_aruco_tpu_torch", "data",
        "ref_small.npz")
    with np.load(path) as z:
        cfg = SlamConfig.from_dict(json.loads(str(z["ref_cfg"])))
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, loc_seed_mode="extrapolate", loc_extrap_passes=1))
        w = json.loads(str(z["ref_world"]))
        params = z["ref_loc_params"]
    world = synthetic.build_world(
        w["marker_ids"], dict_name=cfg.aruco.dictionary,
        marker_size=w["marker_size"], grid_cols=w["grid_cols"],
        spacing=w["spacing"], px_per_m=w["px_per_m"])
    imgs = []
    for x, y, d, yaw, pitch in params:
        R, t = synthetic.look_at_plane_pose((x, y), d, yaw=yaw, pitch=pitch)
        imgs.append(np.clip(synthetic.render_view(world, cfg.camera, R, t),
                            0, 255).astype(np.uint8))
    system = SlamSystem(cfg, device=cuda_device)
    system.load_map(path)
    system.track_monocular(imgs[0], ts=0.0)
    frames = [(imgs[k % len(imgs)], 1.0 + k / 30.0) for k in range(16)]
    for _ in system.localize_stream(StagedSource(frames, batch=16,
                                                 device=cuda_device),
                                    chunk=16):
        pass                                  # warm: builds, caches
    src = StagedSource(frames, batch=16, device=cuda_device)
    out = []
    n, where = chip_smoke.port_sync_calls(
        lambda: out.extend(system.localize_stream(src, chunk=16)))
    assert len(out) == 16 and system.stats["rewinds"] == 0
    assert n <= chip_smoke.MAX_DEBUG_SYNCS, where


@pytest.mark.cuda
def test_threefry_draws_on_the_card_equal_the_cpu_draws(cuda_device):
    """utils/threefry's draws (held bit for bit to jax.random on the CPU in
    test_torch_slam.py) give the same bits on the card, and the classic
    initializer's choice draw makes no synchronizing call there."""
    import chip_smoke
    from orb_slam2_aruco_tpu_torch.utils import threefry

    key = threefry.fold_in(threefry.PRNGKey(17), 5)
    torch.testing.assert_close(
        threefry.uniform(key, (7, 64, 5), cuda_device).cpu(),
        threefry.uniform(key, (7, 64, 5), "cpu"), rtol=0, atol=0)
    rng = np.random.default_rng(3)
    mask = torch.as_tensor(rng.random((16, 1, 1000)) < 0.05)
    mask[3] = True
    want = threefry.categorical_masked_argmax(key, mask, (16, 16, 5))
    got = threefry.categorical_masked_argmax(key, mask.to(cuda_device),
                                             (16, 16, 5))
    assert torch.equal(got.cpu(), want)
    m = torch.as_tensor((rng.random(1000) < 0.4).astype(np.float32))
    p = m / torch.clamp(m.sum(), min=1.0)
    want = threefry.choice_p(threefry.PRNGKey(0), (128, 8), p)
    pd = p.to(cuda_device)
    threefry.choice_p(threefry.PRNGKey(0), (128, 8), pd)    # warm
    out = []
    n, where = chip_smoke.port_sync_calls(lambda: out.append(
        threefry.choice_p(threefry.PRNGKey(0), (128, 8), pd)))
    assert torch.equal(out[0].cpu(), want)
    assert n == 0, where


@pytest.mark.cuda
def test_pnp_draws_and_ransac_on_the_card(cuda_device):
    """ransac_pnp's choice draw at the full configuration's keypoint count
    (N = 1000) gives the CPU's indices on the card, ransac_pnp the CPU's
    pose, and its only synchronizing calls are its four batched SVDs (two
    each on the card) and one eigh: cuSOLVER's error codes, read on the
    host (no _ex form)."""
    import chip_smoke
    from orb_slam2_aruco_tpu_torch.geometry import camera as tcam_
    from orb_slam2_aruco_tpu_torch.optim import pnp
    from orb_slam2_aruco_tpu_torch.utils import threefry

    rng = np.random.default_rng(11)
    n = 1000
    m = torch.as_tensor((rng.random(n) < 0.6).astype(np.float32))
    p = m / torch.clamp(m.sum(), min=1.0)
    want = threefry.choice_p(threefry.PRNGKey(0), (256, 6), p)
    got = threefry.choice_p(threefry.PRNGKey(0), (256, 6), p.to(cuda_device))
    assert torch.equal(got.cpu(), want)
    # a planar scene with outliers, as relocalization against a wall sees
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    np.full(n, 5.0)], -1).astype(np.float32)
    pc = xyz + np.asarray([0.3, -0.2, 0.4], np.float32)
    uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 480,
                   500 * pc[:, 1] / pc[:, 2] + 270], -1).astype(np.float32)
    uv[:200] += rng.uniform(25, 60, size=(200, 2)).astype(np.float32)
    cam = tcam_.camera_from_numpy(dict(fx=500.0, fy=500.0, cx=480.0,
                                       cy=270.0, width=960, height=540,
                                       dist=np.zeros(5, np.float32)))
    args = [torch.as_tensor(a) for a in (xyz, uv, m)]
    want = pnp.ransac_pnp(*args, cam)
    camd = tcam_.camera_from_numpy(dict(cam._asdict()), cuda_device)
    argsd = [a.to(cuda_device) for a in args]
    pnp.ransac_pnp(*argsd, camd)                                 # warm
    out = []
    calls, where = chip_smoke.port_sync_calls(
        lambda: out.append(pnp.ransac_pnp(*argsd, camd)))
    got = out[0]
    assert int(got.n_inliers) == int(want.n_inliers)
    torch.testing.assert_close(got.Rcw.cpu(), want.Rcw, rtol=0, atol=1e-4)
    import linecache

    assert calls <= 9, where
    for (f, line), _ in where.items():
        assert os.path.basename(f) == "pnp.py", where
        code = linecache.getline(f, line)
        assert "linalg.svd" in code or "linalg.eigh" in code, (line, code)


def _pipe_small(device):
    """(depth-2 SlamConfig, the shifted scene's uint8 frames, ref_pipe_*
    arrays without the prefix) of ref_small's pipelined recording, without
    jax (tests/test_torch_slice.py --pipe)."""
    import json
    import os

    import chip_smoke
    from orb_slam2_aruco_tpu_torch.config import SlamConfig

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "orb_slam2_aruco_tpu_torch", "data",
        "ref_small.npz")
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    cfg = SlamConfig.from_dict(json.loads(str(ref["ref_pipe_cfg"])))
    imgs = chip_smoke.render(cfg, ref, "ref_pipe_params")
    return cfg, imgs, {k[len("ref_pipe_"):]: v for k, v in ref.items()
                       if k.startswith("ref_pipe_")}


@pytest.mark.cuda
def test_pipelined_slam_on_the_card_matches_jax(cuda_device):
    """SLAM mode at pipeline_depth 2 on the card over the small shifted
    scene: per-frame states, the frames that created keyframes, and poses
    of the trajectory records within 0.5 deg / 2 cm of the JAX run."""
    from unittest import mock

    import chip_smoke
    from orb_slam2_aruco_tpu_torch.pipeline import mapping
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    cfg, imgs, ref = _pipe_small(cuda_device)
    assert cfg.tracking.pipeline_depth == 2
    created = []
    real = mapping.create_keyframe

    def create(*a, **kw):
        created.append(int(a[6]))
        return real(*a, **kw)

    system = SlamSystem(cfg, device=cuda_device)
    with mock.patch.object(mapping, "create_keyframe", create):
        for j, img in enumerate(imgs):
            system.track_monocular(img, ts=j / 30.0)
        system.flush()
    recs = system.get_trajectory()
    assert [r.frame_id for r in recs] == ref["fid"].tolist()
    assert [r.state.value for r in recs] == ref["state"].tolist()
    assert created == ref["inserts"].tolist()
    poses = [(r.Rcw, r.tcw) if r.state.value == 2 else None for r in recs]
    rot, trans = chip_smoke.pose_errors(poses, ref["R"], ref["t"])
    assert rot <= chip_smoke.SLAM_ROT_TOL_DEG, rot
    assert trans <= chip_smoke.SLAM_TRANS_TOL_M, trans


@pytest.mark.cuda
def test_pipelined_frame_dispatch_makes_no_hidden_synchronizing_call(
        cuda_device):
    """In the sync debug mode, a steady-state track_monocular call at depth
    2 that reads a frame which is not a keyframe makes only the newest
    frame's two cascade branch reads (host_sync) and the oldest frame's
    control read (tracking.HostCopy, an event wait the debug mode may not
    report): nothing else stalls the host."""
    import linecache

    import chip_smoke
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    cfg, imgs, ref = _pipe_small(cuda_device)
    system = SlamSystem(cfg, device=cuda_device)
    for j in range(7):              # initialized at frame 4; 5, 6 in flight
        system.track_monocular(imgs[j], ts=j / 30.0)
    assert [p[0] for p in system._pending] == [5, 6]
    for j in (7, 8):               # these calls read frames 5 and 6
        before = (system.stats["kf_inserted"], tracking.SYNCS["count"])
        n, where = chip_smoke.port_sync_calls(
            lambda: system.track_monocular(imgs[j], ts=j / 30.0))
        assert system.stats["kf_inserted"] == before[0]
        assert not system._map_phase
        assert tracking.SYNCS["count"] - before[1] == 3
        assert 2 <= n <= 3, where
        for (f, line), _ in where.items():
            code = linecache.getline(f, line)
            assert os.path.basename(f) == "tracking.py", where
            assert "bool(x)" in code or "synchronize()" in code, code


def _ref_map(name, device):
    import json

    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.worldmap.state import (
        MapState,
        state_from_numpy,
    )

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "orb_slam2_aruco_tpu_torch", "data",
        f"ref_{name}.npz")
    with np.load(path) as z:
        arrays = {f: z[f] for f in MapState._fields}
        cfg = SlamConfig.from_dict(json.loads(str(z["ref_cfg"])))
    return cfg, state_from_numpy(arrays, device), arrays


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_distributed_ba_on_the_card(cuda_device, solver):
    """The sharded solve over lists of cuda:0 against ba_solve on the card
    and the 8-shard CPU solve: a 1-entry list bit for bit (deterministic
    algorithms), 2 / 4 / 8 entries within JAX's distributed-vs-single
    limits (R 2e-4, t 2e-3, points 5e-3), edge_chi2 in the caller's
    order; and bundle_adjust_distributed on ref_small's map."""
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.optim import ba
    from orb_slam2_aruco_tpu_torch.parallel import dist_ba
    from orb_slam2_aruco_tpu_torch.pipeline import mapping

    cfg, state, arrays = _ref_map("small", cuda_device)
    cpu_cfg, cpu_state, _ = _ref_map("small", "cpu")
    cam = camera_from_config(cfg.camera, cuda_device)
    valid = np.flatnonzero(arrays["kf_valid"])
    k = int(valid[np.argmax(arrays["kf_frame_id"][valid])])
    prob = mapping.build_ba_problem(state, k, cfg, max_cams=16, max_pts=2048,
                                    window_all=True)[0]
    kw = dict(iters=4, solver=solver, huber_delta=cfg.optim.huber_delta,
              lam0=cfg.optim.lm_lambda_init)
    single = ba.ba_solve(prob, cam, **kw)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = ba.ba_solve(prob, cam, **kw)
        one = ba.ba_solve(prob, cam, mesh=[torch.device("cuda", 0)], **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(one, det):
        assert torch.equal(a, b)
    cpu_prob = mapping.build_ba_problem(cpu_state, k, cpu_cfg, max_cams=16,
                                        max_pts=2048, window_all=True)[0]
    cpu8 = ba.ba_solve(*dist_ba.partition_edges_by_point(cpu_prob, 8)[:1],
                       camera_from_config(cfg.camera), mesh=["cpu"] * 8,
                       **kw)
    for n in (2, 4, 8):
        mesh = dist_ba.make_mesh(devices=["cuda"] * n)
        assert mesh == [torch.device("cuda", 0)] * n
        part, scatter = dist_ba.partition_edges_by_point(prob, n)
        out = ba.ba_solve(dist_ba.pad_edges_to(part, n), cam, mesh=mesh,
                          **kw)
        for got, want in ((out, single), (out, cpu8)):
            np.testing.assert_allclose(got.Rcw.cpu(), want.Rcw.cpu(),
                                       atol=2e-4)
            np.testing.assert_allclose(got.tcw.cpu(), want.tcw.cpu(),
                                       atol=2e-3)
            np.testing.assert_allclose(got.points.cpu(), want.points.cpu(),
                                       atol=5e-3)
    if solver == "dense":
        mesh = dist_ba.make_mesh(devices=["cuda:0"] * 4)
        st, chi = mapping.bundle_adjust_distributed(
            state, k, cam, cfg, mesh, max_cams=16, max_pts=2048, iters=4)
        st1, chi1 = mapping.bundle_adjust(state, k, cam, cfg, max_cams=16,
                                          max_pts=2048, iters=4,
                                          window_all=True)
        np.testing.assert_allclose(float(chi), float(chi1), rtol=1e-3)
        # the result is written into the map: the map's device leads
        with pytest.raises(ValueError, match="lead device"):
            mapping.bundle_adjust_distributed(
                state, k, cam, cfg, ["cpu"] + mesh, max_cams=16,
                max_pts=2048, iters=1)
        np.testing.assert_allclose(st.kf_tcw.cpu(), st1.kf_tcw.cpu(),
                                   atol=2e-3)
        np.testing.assert_allclose(st.pt_xyz.cpu(), st1.pt_xyz.cpu(),
                                   atol=5e-3)
        out = dist_ba.distributed_ba_solve(prob, cam, mesh, iters=4)
        c_e = ba._total_chi2(prob._replace(
            Rcw=out.Rcw, tcw=out.tcw, points=out.points, Rwm=out.Rwm,
            twm=out.twm), cam)[1]
        torch.testing.assert_close(out.edge_chi2, c_e, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_viewer_reads_a_map_on_the_card(cuda_device):
    """snapshot_map and the map view of a map on the card equal those of
    its CPU copy, and the HTTP viewer serves it."""
    import json
    import urllib.request

    from orb_slam2_aruco_tpu_torch.viz import framedrawer, viewer

    _, state, _ = _ref_map("full", cuda_device)
    _, cpu_state, _ = _ref_map("full", "cpu")
    want = viewer.snapshot_map(cpu_state)
    assert json.dumps(viewer.snapshot_map(state)) == json.dumps(want)
    np.testing.assert_array_equal(framedrawer.draw_map_topdown(state),
                                  framedrawer.draw_map_topdown(cpu_state))
    v = viewer.MapViewer(port=0)
    try:
        v.update(map_state=state, cam_Rcw=state.kf_Rcw[0],
                 cam_tcw=state.kf_tcw[0], status="state: OK")
        st = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{v.port}/state", timeout=10).read())
        assert st["map"] == json.loads(json.dumps(want))
        assert st["cam"] is not None
    finally:
        v.close()
