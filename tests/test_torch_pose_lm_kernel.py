"""Kernel K5 (kernels/csrc/pose_lm.cu, optim/pose_opt.optimize_pose_cuda)
against the plain PyTorch LM (optim/pose_opt.optimize_pose_torch).

The tests marked `cuda` need an NVIDIA GPU and nvcc, and skip elsewhere;
they hold the kernel to the plain version on the same CUDA inputs. This
file imports no jax, so on the GPU machine it runs without the suite's
conftest:

    python -m pytest tests/test_torch_pose_lm_kernel.py --noconftest -q

The kernel sums in another order than the plain version and solves the
damped system by the JAX package's Cholesky where the plain version takes
an LU solve. Near its stopping point an LM in float32 lands on poses that
such rounding moves by up to ~1e-4 m: the plain version itself moves that
far when its start pose moves by one ulp. So a pose is held to 1e-4 rad /
1e-5 m of the plain one, or, where the plain version's own spread on the
problem is wider, to twice that spread (its witness: the plain LM from six
start poses one float32 ulp apart, and with the Cholesky solve). The
inliers are equal but for edges whose r^2 * inv_sigma2 at the two poses
lies on both sides of the chi2 threshold (widened by 1e-4), and chi2 is
held to 1e-4 of the plain one, apart from the terms of those edges, by
which alone the two sums differ.

`pose_problem` (seeded, numpy) is also chip_smoke.py's K5 problem.
"""

import collections
import importlib.util
import json
import os
import re
import types

import numpy as np
import pytest
import torch

from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.lie import so3_log
from orb_slam2_aruco_tpu_torch.kernels import build
from orb_slam2_aruco_tpu_torch.optim import lm, pose_opt

torch.set_num_threads(1)    # as in test_torch_slice.py: small CPU tensors

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# TUM1.yaml's intrinsics (slambench/configs/tum1-640x480.json)
FX, FY, CX, CY = 517.306408, 516.469215, 318.643040, 255.313989
ROT_TOL, TRANS_TOL, CHI2_TOL, TH_TOL = 1e-4, 1e-5, 1e-4, 1e-4
CHI2_TH = 5.991


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def pose_problem(seed, n=1000, a=16, markers="good", behind=0, valid=0.6,
                 device="cpu"):
    """One seeded pose-LM problem shaped like the tracking cascade's: n
    keypoint slots (`valid` of them matched) of points 1.5-6 m ahead on 8
    octaves with pixel noise and 10 % gross outliers, a start pose ~1 deg
    / 2 cm off, and `a` markers of 0.187 m. markers: "good" (~40 % of them
    good), "masked" (all masked off) or "none" (no marker arrays).
    `behind` matched points are placed behind the camera. Returns the
    keyword arguments of optimize_pose."""
    rng = np.random.default_rng(seed)
    R = _rodrigues(rng.normal(size=3) * 0.3)
    t = rng.normal(size=3) * 0.5
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(1.5, 6, n)], -1)
    s = 1.2 ** rng.integers(0, 8, n)
    uv = (np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                    FY * pc[:, 1] / pc[:, 2] + CY], -1)
          + rng.normal(size=(n, 2)) * s[:, None])
    out = rng.random(n) < 0.1
    uv[out] += rng.normal(size=(int(out.sum()), 2)) * 30
    mask = rng.random(n) < valid
    if behind:
        idx = rng.choice(n, behind, replace=False)
        pc[idx] = (np.array([0.0, 0.0, -1.0]) * rng.uniform(0.5, 3, (behind, 1))
                   + rng.normal(size=(behind, 3)) * 0.3)
        mask[idx] = True
    pw = (pc - t) @ R
    d = dict(Rcw0=_rodrigues(rng.normal(size=3) * 0.01) @ R,
             tcw0=t + rng.normal(size=3) * 0.02, pts_w=pw, uv=uv, mask=mask,
             inv_sigma2=1.0 / s ** 2)
    if markers != "none":
        cc = np.stack([rng.uniform(-1, 1, a), rng.uniform(-0.8, 0.8, a),
                       rng.uniform(1.5, 4, a)], -1)
        off = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]]) \
            * 0.0935
        cw = ((cc[:, None, :] + off[None]) - t) @ R
        pm = cw @ R.T + t
        muv = (np.stack([FX * pm[..., 0] / pm[..., 2] + CX,
                         FY * pm[..., 1] / pm[..., 2] + CY], -1)
               + rng.normal(size=(a, 4, 2)) * 0.5)
        good = (rng.random(a) < 0.4 if markers == "good"
                else np.zeros(a, bool))
        d.update(marker_corners_w=cw, marker_uv=muv, marker_mask=good)
    out = {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.float32),
                              device=device) for k, v in d.items()}
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa
    out["cam"] = Camera(f(FX), f(FY), f(CX), f(CY),
                        torch.zeros(5, device=device), 640, 480)
    return out


def kitti_problem(seed, device="cpu"):
    """One pose-LM problem of the tracking cascade built from a frame of the
    benchmark's KITTI 00-02 configuration (slambench/configs/
    kitti00-1241x376.json: 1241x376, rectified, 2000 features): make_frame
    on a seeded view of a row of 16 markers 1.4 m apart from 2.3 m (the
    kitti.loc-frame drive), its 2000 keypoint slots matched to the wall
    point each one sees (70 % of the valid ones, a tenth of those to another
    slot's point), its 16 marker slots to their true world corners, and a
    start pose ~1 deg / 2 cm off the truth. E = 2000 + 4 x 16 = 2064 edges:
    K5's 512-thread block. Returns (optimize_pose's keyword arguments, the
    true (Rcw, tcw))."""
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.io import synthetic
    from orb_slam2_aruco_tpu_torch.pipeline import frontend

    with open(os.path.join(ROOT, "slambench", "configs",
                           "kitti00-1241x376.json")) as f:
        cfg = SlamConfig.from_dict(json.load(f)["slam"])
    rng = np.random.default_rng(seed)
    ids = [int(i) for i in rng.choice(np.arange(1, 1000), 16, replace=False)]
    world = synthetic.build_world(ids, marker_size=cfg.aruco.marker_size,
                                  grid_cols=16, spacing=1.4, px_per_m=500.0,
                                  extent_margin=1.0, seed=seed % 2 ** 32)
    R, t = synthetic.look_at_plane_pose((rng.uniform(2.8, 18.2), 0.0), 2.3,
                                        yaw=rng.uniform(-0.15, 0.15))
    R, t = R.astype(np.float64), t.astype(np.float64)
    img = np.clip(synthetic.render_view(world, cfg.camera, R, t), 0,
                  255).astype(np.uint8)
    cam = camera_from_config(cfg.camera, device)
    fr = frontend.make_frame(torch.as_tensor(img, device=device), cam, cfg)
    c = cfg.camera
    # each keypoint's ray onto the wall z = 0 through the true pose
    uv = fr.kp_uv.double().cpu().numpy()
    d = np.stack([(uv[:, 0] - c.cx) / c.fx, (uv[:, 1] - c.cy) / c.fy,
                  np.ones(len(uv))], -1) @ R
    centre = -R.T @ t
    pw = centre + (-centre[2] / d[:, 2])[:, None] * d
    mask = fr.kp_valid.cpu().numpy() & (rng.random(len(uv)) < 0.7)
    wrong = np.flatnonzero(mask & (rng.random(len(uv)) < 0.1))
    pw[wrong] = pw[rng.permutation(wrong)]
    # each detected corner to the nearest true corner of its id
    corners = {s.marker_id: world.marker_corners_world(s).astype(np.float64)
               for s in world.markers}
    muv = fr.mk_corners.double().cpu().numpy()
    mk_ids = fr.mk_ids.cpu().numpy()
    mk_ok = (fr.mk_valid & fr.mk_good).cpu().numpy()
    cw = np.zeros((len(mk_ids), 4, 3))
    for a, mid in enumerate(mk_ids):
        if not mk_ok[a] or int(mid) not in corners:
            mk_ok[a] = False
            continue
        X = corners[int(mid)]
        pc = X @ R.T + t
        proj = np.stack([c.fx * pc[:, 0] / pc[:, 2] + c.cx,
                         c.fy * pc[:, 1] / pc[:, 2] + c.cy], -1)
        near = np.linalg.norm(muv[a][:, None] - proj[None], axis=-1)
        cw[a] = X[near.argmin(1)]
    octave = fr.kp_octave.cpu().numpy()
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32),  # noqa: E731
                                    device=device)
    p = dict(Rcw0=f32(_rodrigues(rng.normal(size=3) * 0.01) @ R),
             tcw0=f32(t + rng.normal(size=3) * 0.02), cam=cam, pts_w=f32(pw),
             uv=fr.kp_uv.contiguous(),
             mask=torch.as_tensor(mask, device=device),
             inv_sigma2=f32(1.0 / cfg.orb.scale_factor ** (2 * octave)),
             marker_corners_w=f32(cw), marker_uv=fr.mk_corners.contiguous(),
             marker_mask=torch.as_tensor(mk_ok, device=device))
    return p, (R, t)


def _pose_dist(a, b):
    """(rad, m) between the poses of two PoseOptResults."""
    Ra, Rb, ta, tb = (x.double().cpu() for x in (a.Rcw, b.Rcw, a.tcw, b.tcw))
    rot = float(torch.linalg.norm(so3_log(Ra @ Rb.T)))
    return rot, float((ta - tb).abs().max())


def _ulp(x, direction):
    return torch.nextafter(x, torch.full_like(x, direction * np.inf))


def _witness(p, monkeypatch):
    """The plain LM's own spread on p: (rad, m) over six runs from start
    translations one ulp apart and one with the JAX package's Cholesky
    solve, against the plain run."""
    base = pose_opt.optimize_pose_torch(**p)
    runs = []
    for i in range(3):
        for sgn in (1, -1):
            t0 = p["tcw0"].clone()
            t0[i] = _ulp(t0[i], sgn)
            runs.append(pose_opt.optimize_pose_torch(**{**p, "tcw0": t0}))

    def cholesky(H, b, lam):
        n = H.shape[-1]
        eye = torch.eye(n, dtype=H.dtype, device=H.device)
        d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-10)
        dx = lm.small_spd_solve(H + lam * (d * eye) + 1e-10 * eye, b)
        return torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))

    with monkeypatch.context() as m:
        m.setattr(pose_opt, "solve_damped", cholesky)
        runs.append(pose_opt.optimize_pose_torch(**p))
    d = [_pose_dist(base, r) for r in runs]
    return max(x[0] for x in d), max(x[1] for x in d)


def _edge_chi2(p, R, t):
    """r^2 * inv_sigma2 of every point edge at pose (R, t), float64."""
    X = p["pts_w"].double().cpu()
    pc = X @ R.double().cpu().T + t.double().cpu()
    fx, fy, cx, cy = (float(getattr(p["cam"], k))
                      for k in ("fx", "fy", "cx", "cy"))
    proj = torch.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                        fy * pc[:, 1] / pc[:, 2] + cy], -1)
    r = p["uv"].double().cpu() - proj
    return (r * r).sum(-1) * p["inv_sigma2"].double().cpu()


def held_to_plain(p, monkeypatch):
    """Run the kernel and the plain LM on p; assert the limits of the
    module docstring. Returns the kernel's result."""
    got = pose_opt.optimize_pose_cuda(**p)
    want = pose_opt.optimize_pose_torch(**p)
    torch.cuda.synchronize()
    rot, tr = _pose_dist(got, want)
    w_rot, w_t = _witness(p, monkeypatch)
    assert rot <= max(ROT_TOL, 2 * w_rot), (rot, w_rot)
    assert tr <= max(TRANS_TOL, 2 * w_t), (tr, w_t)
    differ = (got.inliers != want.inliers).cpu()
    flipped = 0.0
    if differ.any():
        a = _edge_chi2(p, got.Rcw, got.tcw)[differ]
        b = _edge_chi2(p, want.Rcw, want.tcw)[differ]
        lo, hi = torch.minimum(a, b) - TH_TOL, torch.maximum(a, b) + TH_TOL
        assert bool(((lo <= CHI2_TH) & (CHI2_TH <= hi)).all()), (a, b)
        flipped = float(torch.maximum(a, b).sum())
    c_got, c_want = float(got.chi2), float(want.chi2)
    assert abs(c_got - c_want) <= CHI2_TOL * abs(c_want) + flipped, \
        (c_got, c_want, flipped)
    assert int(got.n_inliers) == int(got.inliers.sum())
    assert got.n_inliers.dtype == torch.int64
    assert got.inliers.dtype == torch.bool
    return got


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode (chip_smoke.py runs them)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("markers", ["good", "masked", "none"])
@pytest.mark.parametrize("seed", [2147483911, 5, 6])
def test_kernel_matches_plain(cuda_device, monkeypatch, markers, seed):
    p = pose_problem(seed, markers=markers, device=cuda_device)
    held_to_plain(p, monkeypatch)


@pytest.mark.cuda
def test_kernel_matches_plain_with_edges_behind_the_camera(cuda_device,
                                                           monkeypatch):
    p = pose_problem(11, behind=40, device=cuda_device)
    assert bool((((p["pts_w"] @ p["Rcw0"].T + p["tcw0"])[:, 2] <= 0.05)
                 & p["mask"]).any())
    held_to_plain(p, monkeypatch)


@pytest.mark.cuda
def test_all_masked_problem_keeps_the_start_pose(cuda_device, monkeypatch):
    p = pose_problem(12, markers="masked", device=cuda_device)
    p["mask"] = torch.zeros_like(p["mask"])
    got = held_to_plain(p, monkeypatch)
    assert torch.equal(got.tcw, p["tcw0"])
    assert int(got.n_inliers) == 0 and float(got.chi2) == 0.0


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_seed_budget(cuda_device, monkeypatch):
    """track_frame's seed budget: seed_rounds x seed_iters = 2 x 6."""
    p = pose_problem(13, device=cuda_device)
    held_to_plain({**p, "rounds": 2, "iters_per_round": 6}, monkeypatch)


@pytest.mark.cuda
def test_kernel_matches_plain_above_2k_edges(cuda_device, monkeypatch):
    """E = 3000 + 4 x 64 edges: the 512-thread block."""
    p = pose_problem(14, n=3000, a=64, device=cuda_device)
    held_to_plain(p, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483921, 21, 22])
def test_kernel_matches_plain_on_kitti_cascade_problems(cuda_device,
                                                        monkeypatch, seed):
    """The cascade's problems at the KITTI camera: 2000 slots + 16 markers,
    so the 512-thread block, held to the plain LM by this file's limits."""
    p, _ = kitti_problem(seed, cuda_device)
    assert p["pts_w"].shape[0] + 4 * p["marker_mask"].shape[0] == 2064
    held_to_plain(p, monkeypatch)


@pytest.mark.cuda
def test_lm_block_counts_each_launch_by_its_block(cuda_device):
    """pose_lm_launch's block, read from the profiled kernel names: 512
    threads for KITTI's 2000 + 4 x 16 edges, 256 for 1000 + 4 x 16."""
    from torch.profiler import ProfilerActivity, profile

    kitti, _ = kitti_problem(23, cuda_device)
    tum = pose_problem(24, device=cuda_device)
    pose_opt.optimize_pose(**tum)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pose_opt.optimize_pose(**kitti)
        pose_opt.optimize_pose(**tum)
        torch.cuda.synchronize()
    blocks = collections.Counter(
        re.search(r"pose_lm_kernel<(\d+)>", e.name).group(1)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "pose_lm_kernel" in e.name)
    assert blocks == {"512": 3, "256": 1}, blocks


@pytest.mark.cuda
@pytest.mark.parametrize("n,a", [(1000, 16), (3000, 64)])
def test_kernel_repeats_bit_for_bit(cuda_device, n, a):
    p = pose_problem(15, n=n, a=a, device=cuda_device)
    first = pose_opt.optimize_pose_cuda(**p)
    second = pose_opt.optimize_pose_cuda(**p)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_tensors_take_the_kernel_once_per_call(cuda_device):
    p = pose_problem(16, device=cuda_device)
    kernels.reset_launch_counts()
    before = dict(pose_opt.LM_CALLS)
    pose_opt.optimize_pose(**p)
    assert kernels.launch_counts["pose_lm"] == 1
    assert pose_opt.LM_CALLS["kernel"] == before["kernel"] + 1
    assert pose_opt.LM_CALLS["plain"] == before["plain"]


# ---------------------------------------------------------------------------
# CPU: routing, argument checks, the launcher's signature, the reader
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_route():
    p = pose_problem(17, n=64, a=4)
    before = dict(pose_opt.LM_CALLS)
    launches = dict(kernels.launch_counts)
    got = pose_opt.optimize_pose(**p)
    want = pose_opt.optimize_pose_torch(**p)
    assert pose_opt.LM_CALLS["plain"] == before["plain"] + 1
    assert pose_opt.LM_CALLS["kernel"] == before["kernel"]
    assert kernels.launch_counts == launches
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _bad(p, name, how):
    t = p[name]
    if how == "dtype":
        t = t.double() if t.dtype == torch.float32 else t.to(torch.uint8)
    elif how == "shape":
        t = t[..., None]
    else:                         # a view that is not contiguous
        t = torch.stack([t, t], -1)[..., 0]
        assert not t.is_contiguous()
    return {**p, name: t}


def test_kitti_problem_is_a_512_thread_problem_the_plain_lm_solves():
    """kitti_problem on the CPU: 2064 edges, real markers, and the plain LM
    brings the start pose back to the truth."""
    p, (R, t) = kitti_problem(25)
    n, a = p["pts_w"].shape[0], p["marker_mask"].shape[0]
    assert (n, a) == (2000, 16)
    assert int(p["marker_mask"].sum()) >= 2
    assert int(p["mask"].sum()) >= 1000
    got = pose_opt.optimize_pose(**p)
    truth = types.SimpleNamespace(Rcw=torch.as_tensor(R),
                                  tcw=torch.as_tensor(t))
    rot, tr = _pose_dist(got, truth)
    assert rot < 2e-3 and tr < 0.01, (rot, tr)


@pytest.mark.parametrize("how", ["dtype", "shape", "contiguity"])
@pytest.mark.parametrize("name", ["Rcw0", "tcw0", "pts_w", "uv", "mask",
                                  "inv_sigma2", "marker_corners_w",
                                  "marker_uv", "marker_mask"])
def test_kernel_wrapper_refuses_bad_arguments(name, how):
    p = pose_problem(18, n=32, a=4)
    with pytest.raises(ValueError, match=f"optimize_pose_cuda: {name} "):
        pose_opt.optimize_pose_cuda(**_bad(p, name, how))


def test_kernel_wrapper_refuses_cpu_tensors_and_half_the_markers():
    p = pose_problem(19, n=32, a=4)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        pose_opt.optimize_pose_cuda(**p)
    with pytest.raises(ValueError, match="together, or none"):
        pose_opt.optimize_pose_cuda(**{**p, "marker_mask": None})


_C_TYPES = {"int": build.I, "float": build.F}


def _c_signature(name):
    """ctypes argtypes of `name`'s extern "C" launcher, read from its
    source: pointers (and the stream) c_void_p, int c_int, float c_float."""
    with open(os.path.join(build.SRC_DIR, f"{name}.cu")) as f:
        src = f.read()
    fn = build.SIGNATURES[name][0]
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
    assert m, f"no launcher {fn} in {name}.cu"
    out = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            out.append(build.P)
        else:
            out.append(_C_TYPES[param.replace("const ", "").split()[0]])
    return out


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_launcher_signature_matches_its_source(name):
    assert build.SIGNATURES[name][1] == _c_signature(name)


def test_every_kernel_is_counted():
    assert set(kernels.KERNELS) == set(build.SIGNATURES)
    assert set(kernels.launch_counts) == set(build.SIGNATURES)


def _load_reader(name="pose_lm_kernel_share"):
    path = os.path.join(ROOT, "slambench", "layers", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Trace:
    def __init__(self, counters, frames=10):
        self.counters, self.frames = counters, frames


def test_reader_reads_the_kernel_share():
    r = _load_reader()
    assert r.COUNTERS == {
        "lm_calls.kernel": (pose_opt.__name__, "LM_CALLS", "kernel"),
        "lm_calls.plain": (pose_opt.__name__, "LM_CALLS", "plain")}
    assert r.read(_Trace({"lm_calls.kernel": 20.0,
                          "lm_calls.plain": 0.0})) == 100.0
    assert r.read(_Trace({"lm_calls.kernel": 1.0,
                          "lm_calls.plain": 3.0})) == 25.0
    assert r.read(_Trace({"lm_calls.kernel": 0.0,
                          "lm_calls.plain": 0.0})) is None


class _Profiled:
    def __init__(self, profile):
        self.profile = profile


def test_us_reader_reads_the_mean_launch():
    """pose_lm_kernel_us on a synthetic profile: the mean of the K5
    launches' device time in µs, whatever their block; other kernels and
    copies are not read."""
    r = _load_reader("pose_lm_kernel_us")
    dev = [("void (anonymous namespace)::pose_lm_kernel<512>(PoseLmArgs)",
            1_000, 151_000),
           ("void (anonymous namespace)::pose_lm_kernel<512>(PoseLmArgs)",
            200_000, 370_000),
           ("fast_score_nms_kernel", 0, 900_000),
           ("Memcpy HtoD (Pageable -> Device)", 10, 20)]
    assert r.read(_Profiled({"device": dev, "window_ns": 10 ** 7})) == 160.0
    dev[0] = ("void pose_lm_kernel<256>(PoseLmArgs)", 0, 80_000)
    assert r.read(_Profiled({"device": dev, "window_ns": 10 ** 7})) == 125.0


def test_us_reader_leaves_its_metric_out_without_a_launch():
    r = _load_reader("pose_lm_kernel_us")
    assert r.read(_Profiled(None)) is None
    assert r.read(_Profiled({"device": [], "window_ns": 1})) is None
    assert r.read(_Profiled({"device": [("cc_fused_kernel", 0, 5)],
                             "window_ns": 10})) is None


def test_reader_leaves_its_metric_out_without_the_counter(monkeypatch):
    monkeypatch.delattr(pose_opt, "LM_CALLS")
    r = _load_reader()
    assert r.COUNTERS == {}
    assert r.read(_Trace({})) is None
