"""Pipelined SLAM mode of the port, its checkpoint and trajectory writers and
its two-pass example, against the JAX package.

The recordings are the JAX SlamSystem's (`python tests/test_torch_slice.py
--pipe`, ref_pipe_* keys):

  * ref_small: depth 2 over the small setup's shifted scene
    (SMALL_SHIFTED_PARAMS; the recorded small scene is chaotic in JAX
    itself, ROADMAP C2, the shifted one is not), and a run that goes black
    for three frames with reset_if_lost_with_kfs_leq = 0: the LOST frame
    is found two frames late, the frames in flight are rewound through the
    per-frame path and the first real frame relocalizes by marker.
  * ref_full: depth 4 over the 32 map frames with the file's own ref_cfg,
    bench.py's SLAM pass. The port's run of it is held on the card
    (chip_smoke.py's pipe phase); here only the recording's consistency
    with the map arrays of the same file.

Stated tolerances, the card's SLAM limits (PERF.md section 2): states,
frame ids, keyframe-insert frames and keyframes equal; poses of the
trajectory records within 0.5 deg / 2 cm; valid points within 5 %; ATE at
most max(1.5 x, +5 mm) of JAX's. The device-side rescale, re-anchor and
point remap of the frames in flight are held to the JAX steps on the same
inputs at float32 rounding (1e-6); the checkpoint and the trajectory files
byte for byte or array for array.
"""

import collections
import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_slice import (
    DATA_DIR,
    PIPE_DEPTH,
    PIPE_REWIND_ORDER,
    _rot_err_deg,
    pipe_cfg,
    pipe_run,
    pipe_scene,
    rewind_frames,
)

REF_SMALL = os.path.join(DATA_DIR, "ref_small.npz")
REF_FULL = os.path.join(DATA_DIR, "ref_full.npz")
ROT_DEG, TRANS_M, POINTS = 0.5, 0.02, 0.05


def _ref(path):
    with np.load(path) as z:
        return {k[len("ref_pipe_"):]: z[k] for k in z.files
                if k.startswith("ref_pipe_")}


def _cfg(ref):
    from orb_slam2_aruco_tpu_torch.config import SlamConfig

    return SlamConfig.from_dict(json.loads(str(ref["cfg"])))


def _port_run(cfg, imgs, gt):
    """(system, ref_pipe_*-shaped arrays) of the port over imgs on the CPU
    (test_torch_slice.pipe_run)."""
    from orb_slam2_aruco_tpu_torch.pipeline import mapping
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    system = SlamSystem(cfg, device="cpu")
    return system, pipe_run(system, mapping, imgs, gt)


def _hold(ref, system, run):
    """The port's run against the JAX recording, at the stated limits."""
    for k in ("fid", "state", "inserts", "reloc_fid", "kf_fid"):
        np.testing.assert_array_equal(run[k], ref[k], err_msg=k)
    got, want = json.loads(str(run["stats"])), json.loads(str(ref["stats"]))
    for k in ("kf_inserted", "pts_created", "ba_runs", "reloc",
              "loops_closed"):
        assert got[k] == want[k], k
    for i in np.flatnonzero(run["state"] == 2):
        assert _rot_err_deg(run["R"][i], ref["R"][i]) <= ROT_DEG, i
        assert np.linalg.norm(run["t"][i] - ref["t"][i]) <= TRANS_M, i
    for i in range(len(run["kf_fid"])):
        assert _rot_err_deg(run["kf_R"][i], ref["kf_R"][i]) <= ROT_DEG, i
        assert np.linalg.norm(run["kf_t"][i] - ref["kf_t"][i]) <= TRANS_M
    want = int(ref["n_valid"])
    assert abs(int(run["n_valid"]) - want) <= POINTS * want
    ate, ref_ate = float(run["ate"]), float(ref["ate"])
    assert ate <= max(1.5 * ref_ate, ref_ate + 0.005), (ate, ref_ate)
    np.testing.assert_array_equal(system._kf_valid_host,
                                  system.map.kf_valid.numpy())


def test_depth2_run_matches_recorded_jax():
    from orb_slam2_aruco_tpu_torch.io import synthetic

    ref = _ref(REF_SMALL)
    cfg = _cfg(ref)
    assert cfg.tracking.pipeline_depth == PIPE_DEPTH["small"]
    imgs, gt = pipe_scene("small", cfg, synthetic)
    system, run = _port_run(cfg, imgs, gt)
    assert not system._pending and not system._map_phase
    assert system._pending_cull is None and system._pending_loop is None
    _hold(ref, system, run)


def test_rewind_run_matches_recorded_jax():
    """The black frames are found LOST two frames late; every frame is
    recorded once, in order (tests/test_stream.py:196's contract), and the
    first real frame after them relocalizes by marker, as in JAX."""
    from orb_slam2_aruco_tpu_torch.io import synthetic

    ref = _ref(REF_SMALL)
    rref = {k[len("rewind_"):]: v for k, v in ref.items()
            if k.startswith("rewind_")}
    assert rref["order"].tolist() == PIPE_REWIND_ORDER
    cfg = pipe_cfg(_cfg(ref), PIPE_DEPTH["small"],
                   reset_if_lost_with_kfs_leq=0)
    imgs, gt = rewind_frames(*pipe_scene("small", cfg, synthetic))
    system, run = _port_run(cfg, imgs, gt)
    assert run["fid"].tolist() == list(range(len(imgs)))
    assert (run["state"] == 3).sum() >= 2
    _hold(rref, system, run)


def test_full_recording_is_the_files_own_depth4_map_build():
    """ref_full's pipelined recording (the chip's reference for the depth-4
    run) is the build of the map the same file holds: the recorder asserted
    the whole map equal; here its keyframes, their poses and the valid
    point count against the map arrays, and its trajectory's shape."""
    with np.load(REF_FULL) as z:
        ref = _ref(REF_FULL)
        assert z["ref_cfg"] == ref["cfg"]
        valid = z["kf_valid"]
        order = np.argsort(z["kf_frame_id"][valid])
        np.testing.assert_array_equal(ref["kf_fid"],
                                      z["kf_frame_id"][valid][order])
        np.testing.assert_array_equal(ref["kf_R"], z["kf_Rcw"][valid][order])
        np.testing.assert_array_equal(ref["kf_t"], z["kf_tcw"][valid][order])
        assert int(ref["n_valid"]) == int(z["pt_valid"].sum())
        n = len(z["ref_map_params"])
    assert _cfg(ref).tracking.pipeline_depth == PIPE_DEPTH["full"]
    assert ref["fid"].tolist() == list(range(n))
    assert ref["R"].shape == (n, 3, 3) and np.isfinite(ref["R"]).all()
    assert sorted(set(ref["inserts"].tolist())) == ref["kf_fid"].tolist()
    assert 0.0 < float(ref["ate"]) < 0.05


# ---------------------------------------------------------------------------
# the deferred steps against the JAX package's, on the same inputs
# ---------------------------------------------------------------------------

Out = collections.namedtuple("Out", "tcw ctrl obs_point")


def _pair(seed=0, n_pending=2):
    """A JAX and a port SlamSystem at the small configuration with the
    same tracking context and frames in flight (random poses, control
    vectors and observations)."""
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem as JSystem
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.geometry.lie import so3_exp
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem
    from orb_slam2_aruco_tpu_torch.pipeline.tracking import HostCopy
    from test_torch_slice import SETUPS

    jcfg = pipe_cfg(SETUPS["small"]()[0], 2)
    cfg = SlamConfig.from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(seed)

    def pose():
        R = so3_exp(torch.as_tensor(rng.normal(0, 0.3, 3),
                                    dtype=torch.float32))
        return R.numpy(), rng.normal(0, 1, 3).astype(np.float32)

    L = cfg.map.max_points
    ctx = dict(last_pose=pose(), vel=pose(),
               last_obs=rng.integers(-1, L, 300).astype(np.int32),
               pending=[(pose()[1], rng.normal(0, 1, 20).astype(np.float32),
                         rng.integers(-1, L, 300).astype(np.int32))
                        for _ in range(n_pending)])
    js, ts = JSystem(jcfg), SlamSystem(cfg, device="cpu")
    for s, conv in ((js, jnp.asarray), (ts, torch.as_tensor)):
        s.last_pose = tuple(conv(a) for a in ctx["last_pose"])
        s.vel = tuple(conv(a) for a in ctx["vel"])
        s.last_obs = conv(ctx["last_obs"])
        s.n_keyframes = 3
        s._kf_valid_host[1] = True
    js._pending = [(5 + i, 0.1, None, Out(*(jnp.asarray(a) for a in p)))
                   for i, p in enumerate(ctx["pending"])]
    ts._pending = []
    for i, p in enumerate(ctx["pending"]):
        out = Out(*(torch.as_tensor(a) for a in p))
        ts._pending.append((5 + i, 0.1, None, out, HostCopy(out.ctrl)))
    return js, ts, rng


def _step(system, name, k=1):
    """The named step of keyframe k's pipelined mapping phase."""
    try:
        steps = system._mapping_phase_steps(k, False)
    except TypeError:                  # the JAX method also takes the fid
        steps = system._mapping_phase_steps(k, 0, False)
    return next(fn for n, fn in steps if n.startswith(name))


def _same_context(js, ts):
    np.testing.assert_allclose(ts.last_pose[0].numpy(),
                               np.asarray(js.last_pose[0]), atol=1e-6)
    np.testing.assert_allclose(ts.last_pose[1].numpy(),
                               np.asarray(js.last_pose[1]), atol=1e-6)
    if js.vel is None:
        assert ts.vel is None
    else:
        np.testing.assert_allclose(ts.vel[1].numpy(), np.asarray(js.vel[1]),
                                   atol=1e-6)
    assert len(ts._pending) == len(js._pending)
    for (_, _, _, jo), (_, _, _, to, copy) in zip(js._pending, ts._pending):
        np.testing.assert_allclose(to.tcw.numpy(), np.asarray(jo.tcw),
                                   atol=1e-6)
        np.testing.assert_allclose(to.ctrl.numpy(), np.asarray(jo.ctrl),
                                   atol=1e-6)
        np.testing.assert_array_equal(copy.read(), to.ctrl.numpy())
        np.testing.assert_array_equal(to.obs_point.numpy(),
                                      np.asarray(jo.obs_point))


@pytest.mark.parametrize("s", [1.0, 1.37])
def test_deferred_rescale_matches_jax(s):
    """desc+plane's device-side scale correction: the last pose's and the
    velocity's translations and every frame in flight's tcw and control
    translation (ctrl[14:17]) times s, no host read."""
    from orb_slam2_aruco_tpu.pipeline import mapping as jmap
    from orb_slam2_aruco_tpu_torch.pipeline import mapping as tmap
    from orb_slam2_aruco_tpu_torch.pipeline import tracking

    js, ts, _ = _pair(1)
    with mock.patch.multiple(
            jmap, distinctive_descriptors=lambda st, cfg, kf: st,
            aruco_plane_update=lambda st, *a: (st, jnp.float32(s))), \
            mock.patch.multiple(
            tmap, distinctive_descriptors=lambda st, cfg, kf: st,
            aruco_plane_update=lambda st, *a: (st, torch.tensor(s))):
        _step(js, "desc+plane")()
        before = tracking.SYNCS["count"]
        _step(ts, "desc+plane")()
        assert tracking.SYNCS["count"] == before
    _same_context(js, ts)


def test_deferred_ba_reanchor_matches_jax():
    """A local-BA slice that moves keyframe 1 re-anchors the tracking
    context by the keyframe's move, T_last' = T_last T_k0^-1 T_k1, on the
    device."""
    from orb_slam2_aruco_tpu.pipeline import mapping as jmap
    from orb_slam2_aruco_tpu_torch.geometry.lie import so3_exp
    from orb_slam2_aruco_tpu_torch.pipeline import mapping as tmap

    js, ts, rng = _pair(2)
    k = 1
    R0 = so3_exp(torch.as_tensor(rng.normal(0, 0.2, 3),
                                 dtype=torch.float32)).numpy()
    t0 = rng.normal(0, 1, 3).astype(np.float32)
    R1 = so3_exp(torch.as_tensor(rng.normal(0, 0.2, 3),
                                 dtype=torch.float32)).numpy()
    t1 = rng.normal(0, 1, 3).astype(np.float32)
    js.map = js.map._replace(kf_Rcw=js.map.kf_Rcw.at[k].set(R0),
                             kf_tcw=js.map.kf_tcw.at[k].set(t0))
    Rt, tt = ts.map.kf_Rcw.clone(), ts.map.kf_tcw.clone()
    Rt[k], tt[k] = torch.as_tensor(R0), torch.as_tensor(t0)
    ts.map = ts.map._replace(kf_Rcw=Rt, kf_tcw=tt)

    def jba(st, *a, **kw):
        return st._replace(kf_Rcw=st.kf_Rcw.at[k].set(R1),
                           kf_tcw=st.kf_tcw.at[k].set(t1)), 0.0

    def tba(st, *a, **kw):
        R, t = st.kf_Rcw.clone(), st.kf_tcw.clone()
        R[k], t[k] = torch.as_tensor(R1), torch.as_tensor(t1)
        return st._replace(kf_Rcw=R, kf_tcw=t), 0.0

    with mock.patch.object(jmap, "bundle_adjust", jba), \
            mock.patch.object(tmap, "bundle_adjust", tba):
        _step(js, "ba[", k)()
        _step(ts, "ba[", k)()
    assert js.stats["ba_runs"] == ts.stats["ba_runs"] == 1
    np.testing.assert_allclose(ts.last_pose[0].numpy(),
                               np.asarray(js.last_pose[0]), atol=1e-6)
    _same_context(js, ts)


def test_point_remap_reaches_the_frames_in_flight():
    """A point merge forwards last_obs and every frame in flight's
    obs_point (CheckReplacedInLastFrame), as the JAX package does."""
    js, ts, rng = _pair(3, n_pending=3)
    L = ts.map.L
    merged_to = rng.integers(0, L, L).astype(np.int32)
    js._apply_point_remap(jnp.asarray(merged_to))
    ts._apply_point_remap(torch.as_tensor(merged_to))
    np.testing.assert_array_equal(ts.last_obs.numpy(),
                                  np.asarray(js.last_obs))
    _same_context(js, ts)


# ---------------------------------------------------------------------------
# checkpoints, trajectory files, telemetry
# ---------------------------------------------------------------------------


def test_save_map_round_trips_through_the_jax_package(tmp_path):
    """The port's checkpoint loads in the JAX package, whose save_map of
    that map writes the same keys, dtypes and values; the port loads JAX's
    file back to the map it saved."""
    from orb_slam2_aruco_tpu.io import checkpoint as jck
    from orb_slam2_aruco_tpu_torch.io import checkpoint
    from orb_slam2_aruco_tpu_torch.worldmap.state import MapState

    state = checkpoint.load_map(REF_SMALL, device="cpu")
    ts64 = np.linspace(1.6e9, 1.6e9 + 1.0, state.K)
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save_map(a, state, kf_ts64=ts64)
    jck.save_map(b, jck.load_map(a), kf_ts64=jck.load_extras(a)["kf_ts64"])
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        assert int(za["__version__"]) == 4
        assert za["kf_desc"].dtype == np.uint32
        assert za["kf_ts64"].dtype == np.float64
    back = checkpoint.load_map(b, device="cpu")
    for f in MapState._fields:
        x, y = getattr(state, f), getattr(back, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    np.testing.assert_array_equal(checkpoint.load_extras(b)["kf_ts64"], ts64)


def test_trajectory_writers_are_byte_equal_to_jax(tmp_path):
    from orb_slam2_aruco_tpu.io import trajectory as jtraj
    from orb_slam2_aruco_tpu_torch.geometry.lie import so3_exp
    from orb_slam2_aruco_tpu_torch.io import trajectory

    rng = np.random.default_rng(5)
    n = 400
    R = so3_exp(torch.as_tensor(rng.normal(0, 1.5, (n, 3)),
                                dtype=torch.float32)).numpy()
    R[:4] = [np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]),
             np.diag([-1, -1, 1])]
    t = rng.normal(0, 2, (n, 3)).astype(np.float32)
    stamps = 1.6e9 + rng.uniform(0, 100, n)
    for dtype in (np.float32, np.float64):
        for name, args in (("tum", (stamps, R.astype(dtype),
                                    t.astype(dtype))),
                           ("kitti", (R.astype(dtype), t.astype(dtype)))):
            a, b = tmp_path / f"port.{name}", tmp_path / f"jax.{name}"
            getattr(trajectory, f"save_{name}")(str(a), *args)
            getattr(jtraj, f"save_{name}")(str(b), *args)
            assert a.read_bytes() == b.read_bytes(), (name, dtype)
    trajectory.save_tum(str(tmp_path / "t.tum"), stamps, R, t)
    got = trajectory.load_tum(str(tmp_path / "t.tum"))
    want = jtraj.load_tum(str(tmp_path / "t.tum"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], stamps, atol=1e-6)
    np.testing.assert_allclose(got[1], trajectory.camera_centers(R, t),
                               atol=1e-6)


def test_frame_timer_and_device_trace(tmp_path):
    from orb_slam2_aruco_tpu.utils import FrameTimer as JTimer
    from orb_slam2_aruco_tpu_torch.utils import FrameTimer, device_trace
    from orb_slam2_aruco_tpu_torch.utils.telemetry import annotate

    times = list(np.random.default_rng(0).uniform(0.01, 0.05, 40))
    t, j = FrameTimer(warmup=5), JTimer(warmup=5)
    t.times_s, j.times_s = list(times), list(times)
    assert t.report() == j.report() and str(t) == str(j)
    assert t.percentile(75) == j.percentile(75)
    for a, b in zip(t.histogram(7).values(), j.histogram(7).values()):
        np.testing.assert_array_equal(a, b)
    with t.frame(n=4):
        pass
    assert len(t.times_s) == 44
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        with annotate("region"):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "region" for e in trace["traceEvents"])


def test_example_two_pass_writes_a_trajectory_and_a_map(tmp_path, capsys):
    """The port's two-pass example at 320x240, 300 features, 12 frames on
    the CPU: its TUM file and its map load with the JAX package's
    loaders."""
    from orb_slam2_aruco_tpu.io import checkpoint as jck
    from orb_slam2_aruco_tpu.io import trajectory as jtraj
    from orb_slam2_aruco_tpu_torch.examples import mono_synthetic

    out, mpath = tmp_path / "traj.tum", tmp_path / "map.npz"
    rc = mono_synthetic.main([
        "--frames", "12", "--width", "320", "--height", "240",
        "--features", "300", "--two-pass", "--chunk", "4", "--device", "cpu",
        "--out", str(out), "--save-map", str(mpath)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "ATE RMSE vs ground truth:" in text
    assert "second pass (localization-only, chunked x4): " in text
    stamps, centers, quats = jtraj.load_tum(str(out))
    assert len(stamps) >= 2 and np.isfinite(centers).all()
    np.testing.assert_allclose(np.linalg.norm(quats, axis=1), 1.0, atol=1e-6)
    state = jck.load_map(str(mpath))
    assert int(state.num_keyframes()) >= 2
    assert jck.load_extras(str(mpath))["kf_ts64"].dtype == np.float64
