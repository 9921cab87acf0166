"""The port's map loading, matching, pose optimization and tracking against
the JAX package, on the ref_small map (orb_slam2_aruco_tpu_torch/data) and
on JAX Frames carried across with `frame_from_numpy`.
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu.geometry import camera as jcam
from orb_slam2_aruco_tpu.geometry import lie as jlie
from orb_slam2_aruco_tpu.io import checkpoint as jckpt
from orb_slam2_aruco_tpu.io import synthetic as jsyn
from orb_slam2_aruco_tpu.ops import matching as jmatch
from orb_slam2_aruco_tpu.optim import pose_opt as jpose
from orb_slam2_aruco_tpu.pipeline import frontend as jfrontend
from orb_slam2_aruco_tpu.pipeline import tracking as jtrack
from orb_slam2_aruco_tpu_torch import config as tconfig
from orb_slam2_aruco_tpu_torch.geometry import camera as tcam
from orb_slam2_aruco_tpu_torch.io import checkpoint as tckpt
from orb_slam2_aruco_tpu_torch.ops import matching as tmatch
from orb_slam2_aruco_tpu_torch.optim import pose_opt as tpose
from orb_slam2_aruco_tpu_torch.pipeline import tracking as ttrack
from orb_slam2_aruco_tpu_torch.pipeline.frontend import frame_from_numpy
from orb_slam2_aruco_tpu_torch.worldmap.state import MapState

from test_torch_slice import DATA_DIR, SETUPS, render_frames

REF_SMALL = os.path.join(DATA_DIR, "ref_small.npz")


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _rot_err(Ra, Rb):
    """Angle between two rotations (radians), from the chordal distance
    |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), precise near zero."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(1.0, d / (2.0 * np.sqrt(2.0)))))


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------


def _assert_states_equal(ts, js):
    for f in MapState._fields:
        a, b = _n(getattr(ts, f)), _n(getattr(js, f))
        assert a.shape == b.shape, f
        assert np.array_equal(a, b.astype(a.dtype)), f


@pytest.mark.parametrize("version", [4, 3, 1])
def test_load_map_matches_jax(tmp_path, version):
    path = REF_SMALL
    if version < 4:
        # an older checkpoint: drop the keys its format predates
        drop = {"loop_i", "loop_j", "loop_valid"}
        if version == 1:
            drop |= {"kf_seq", "next_seq", "pt_aruco", "pt_obs_kf"}
        with np.load(REF_SMALL) as z:
            arrays = {k: z[k] for k in z.files if k not in drop}
        arrays["__version__"] = np.asarray(version)
        path = str(tmp_path / f"v{version}.npz")
        np.savez_compressed(path, **arrays)
    _assert_states_equal(tckpt.load_map(path, device="cpu"),
                         jckpt.load_map(path))
    e_t, e_j = tckpt.load_extras(path), jckpt.load_extras(path)
    assert e_t.keys() == e_j.keys()


# ---------------------------------------------------------------------------
# matching and pose optimization
# ---------------------------------------------------------------------------


def test_matching_matches_jax():
    rng = np.random.default_rng(20)
    da = rng.integers(0, 2**32, (120, 8), dtype=np.uint64).astype(np.uint32)
    db = da[rng.permutation(120)[:100]].copy()
    flip = rng.integers(0, 2**32, (100, 8), dtype=np.uint64).astype(np.uint32)
    db ^= flip & rng.integers(0, 2**32, (100, 8), dtype=np.uint64).astype(
        np.uint32) & np.uint32(0x01010101)       # a few bit errors
    pa = rng.uniform(0, 300, (120, 2)).astype(np.float32)
    pb = rng.uniform(0, 300, (100, 2)).astype(np.float32)
    oa = rng.integers(0, 8, 120)
    ob = rng.integers(0, 8, 100)
    ma, mb = rng.uniform(size=120) < 0.9, rng.uniform(size=100) < 0.9
    aa = rng.uniform(0, 6.28, 120).astype(np.float32)
    ab = rng.uniform(0, 6.28, 100).astype(np.float32)
    dj = jmatch.distance_matrix(jnp.asarray(da), jnp.asarray(db),
                                jnp.asarray(ma), jnp.asarray(mb))
    dt = tmatch.distance_matrix(_t(da.view(np.int32)), _t(db.view(np.int32)),
                                _t(ma), _t(mb))
    np.testing.assert_array_equal(_n(dt), np.asarray(dj))
    for radius in (60.0, rng.uniform(20, 90, 120).astype(np.float32)):
        wj = jmatch.window_mask(jnp.asarray(pa), jnp.asarray(pb),
                                jnp.asarray(radius), jnp.asarray(oa),
                                jnp.asarray(ob))
        wt = tmatch.window_mask(_t(pa), _t(pb),
                                _t(radius) if np.ndim(radius) else radius,
                                _t(oa), _t(ob))
        np.testing.assert_array_equal(_n(wt), np.asarray(wj))
    for mutual in (False, True):
        mj = jmatch.nn_match(dj, 100.0, 0.9, mutual)
        mt = tmatch.nn_match(dt, 100.0, 0.9, mutual)
        for a, b in zip(mt, mj):
            np.testing.assert_array_equal(_n(a), np.asarray(b))
        assert np.asarray(mj.valid).sum() > 50
        rj = jmatch.rotation_consistency(jnp.asarray(aa), jnp.asarray(ab), mj)
        rt = tmatch.rotation_consistency(_t(aa), _t(ab), mt)
        np.testing.assert_array_equal(_n(rt.valid), np.asarray(rj.valid))


def test_optimize_pose_matches_jax():
    rng = np.random.default_rng(21)
    cam_cfg = SETUPS["small"]()[0].camera
    jc = jcam.camera_from_config(cam_cfg)
    tc = tcam.camera_from_config(
        tconfig.CameraConfig(**dataclasses.asdict(cam_cfg)))
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02])))
    t = np.asarray([0.1, -0.05, 0.2], np.float32)
    X = rng.uniform([-1, -1, 2], [1, 1, 4], (200, 3)).astype(np.float32)
    pc = X @ R.T + t
    uv = (pc[:, :2] / pc[:, 2:] * 300.0 + [160.0, 120.0]).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    clean = uv.copy()
    uv[20:40] += rng.uniform(-40, 40, (20, 2)).astype(np.float32)  # outliers
    mask = rng.uniform(size=200) < 0.95
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 3, 200)).astype(np.float32)
    corners = X[:8].reshape(2, 4, 3)
    muv = clean[:8].reshape(2, 4, 2)
    mmask = np.asarray([True, False])
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.06, -0.12, 0.0])))
    t0 = t + np.float32(0.03)
    rj = jpose.optimize_pose(jnp.asarray(R0), jnp.asarray(t0), jc,
                             jnp.asarray(X), jnp.asarray(uv),
                             jnp.asarray(mask), jnp.asarray(inv_s2),
                             jnp.asarray(corners), jnp.asarray(muv),
                             jnp.asarray(mmask))
    rt = tpose.optimize_pose(_t(R0), _t(t0), tc, _t(X), _t(uv), _t(mask),
                             _t(inv_s2), _t(corners), _t(muv), _t(mmask))
    # float32 LM on two backends: poses within 1e-4, same inlier set
    assert _rot_err(_n(rt.Rcw), np.asarray(rj.Rcw)) < 1e-4
    np.testing.assert_allclose(_n(rt.tcw), np.asarray(rj.tcw), atol=1e-4)
    np.testing.assert_array_equal(_n(rt.inliers), np.asarray(rj.inliers))
    # and both found the true pose and rejected the outliers
    assert _rot_err(_n(rt.Rcw), R) < 1e-2
    np.testing.assert_allclose(_n(rt.tcw), t, atol=1e-2)
    assert not _n(rt.inliers)[20:40].any()


# ---------------------------------------------------------------------------
# tracking functions on JAX frames and the ref_small map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ctx():
    cfg, world, _, loc = SETUPS["small"]()
    tcfg = tconfig.SlamConfig.from_dict(dataclasses.asdict(cfg))
    imgs, _ = render_frames(jsyn, world, cfg.camera, loc[:2])
    jc = jcam.camera_from_config(cfg.camera)
    jframes = [jfrontend.make_frame(jnp.asarray(im), jc, cfg) for im in imgs]
    tframes = [frame_from_numpy({f: np.asarray(getattr(fr, f))
                                 for f in fr._fields}) for fr in jframes]
    return dict(cfg=cfg, tcfg=tcfg, jc=jc,
                tc=tcam.camera_from_numpy({k: np.asarray(v) for k, v in
                                           jc._asdict().items()}),
                jmap=jckpt.load_map(REF_SMALL),
                tmap=tckpt.load_map(REF_SMALL, device="cpu"),
                jframes=jframes, tframes=tframes)


def test_marker_functions_match_jax(ctx):
    jm, tm = ctx["jmap"], ctx["tmap"]
    jf, tf = ctx["jframes"][0], ctx["tframes"][0]
    sj = jtrack.bind_markers(jm, jf)
    st = ttrack.bind_markers(tm, tf)
    np.testing.assert_array_equal(_n(st), np.asarray(sj))
    assert (np.asarray(sj) >= 0).sum() >= 3
    np.testing.assert_array_equal(
        _n(ttrack.old_marker_flags(tm, st, 10)),
        np.asarray(jtrack.old_marker_flags(jm, sj, 10)))
    assert int(ttrack.marker_observer_kf(tm, st)) == int(
        jtrack.marker_observer_kf(jm, sj))
    oj = jtrack.aruco_pose_candidate(jm, jf, sj, ctx["jc"], ctx["cfg"])
    ot = ttrack.aruco_pose_candidate(tm, tf, st, ctx["tc"], ctx["tcfg"])
    assert bool(ot[0]) == bool(oj[0]) and bool(oj[0])
    np.testing.assert_allclose(_n(ot[1]), np.asarray(oj[1]), atol=1e-4)
    np.testing.assert_allclose(_n(ot[2]), np.asarray(oj[2]), atol=1e-4)
    np.testing.assert_allclose(float(ot[3]), float(oj[3]), atol=1e-3)


def _assert_track_close(rt, rj, n_tol=3):
    # stated tolerance: 1e-3 rad, 1e-3 m, |dn| <= 3, >= 98 % same obs
    assert _rot_err(_n(rt.Rcw), np.asarray(rj.Rcw)) < 1e-3
    np.testing.assert_allclose(_n(rt.tcw), np.asarray(rj.tcw), atol=1e-3)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= n_tol
    assert np.mean(_n(rt.obs_point) == np.asarray(rj.obs_point)) >= 0.98


def test_relocalization_and_track_full_match_jax(ctx):
    """The marker relocalization steps on frame 0, then the whole cascade
    (track_full) on frame 1 seeded from frame 0's JAX result."""
    cfg, tcfg = ctx["cfg"], ctx["tcfg"]
    jm, tm = ctx["jmap"], ctx["tmap"]
    jc, tc = ctx["jc"], ctx["tc"]
    jf0, tf0 = ctx["jframes"][0], ctx["tframes"][0]
    sj = jtrack.bind_markers(jm, jf0)
    st = ttrack.bind_markers(tm, tf0)
    _, R0, t0, _ = jtrack.aruco_pose_candidate(jm, jf0, sj, jc, cfg)
    kf = jtrack.marker_observer_kf(jm, sj)
    r0j = jtrack.track_vs_keyframe(jm, jf0, sj, kf, R0, t0, jc, cfg)
    r0t = ttrack.track_vs_keyframe(tm, tf0, st, _t(kf).long(), _t(R0),
                                   _t(t0), tc, tcfg)
    _assert_track_close(r0t, r0j)
    loc_j, best_j = jtrack.local_point_mask(jm, r0j.obs_point, 80)
    loc_t, best_t = ttrack.local_point_mask(tm, _t(r0j.obs_point).long(), 80)
    np.testing.assert_array_equal(_n(loc_t), np.asarray(loc_j))
    assert int(best_t) == int(best_j)
    r1j, _ = jtrack.track_local_map(jm, jf0, sj, r0j.Rcw, r0j.tcw,
                                    r0j.obs_point, jc, cfg,
                                    pt_candidates=loc_j)
    r1t, _ = ttrack.track_local_map(tm, tf0, st, _t(r0j.Rcw), _t(r0j.tcw),
                                    _t(r0j.obs_point).long(), tc, tcfg,
                                    pt_candidates=loc_t)
    _assert_track_close(r1t, r1j)
    assert int(r1j.n_inliers) >= 50          # relocalization accepted

    jf1, tf1 = ctx["jframes"][1], ctx["tframes"][1]
    last = (jf0.kp_uv, jf0.desc, r1j.obs_point, jf0.kp_valid, jf0.kp_octave,
            jf0.kp_angle)
    out_j = jtrack.track_full(jm, jf1, r1j.Rcw, r1j.tcw, r1j.Rcw, r1j.tcw,
                              *last, jnp.asarray(0), jc, cfg)
    last_t = (tf0.kp_uv, tf0.desc, _t(r1j.obs_point).long(), tf0.kp_valid,
              tf0.kp_octave, tf0.kp_angle)
    R1, t1 = _t(r1j.Rcw), _t(r1j.tcw)
    out_t = ttrack.track_full(tm, tf1, R1, t1, R1, t1, *last_t,
                              torch.tensor(0), tc, tcfg)
    _assert_track_close(out_t, out_j)
    assert int(out_j.n_inliers) >= 30
    cj, ct = np.asarray(out_j.ctrl), _n(out_t.ctrl)
    np.testing.assert_array_equal(ct[2:5], cj[2:5])      # branch flags
    assert ct[19] == cj[19]                              # reference keyframe


def _aged(tm, n=12):
    """The map with n keyframes appended after its newest that observe no
    marker and no point: every mapped marker is then at least n keyframes
    old (mvbOldAruco at min_kfs_between_loops = 10)."""
    free = torch.nonzero(~tm.kf_valid)[:n, 0]
    fid, valid = tm.kf_frame_id.clone(), tm.kf_valid.clone()
    fid[free] = int(fid[tm.kf_valid].max()) + 1 + torch.arange(
        len(free), dtype=fid.dtype)
    valid[free] = True
    mk_valid = tm.kf_mk_valid.clone()
    mk_valid[free] = False
    return tm._replace(kf_frame_id=fid, kf_valid=valid, kf_mk_valid=mk_valid)


def _track_full_args(ctx):
    """track_full's arguments for frame 1 after frame 0 relocalized by its
    marker (the steps of test_relocalization_and_track_full_match_jax, in
    the port)."""
    tcfg, tm, tc = ctx["tcfg"], ctx["tmap"], ctx["tc"]
    tf0, tf1 = ctx["tframes"]
    st = ttrack.bind_markers(tm, tf0)
    _, R0, t0, _ = ttrack.aruco_pose_candidate(tm, tf0, st, tc, tcfg)
    kf = ttrack.marker_observer_kf(tm, st)
    r0 = ttrack.track_vs_keyframe(tm, tf0, st, kf, R0, t0, tc, tcfg)
    loc, _ = ttrack.local_point_mask(tm, r0.obs_point, 80)
    r1, _ = ttrack.track_local_map(tm, tf0, st, r0.Rcw, r0.tcw, r0.obs_point,
                                   tc, tcfg, pt_candidates=loc)
    return (tf1, r1.Rcw, r1.tcw, r1.Rcw, r1.tcw, tf0.kp_uv, tf0.desc,
            r1.obs_point, tf0.kp_valid, tf0.kp_octave, tf0.kp_angle,
            torch.tensor(0), tc, tcfg)


def test_track_full_on_a_final_map_counts_no_marker_old(ctx):
    """Localization against a final map (final_map) flags no marker old,
    as track_batch's extrapolate mode does: on a map whose markers are all
    old, SLAM-mode tracking leaves the frame's bound markers out of the
    seed, the error check and the pose LM, and localization takes the
    marker seed. On a map with no old marker (ref_small, and every map the
    recorded localizations run on) the two are the same bit for bit."""
    tm = ctx["tmap"]
    args = _track_full_args(ctx)
    slam = ttrack.track_full(tm, *args)
    final = ttrack.track_full(tm, *args, final_map=True)
    assert not bool(slam.old_flags.any())
    for a, b in zip(slam, final):
        assert torch.equal(a, b)
    aged = _aged(tm)
    bound = ttrack.bind_markers(aged, args[0]) >= 0
    assert int(bound.sum()) >= 3
    slam = ttrack.track_full(aged, *args)
    final = ttrack.track_full(aged, *args, final_map=True)
    assert torch.equal(slam.old_flags, bound)
    assert not bool(final.old_flags.any())
    assert float(slam.ctrl[2]) == 0.0 and float(final.ctrl[2]) == 1.0
    assert int(final.n_inliers) >= 30


def test_localization_mode_tracks_on_a_final_map(ctx, monkeypatch):
    """SlamSystem's per-frame tracking passes final_map in localization
    mode: a loaded map relocalizes frame 0, then tracks frame 1."""
    from orb_slam2_aruco_tpu_torch.pipeline import system as tsystem

    seen = []
    track_full = ttrack.track_full
    params = inspect.signature(track_full)

    def spy(*a, **k):
        seen.append(params.bind(*a, **k).arguments.get("final_map"))
        return track_full(*a, **k)

    monkeypatch.setattr(ttrack, "track_full", spy)
    ts = tsystem.SlamSystem(ctx["tcfg"], device="cpu")
    ts.load_map(REF_SMALL)
    assert ts.localization_only
    for i, frame in enumerate(ctx["tframes"]):
        assert ts._step_frame(frame, i, i / 30.0) is not None
    assert ts.stats["reloc"] == 1 and seen == [True]


def test_ctrl_decoder_reads_finish_field_for_field(ctx):
    """`_read_ctrl` decodes the control vector `_finish` writes, the layout
    the per-frame, pipelined and chunked paths read: on frame 1's cascade
    each field is the result's own value, the reference keyframe's
    tracked-point counts are recounted from the map, and the device-side
    readers (`_CTRL_AT`, `_ctrl_scaled_t`) touch only their fields."""
    tm = ctx["tmap"]
    out = ttrack.track_full(tm, *_track_full_args(ctx))
    c = ttrack._read_ctrl(out.ctrl.numpy())
    assert c.n_inliers == int(out.n_inliers) >= 30
    assert c.n_first == int(out.n_first_stage)
    assert (c.used_aruco, c.used_ref_kf, c.any_new_marker) == (
        bool(out.used_aruco), bool(out.used_ref_kf), bool(out.any_new_marker))
    np.testing.assert_array_equal(c.Rcw, out.Rcw.numpy())
    np.testing.assert_array_equal(c.tcw, out.tcw.numpy())
    k = c.ref_kf
    assert bool(tm.kf_valid[k])
    assert int(out.ctrl[ttrack._CTRL_AT["ref_kf"]]) == k
    obs = _n(tm.kf_obs_point[k])
    seen = obs[obs >= 0]
    seen = seen[_n(tm.pt_valid)[seen]]
    n_obs = (_n(tm.pt_obs_kf) & _n(tm.kf_valid)[None]).sum(axis=1)[seen]
    assert c.n_ref3 == int((n_obs >= 3).sum()) > 0
    assert c.n_ref2 == int((n_obs >= 2).sum()) >= c.n_ref3
    s = ttrack._read_ctrl(
        ttrack._ctrl_scaled_t(out.ctrl, torch.tensor(2.0)).numpy())
    np.testing.assert_array_equal(s.tcw, c.tcw * np.float32(2.0))
    for a, b in zip(s._replace(tcw=c.tcw), c):
        np.testing.assert_array_equal(a, b)
