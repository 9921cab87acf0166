"""Relocalization of the port against the JAX package on the same inputs:
the Sim3 half of geometry/lie, geometry/horn, optim/pnp, the retrieval
candidate functions, tracking.reloc_candidates / reloc_pnp and the system's
BoW-PnP fallback (SlamSystem._relocalize).

Stated tolerances: sim3_* within 1e-5; horn_sim3 rotations within 1e-4
rad, translation and scale within 1e-4 relative; the RANSAC PnP draws
(`utils.threefry.choice_p`) equal at N = 400, 700 and 1000; per hypothesis
the poses within 1e-3 (rotation entries; translation 1e-3 relative) for
every hypothesis whose minimal problem is determined (the planar solver's
where the JAX package returns a rotation, the DLT's on subsets of six
distinct non-coplanar points), the same best hypothesis and its pose
within 1e-3; candidate indices and keep flags equal; reloc_pnp and the
system's BoW-PnP relocalization within 0.2 deg / 1 cm of the JAX pose with
equal inlier counts.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu.config import CameraConfig
from orb_slam2_aruco_tpu.geometry import camera as jcam
from orb_slam2_aruco_tpu.geometry import horn as jhorn
from orb_slam2_aruco_tpu.geometry import lie as jlie
from orb_slam2_aruco_tpu.optim import pnp as jpnp
from orb_slam2_aruco_tpu.pipeline import system as jsystem
from orb_slam2_aruco_tpu.pipeline import tracking as jtrack
from orb_slam2_aruco_tpu.worldmap import retrieval as jret
from orb_slam2_aruco_tpu_torch.geometry import camera as tcam
from orb_slam2_aruco_tpu_torch.geometry import horn as thorn
from orb_slam2_aruco_tpu_torch.geometry import lie as tlie
from orb_slam2_aruco_tpu_torch.optim import pnp as tpnp
from orb_slam2_aruco_tpu_torch.pipeline import system as tsystem
from orb_slam2_aruco_tpu_torch.pipeline import tracking as ttrack
from orb_slam2_aruco_tpu_torch.utils import threefry
from orb_slam2_aruco_tpu_torch.worldmap import retrieval as tret

from test_torch_slam import REF_SMALL, _close, _n, _t, make_ctx
from test_torch_slice import _rot_err_deg

CAMC = CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                    dist=(0, 0, 0, 0, 0), width=640, height=480)
JC = jcam.camera_from_config(CAMC)
TC = tcam.camera_from_config(CAMC)


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


def _rot_angle(Ra, Rb):
    """Rotation angle(s) between Ra and Rb in radians, from the chordal
    distance |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2) (well conditioned near
    0, unlike the trace)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64),
                       axis=(-2, -1))
    return 2.0 * np.arcsin(np.minimum(1.0, d / (2.0 * np.sqrt(2.0))))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_sim3_functions_match_jax():
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(60, 7)) * 0.5).astype(np.float32)
    xi[:8, 3:6] *= 1e-4           # the small-angle branch
    xi[8:16, 6] *= 1e-7           # the small-sigma branch
    xi[16:18] = 0.0
    sj, Rj, tj = jlie.sim3_exp(jnp.asarray(xi))
    st, Rt, tt = tlie.sim3_exp(_t(xi))
    for a, b in ((st, sj), (Rt, Rj), (tt, tj)):
        _close(a, b, atol=1e-5, rtol=0)
    _close(tlie.sim3_log(st, Rt, tt), jlie.sim3_log(sj, Rj, tj), atol=1e-5,
           rtol=0)
    _close(tlie._so3_left_jacobian_inv(_t(xi[:, 3:6])),
           jlie._so3_left_jacobian_inv(jnp.asarray(xi[:, 3:6])), atol=1e-5,
           rtol=0)
    x = rng.normal(size=(60, 3)).astype(np.float32)
    _close(tlie.sim3_apply(st, Rt, tt, _t(x)),
           jlie.sim3_apply(sj, Rj, tj, jnp.asarray(x)), atol=1e-5, rtol=0)
    half = [slice(0, 30), slice(30, 60)]
    got = tlie.sim3_compose(*(v[half[0]] for v in (st, Rt, tt)),
                            *(v[half[1]] for v in (st, Rt, tt)))
    want = jlie.sim3_compose(*(v[half[0]] for v in (sj, Rj, tj)),
                             *(v[half[1]] for v in (sj, Rj, tj)))
    for a, b in zip(got, want):
        _close(a, b, atol=1e-5, rtol=0)
    for a, b in zip(tlie.sim3_inverse(st, Rt, tt),
                    jlie.sim3_inverse(sj, Rj, tj)):
        _close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_matches_jax(fix_scale):
    rng = np.random.default_rng(1)
    p1 = rng.normal(size=(40, 8, 3)).astype(np.float32)
    S = jlie.sim3_exp(jnp.asarray(rng.normal(size=(40, 7)) * 0.3,
                                  jnp.float32))
    p2 = (np.asarray(jlie.sim3_apply(S[0][:, None], S[1][:, None],
                                     S[2][:, None], jnp.asarray(p1)))
          + rng.normal(size=p1.shape).astype(np.float32) * 0.01)
    w = rng.random((40, 8)).astype(np.float32)
    sj, Rj, tj = jhorn.horn_sim3(jnp.asarray(p1), jnp.asarray(p2),
                                 jnp.asarray(w), fix_scale=fix_scale)
    st, Rt, tt = thorn.horn_sim3(_t(p1), _t(p2), _t(w), fix_scale=fix_scale)
    # q and -q are one rotation: compare rotations, not quaternions
    assert _rot_angle(_n(Rt), Rj).max() < 1e-4
    _close(st, sj, rtol=1e-4, atol=0)
    _close(tt, tj, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# RANSAC PnP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [400, 700, 1000])
def test_pnp_draws_match_jax_bit_for_bit(n):
    """ransac_pnp's subsets at the keypoint counts the configurations give
    a frame (400 / 700 small, 1000 full): XLA's CPU cumsum order holds."""
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.55
    w = jnp.asarray(mask, jnp.float32)
    want = jax.random.choice(jax.random.PRNGKey(0), n, shape=(256, 6),
                             replace=True, p=w / jnp.maximum(jnp.sum(w), 1.0))
    wt = _t(mask).to(torch.float32)
    got = threefry.choice_p(threefry.PRNGKey(0), (256, 6),
                            wt / torch.clamp(wt.sum(), min=1.0))
    np.testing.assert_array_equal(_n(got), np.asarray(want))


def _pnp_problem(planar: bool):
    """tests/test_optim.py's RANSAC problem (120 points, 30 outliers), and
    its planar variant (every point on z = 5)."""
    rng = np.random.default_rng(1)
    n = 120
    z = (np.full(n, 5.0) if planar else rng.uniform(4, 8, n))
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z],
                   -1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.2, -0.1, 0.15])))
    t = np.asarray([0.4, -0.3, 0.6], np.float32)
    pc = xyz @ R.T + t
    uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320,
                   500 * pc[:, 1] / pc[:, 2] + 240], -1).astype(np.float32)
    uv[:30] += rng.uniform(25, 60, size=(30, 2)).astype(np.float32)
    return xyz, uv, np.ones(n, np.float32), R, t


@pytest.mark.parametrize("planar", [False, True])
def test_ransac_pnp_matches_jax(planar):
    xyz, uv, mask, R_true, t_true = _pnp_problem(planar)
    sets, R, t = tpnp.hypotheses(_t(xyz), _t(uv), _t(mask), TC)
    s = _n(sets)
    xn = jcam.pixels_to_normalized(JC, jnp.asarray(uv))
    X = jnp.asarray(xyz)
    Rd, td = jpnp._dlt_pose(X[s], xn[s])
    Rp, tp = jpnp._planar_pose(X[s], xn[s])
    RJ = np.concatenate([Rd, Rp])
    TJ = np.concatenate([td, tp])
    H = s.shape[0]
    distinct = np.array([len(set(r)) == 6 for r in s])
    reflected = np.linalg.det(RJ) < 0
    assert not reflected[:H].any()
    assert (np.linalg.det(_n(R)) > 0).all()
    determined = np.concatenate([distinct & (not planar),
                                 ~reflected[H:]])
    assert determined[H:].sum() > 64
    np.testing.assert_allclose(_n(R)[determined], RJ[determined], atol=1e-3)
    np.testing.assert_allclose(
        _n(t)[determined], TJ[determined],
        atol=1e-3 * (1.0 + np.abs(TJ[determined]).max()))
    # the reflected JAX hypotheses are mirror images through their subset's
    # plane: the port's are rotations
    want = jpnp.ransac_pnp(X, jnp.asarray(uv), jnp.asarray(mask), JC)
    got = tpnp.ransac_pnp(_t(xyz), _t(uv), _t(mask), TC)
    assert np.linalg.det(np.asarray(want.Rcw)) > 0
    assert bool(got.ok) and bool(want.ok)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_array_equal(_n(got.inliers), np.asarray(want.inliers))
    _close(got.Rcw, want.Rcw, atol=1e-3, rtol=0)
    _close(got.tcw, want.tcw, atol=1e-3, rtol=0)
    np.testing.assert_allclose(_n(got.Rcw), R_true, atol=5e-3)


# ---------------------------------------------------------------------------
# retrieval and relocalization candidates
# ---------------------------------------------------------------------------


def _bow_problem(K=24, W=64):
    rng = np.random.default_rng(5)
    kf_bow = rng.random((K, W)).astype(np.float32) * (rng.random((K, W)) < 0.3)
    kf_bow /= np.maximum(np.linalg.norm(kf_bow, axis=1, keepdims=True), 1e-6)
    bow = kf_bow[3] * 0.7 + kf_bow[11] * 0.3
    bow /= np.linalg.norm(bow)
    valid = rng.random(K) > 0.15
    cov = np.triu(rng.integers(0, 60, (K, K)), 1)
    cov = (cov + cov.T).astype(np.float32)
    exclude = rng.random(K) < 0.2
    return bow.astype(np.float32), kf_bow, valid, cov, exclude


@pytest.mark.parametrize("min_score", [0.0, 0.2])
def test_retrieval_candidates_match_jax(min_score):
    bow, kf_bow, valid, cov, exclude = _bow_problem()
    j = [jnp.asarray(a) for a in (bow, kf_bow, valid)]
    t = [_t(a) for a in (bow, kf_bow, valid)]
    _close(tret.score_against_keyframes(*t),
           jret.score_against_keyframes(*j), atol=1e-6)
    for want, got in (
        (jret.detect_candidates(*j, jnp.asarray(exclude), min_score, 6),
         tret.detect_candidates(*t, _t(exclude), min_score, 6)),
        (jret.detect_candidates_grouped(*j, jnp.asarray(cov),
                                        jnp.asarray(exclude), min_score, 6),
         tret.detect_candidates_grouped(*t, _t(cov), _t(exclude), min_score,
                                        6)),
    ):
        np.testing.assert_array_equal(_n(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(_n(got[2]), np.asarray(want[2]))
        _close(got[1], want[1], atol=1e-6)


def _jax_hypothesis_scores(xyz, uv, mask, sets, cam, chi2_th):
    """The JAX package's hypotheses on the given subsets and their inlier
    counts (ransac_pnp's scoring): (scores [2H], det R [2H])."""
    xn = jcam.pixels_to_normalized(cam, uv)
    Rd, td = jpnp._dlt_pose(xyz[sets], xn[sets])
    Rp, tp = jpnp._planar_pose(xyz[sets], xn[sets])
    R, t = jnp.concatenate([Rd, Rp]), jnp.concatenate([td, tp])
    p_cam = jnp.einsum("hij,nj->hni", R, xyz) + t[:, None]
    err2 = jnp.sum((jcam.project(cam, p_cam) - uv[None]) ** 2, axis=-1)
    ok = (err2 < chi2_th) & (p_cam[..., 2] > 0.02) & mask[None]
    return np.asarray(ok.sum(-1)), np.linalg.det(np.asarray(R))


def test_reloc_candidates_and_pnp_match_jax(ctx):
    """The ref_small map against a recorded mid-point frame: the same
    candidates; through each kept one the same hypotheses' inlier counts
    wherever the JAX package's hypothesis is a rotation, and the same
    PnP-refined pose and inlier count. Where the JAX hypothesis is a
    reflection the port's is its rotation and explains more of the (not
    exactly planar) map; here such a one is the port's best PnP
    hypothesis, so the PnP inlier counts may differ, not the final poses
    and inlier counts."""
    cfg, jm, tm = ctx["cfg"], ctx["jmap"], ctx["tmap"]
    jf, tf = ctx["jframes"][3], ctx["tframes"][3]
    want = jtrack.reloc_candidates(jm, jf, cfg)
    got = ttrack.reloc_candidates(tm, tf, cfg)
    np.testing.assert_array_equal(_n(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_n(got[2]), np.asarray(want[2]))
    kept = np.asarray(want[0])[np.asarray(want[2])]
    assert len(kept) >= 1
    sj, st = jtrack.bind_markers(jm, jf), ttrack.bind_markers(tm, tf)
    for kf in kept:
        rj = jtrack.reloc_pnp(jm, jf, sj, jnp.asarray(kf), ctx["jc"], cfg)
        rt = ttrack.reloc_pnp(tm, tf, st, int(kf), ctx["tc"], cfg)
        # the PnP problem of this candidate, as reloc_pnp builds it
        obs = np.asarray(rj.obs_point)
        pts, pv = jtrack._point_world_arrays(jm, jnp.asarray(
            _n(ttrack._scatter_max(
                len(obs), *_matches_to_frame(tm, tf, int(kf), cfg)))))
        mask = pv & jf.kp_valid
        sets, R, t = tpnp.hypotheses(_t(np.asarray(pts)), tf.kp_uv,
                                     _t(np.asarray(mask)), ctx["tc"])
        scores_t = _n(tpnp.score(R, t, _t(np.asarray(pts)), tf.kp_uv,
                                 _t(np.asarray(mask)), ctx["tc"],
                                 cfg.optim.chi2_mono).sum(-1))
        scores_j, det_j = _jax_hypothesis_scores(
            pts, jf.kp_uv, mask, jnp.asarray(_n(sets)), ctx["jc"],
            cfg.optim.chi2_mono)
        # determined: the planar solver's rotations, and the DLT on six
        # distinct points (a repeated draw leaves its null space open)
        s = _n(sets)
        distinct = np.array([len(set(r)) == s.shape[1] for r in s])
        determined = (det_j > 0) & np.concatenate([distinct,
                                                   np.ones_like(distinct)])
        np.testing.assert_array_equal(scores_t[determined],
                                      scores_j[determined])
        assert int(rt.n_matches) == scores_t.max()
        assert int(rj.n_matches) == scores_j.max()
        assert int(rt.n_inliers) == int(rj.n_inliers)
        assert int(rj.n_inliers) >= cfg.tracking.min_inliers_track
        assert _rot_err_deg(_n(rt.Rcw), rj.Rcw) < 0.2
        assert np.linalg.norm(_n(rt.tcw) - np.asarray(rj.tcw)) < 0.01


def _matches_to_frame(tm, tf, kf, cfg):
    """reloc_pnp's 2D-3D association inputs (targets, sources) in the
    port."""
    from orb_slam2_aruco_tpu_torch.ops import matching as tmatch

    kf_obs = tm.kf_obs_point[kf]
    kf_valid = (tm.kf_kp_valid[kf] & (kf_obs >= 0)
                & tm.pt_valid[torch.clamp(kf_obs, min=0)])
    m = tmatch.nn_match(tmatch.distance_matrix(tm.kf_desc[kf], tf.desc,
                                               kf_valid, tf.kp_valid),
                        max_dist=float(cfg.matcher.th_low), nn_ratio=0.75,
                        mutual=True)
    N = tf.kp_uv.shape[0]
    return (torch.where(m.valid, m.idx, N), torch.where(m.valid, kf_obs, -1))


def _no_markers(frame):
    """The frame with its marker detections dropped: marker
    relocalization fails, BoW-PnP must do the work."""
    return frame._replace(mk_valid=frame.mk_valid & False)


def test_system_bow_pnp_relocalization_matches_jax(ctx):
    """A LOST system against the ref_small map: a frame without markers
    relocalizes through BoW-PnP in both packages, to the same pose; a
    noise frame (plenty of corners, no structure of the map) does not
    (tests/test_pipeline.py::test_reloc_rejects_weak_candidates)."""
    cfg, tcfg = ctx["cfg"], ctx["tcfg"]
    js = jsystem.SlamSystem(cfg)
    js.load_map(REF_SMALL)
    ts = tsystem.SlamSystem(tcfg, device="cpu")
    ts.load_map(REF_SMALL)
    rng = np.random.default_rng(3)
    noise = (rng.integers(0, 2, size=(cfg.camera.height, cfg.camera.width))
             * 255).astype(np.float32)
    assert js.track_monocular(noise, ts=0.0) is None
    assert ts.track_monocular(noise, ts=0.0) is None
    assert ts.stats["reloc"] == js.stats["reloc"] == 0
    pj = js._step_frame(_no_markers(ctx["jframes"][3]), 1, 0.1)
    pt = ts._step_frame(_no_markers(ctx["tframes"][3]), 1, 0.1)
    assert pj is not None and pt is not None
    assert ts.stats["reloc"] == js.stats["reloc"] == 1
    assert _rot_err_deg(pt[0], pj[0]) < 0.2
    assert np.linalg.norm(pt[1] - np.asarray(pj[1])) < 0.01
    assert ts.state is tsystem.TrackingState.OK


@pytest.mark.parametrize("route", ["marker", "bow"])
def test_relocalization_makes_the_most_covisible_keyframe_the_reference(
        ctx, monkeypatch, route):
    """After a relocalization the next frame has no velocity, and when its
    motion-model search fails it falls back to TrackReferenceKeyFrame,
    which matches against the reference keyframe. The TrackLocalMap that
    follows Relocalization makes that the keyframe sharing the most points
    with the frame (UpdateLocalKeyFrames, Tracking.cc:1555-1663), whichever
    route relocalized it; a stale one (here an empty slot) is replaced. The
    JAX package keeps the stale one: at 0.14 m a frame (the benchmark's
    KITTI drive) every frame after a relocalization was lost with it."""
    tcfg = ctx["tcfg"]
    ts = tsystem.SlamSystem(tcfg, device="cpu")
    ts.load_map(REF_SMALL)
    empty = int(torch.nonzero(~ts.map.kf_valid)[0])
    ts.ref_kf = empty
    seen = []
    mask = ttrack.local_point_mask

    def spy(state, obs_point, max_local_kfs):
        out = mask(state, obs_point, max_local_kfs)
        seen.append(obs_point.clone())
        return out

    monkeypatch.setattr(ttrack, "local_point_mask", spy)
    bow = []
    candidates = ttrack.reloc_candidates
    monkeypatch.setattr(ttrack, "reloc_candidates",
                        lambda *a: bow.append(1) or candidates(*a))
    frame = ctx["tframes"][3]
    if route == "bow":
        frame = _no_markers(frame)
    assert ts._step_frame(frame, 1, 0.1) is not None
    assert ts.stats["reloc"] == 1
    assert bool(bow) == (route == "bow")
    # the points the relocalized pose matched, and the keyframes seeing them
    obs = seen[-1]
    pts = torch.unique(obs[obs >= 0])
    share = (ts.map.pt_obs_kf[pts] & ts.map.kf_valid[None, :]).sum(dim=0)
    assert ts.ref_kf != empty and bool(ts.map.kf_valid[ts.ref_kf])
    assert int(share[ts.ref_kf]) == int(share.max()) > 0
