"""The port's SLAM-mode modules against the JAX package on the same inputs:
utils/threefry against jax.random, triangulation, two-view geometry, the
two initializers, covisibility, the dense BA and every mapping function
(on the ref_small map, orb_slam2_aruco_tpu_torch/data).

Stated tolerances: integer and boolean outputs (slots, masks, matches,
victims) equal; floats within 1e-4 relative (plus a small absolute floor
where values cross zero); BA poses within 1e-3 after their iterations.
"""

import dataclasses
import itertools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu.geometry import camera as jcam
from orb_slam2_aruco_tpu.geometry import triangulate as jtri
from orb_slam2_aruco_tpu.geometry import twoview as jtv
from orb_slam2_aruco_tpu.io import checkpoint as jckpt
from orb_slam2_aruco_tpu.io import synthetic as jsyn
from orb_slam2_aruco_tpu.optim import ba as jba
from orb_slam2_aruco_tpu.pipeline import frontend as jfrontend
from orb_slam2_aruco_tpu.pipeline import initializer as jinit
from orb_slam2_aruco_tpu.pipeline import mapping as jmap
from orb_slam2_aruco_tpu.pipeline import tracking as jtrack
from orb_slam2_aruco_tpu.worldmap import covisibility as jcov
from orb_slam2_aruco_tpu.worldmap import state as jstate
from orb_slam2_aruco_tpu_torch import config as tconfig
from orb_slam2_aruco_tpu_torch.geometry import camera as tcam
from orb_slam2_aruco_tpu_torch.geometry import triangulate as ttri
from orb_slam2_aruco_tpu_torch.geometry import twoview as ttv
from orb_slam2_aruco_tpu_torch.io import checkpoint as tckpt
from orb_slam2_aruco_tpu_torch.optim import ba as tba
from orb_slam2_aruco_tpu_torch.pipeline import initializer as tinit
from orb_slam2_aruco_tpu_torch.pipeline import mapping as tmap
from orb_slam2_aruco_tpu_torch.pipeline import tracking as ttrack
from orb_slam2_aruco_tpu_torch.pipeline.frontend import frame_from_numpy
from orb_slam2_aruco_tpu_torch.utils import threefry
from orb_slam2_aruco_tpu_torch.worldmap import covisibility as tcov
from orb_slam2_aruco_tpu_torch.worldmap import state as tstate

from test_torch_slice import DATA_DIR, SETUPS, render_frames, slam_cfg

REF_SMALL = os.path.join(DATA_DIR, "ref_small.npz")
RTOL = 1e-4


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.as_tensor(a)


def _n(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _close(got, want, atol=1e-5, rtol=RTOL):
    np.testing.assert_allclose(_n(got), _n(want), rtol=rtol, atol=atol)


def _jstate(arrays):
    return jstate.MapState(**{f: jnp.asarray(v) for f, v in arrays.items()})


def _assert_maps(tm, jm, exact=(), close=(), atol=1e-5):
    """Port map `tm` against JAX map `jm`: `exact` fields equal, `close`
    fields within the float tolerance, every other field equal too."""
    got = tstate.state_to_numpy(tm)
    for f in jstate.MapState._fields:
        want = np.asarray(getattr(jm, f))
        assert got[f].dtype == want.dtype, f
        if f in close:
            _close(got[f], want, atol=atol)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)


# ---------------------------------------------------------------------------
# utils/threefry against jax.random
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 17, 2**31 - 1])
def test_threefry_keys_and_uniform_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    assert np.asarray(key).tolist() == list(threefry.PRNGKey(seed))
    for d in (0, 1, 15, 255, 70001):
        kj = jax.random.fold_in(key, d)
        kt = threefry.fold_in(threefry.PRNGKey(seed), d)
        assert np.asarray(kj).tolist() == list(kt)
        want = np.asarray(jax.random.uniform(kj, (3, 5, 7)))
        np.testing.assert_array_equal(
            threefry.uniform(kt, (3, 5, 7), "cpu").numpy(), want)


@pytest.mark.parametrize("kf", [0, 3, 13])
def test_threefry_categorical_and_choice_bit_equal(kf):
    """The two draws of the slice: the plane RANSAC's categorical
    (mapping.py:1008-1017, its [A, 1, N] logits broadcast against
    (A, H, 5)) and the classic initializer's choice (initializer.py:
    118-121)."""
    rng = np.random.default_rng(kf)
    A, N = 16, 300
    w0 = rng.random((A, N)) < 0.04
    w0[[1, 7]] = False                       # empty rows -> all-zero logits
    logits = jnp.where(jnp.asarray(w0), 0.0, -jnp.inf)
    logits = jnp.where(jnp.any(jnp.asarray(w0), axis=1, keepdims=True),
                       logits, 0.0)
    key = jax.random.fold_in(jax.random.PRNGKey(17), kf)
    want = np.asarray(jax.random.categorical(key, logits[:, None, :],
                                             axis=-1, shape=(A, 16, 5)))
    mask = w0 | ~w0.any(axis=1, keepdims=True)
    kt = threefry.fold_in(threefry.PRNGKey(17), kf)
    np.testing.assert_array_equal(threefry.categorical_masked_argmax(
        kt, torch.as_tensor(mask)[:, None, :], (A, 16, 5)).numpy(), want)
    # the running sum's three shapes: one row, rows, rows of row totals
    for n, frac in itertools.product((12, N, 1000), (0.05, 0.4, 0.95)):
        m = (rng.random(n) < frac).astype(np.float32)
        p = m / np.float32(max(m.sum(), 1.0))
        want = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n,
                                            shape=(128, 8), replace=True,
                                            p=jnp.asarray(p)))
        np.testing.assert_array_equal(threefry.choice_p(
            threefry.PRNGKey(0), (128, 8), torch.as_tensor(p)).numpy(), want)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _two_view_scene(rng, n=60):
    X = rng.uniform([-1, -1, 3], [1, 1, 6], (n, 3)).astype(np.float32)
    ang = 0.1
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.array([-0.4, 0.05, 0.02], np.float32)
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    noise = lambda: rng.normal(0, 2e-4, x1.shape).astype(np.float32)  # noqa
    return X, R, t, (x1 + noise()).astype(np.float32), (
        x2 + noise()).astype(np.float32)


def test_triangulate_and_parallax_match_jax():
    rng = np.random.default_rng(0)
    X, R, t, x1, x2 = _two_view_scene(rng)
    n = len(X)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3))
    z = np.zeros((n, 3), np.float32)
    Rb = np.broadcast_to(R, (n, 3, 3))
    tb = np.broadcast_to(t, (n, 3))
    want = np.asarray(jtri.triangulate_dlt(eye, z, Rb, tb, x1, x2))
    got = ttri.triangulate_dlt(_t(eye), _t(z), _t(Rb), _t(tb), _t(x1),
                               _t(x2))
    _close(got, want, atol=1e-4)
    np.testing.assert_allclose(want, X, atol=0.1)    # noisy rays
    c2 = -R.T @ t
    _close(ttri.parallax_cos(_t(z), _t(np.broadcast_to(c2, (n, 3))), got),
           jtri.parallax_cos(z, np.broadcast_to(c2, (n, 3)), want),
           atol=1e-6)


def _up_to_sign_scale(a, b):
    a = np.asarray(a, np.float64).reshape(a.shape[0], -1)
    b = np.asarray(b, np.float64).reshape(b.shape[0], -1)
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return np.minimum(np.abs(a - b).max(1), np.abs(a + b).max(1))


def test_twoview_models_and_decompositions_match_jax():
    """F, H and E agree up to scale and sign; scores, the candidate (R, t)
    sets and CheckRT's choice agree."""
    rng = np.random.default_rng(1)
    X, R, t, x1, x2 = _two_view_scene(rng, 80)
    K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    u1 = (x1 @ K[:2, :2].T + K[:2, 2]).astype(np.float32)
    u2 = (x2 @ K[:2, :2].T + K[:2, 2]).astype(np.float32)
    sets = rng.integers(0, len(X), (16, 8))
    Fj = np.asarray(jtv.fundamental_8pt(u1[sets], u2[sets]))
    Ft = ttv.fundamental_8pt(_t(u1[sets]), _t(u2[sets]))
    # an 8-point set with a near-rank-7 system has an ill-conditioned null
    # vector: most hypotheses agree to 1e-3, the RANSAC's choice exactly
    dF = _up_to_sign_scale(_n(Ft), Fj)
    assert np.mean(dF < 1e-3) >= 0.75, dF
    Hj = np.asarray(jtv.homography_dlt(u1[sets[:, :4]], u2[sets[:, :4]]))
    Ht = ttv.homography_dlt(_t(u1[sets[:, :4]]), _t(u2[sets[:, :4]]))
    assert np.mean(_up_to_sign_scale(_n(Ht), Hj) < 1e-3) >= 0.75
    S, n = 16, len(X)
    mask = np.ones((S, n), np.float32)
    U1, U2 = np.broadcast_to(u1, (S, n, 2)), np.broadcast_to(u2, (S, n, 2))
    sfj, ifj = jtv.score_fundamental(Fj, U1, U2, mask)
    sft, ift = ttv.score_fundamental(_t(Fj), _t(U1), _t(U2), _t(mask))
    _close(sft, sfj, atol=1e-3)
    np.testing.assert_array_equal(_n(ift), np.asarray(ifj))
    own, _ = ttv.score_fundamental(Ft, _t(U1), _t(U2), _t(mask))
    best = int(np.argmax(np.asarray(sfj)))
    assert int(torch.argmax(own)) == best and dF[best] < 1e-3
    shj, ihj = jtv.score_homography(Hj, U1, U2, mask)
    sht, iht = ttv.score_homography(_t(Hj), _t(U1), _t(U2), _t(mask))
    _close(sht, shj, rtol=1e-3, atol=1e-2)
    E = np.asarray(jtv.essential_from_fundamental(Fj[best], K))
    Rej, tej = jtv.decompose_E(E)
    Ret, tet = ttv.decompose_E(_t(E))
    Rhj, thj = jtv.decompose_H(Hj[0], K)
    Rht, tht = ttv.decompose_H(_t(Hj[0]), _t(K))
    _close(Rht, Rhj, atol=2e-4)
    _close(tht, thj, atol=2e-4)
    # E's SVD signs are free: the same four candidates, in any order
    for Rs, ts in ((Ret, tet),):
        for i in range(4):
            d = [max(np.abs(_n(Rs[i]) - np.asarray(Rej[j])).max(),
                     np.abs(_n(ts[i]) - np.asarray(tej[j])).max())
                 for j in range(4)]
            assert min(d) < 1e-3, d
    xn1 = np.broadcast_to(x1, (4, n, 2))
    xn2 = np.broadcast_to(x2, (4, n, 2))
    m4 = np.ones((4, n), np.float32)
    ngj, gj, _, _ = jtv.check_rt(Rej, tej, xn1, xn2, m4)
    ngt, gt, _, _ = ttv.check_rt(Ret, tet, _t(xn1), _t(xn2), _t(m4))
    bj, bt = int(np.argmax(np.asarray(ngj))), int(torch.argmax(ngt))
    assert int(ngt[bt]) == int(np.asarray(ngj)[bj]) > 0.9 * n
    assert _n(Ret[bt]).round(3).tolist() == np.asarray(Rej[bj]).round(
        3).tolist()
    np.testing.assert_allclose(_n(tet[bt]), np.asarray(tej[bj]), atol=1e-3)
    np.testing.assert_allclose(np.asarray(Rej[bj]), R, atol=0.02)  # noisy


# ---------------------------------------------------------------------------
# frames and the ref_small map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


def make_ctx():
    """JAX frames of small map frames 0-2 and one mid-point frame, the same
    frames in the port, both cameras and both packages' ref_small map."""
    base, world, map_params, loc = SETUPS["small"]()
    cfg = slam_cfg(base)
    tcfg = tconfig.SlamConfig.from_dict(dataclasses.asdict(cfg))
    imgs, _ = render_frames(jsyn, world, cfg.camera,
                            [map_params[0], map_params[1], map_params[2],
                             loc[3]])
    jc = jcam.camera_from_config(cfg.camera)
    jframes = [jfrontend.make_frame(jnp.asarray(im), jc, cfg) for im in imgs]
    tframes = [frame_from_numpy({f: np.asarray(getattr(fr, f))
                                 for f in fr._fields}) for fr in jframes]
    jm = jckpt.load_map(REF_SMALL)
    return dict(cfg=cfg, tcfg=tcfg, jc=jc,
                tc=tcam.camera_from_numpy({k: np.asarray(v) for k, v in
                                           jc._asdict().items()}),
                jmap=jm, tmap=tckpt.load_map(REF_SMALL, device="cpu"),
                kf=int(np.argmax(np.asarray(jm.kf_seq))),
                jframes=jframes, tframes=tframes)


def test_empty_map_and_state_roundtrip_match_jax(ctx):
    cfg, tcfg = ctx["cfg"], ctx["tcfg"]
    want = jstate.empty_map(cfg)
    got = tstate.empty_map(tcfg)
    _assert_maps(got, want)
    _assert_maps(ctx["tmap"], ctx["jmap"])
    valid = ctx["jmap"].kf_valid
    assert int(tstate.first_free_slot(_t(valid))) == int(
        jstate.first_free_slot(valid))
    np.testing.assert_array_equal(
        _n(tstate.free_slots(ctx["tmap"].pt_valid, 40)),
        np.asarray(jstate.free_slots(ctx["jmap"].pt_valid, 40)))
    for mid in (3, 42, 5):
        assert int(tstate.marker_slot_for_id(ctx["tmap"], mid)) == int(
            jstate.marker_slot_for_id(ctx["jmap"], mid))


def test_initializers_match_jax(ctx):
    """The marker pose on map frames 0 -> 1 (the recorded initialization)
    and the classic H / F pose on frames 0 -> 2."""
    cfg, tcfg, jc, tc = ctx["cfg"], ctx["tcfg"], ctx["jc"], ctx["tc"]
    jf, tf = ctx["jframes"], ctx["tframes"]
    cj = jinit.marker_relative_pose(jf[0], jf[1], jc, cfg)
    ct = tinit.marker_relative_pose(tf[0], tf[1], tc, tcfg)
    assert bool(ct.ok) == bool(cj.ok) and bool(cj.ok)
    _close(ct.R21, cj.R21, atol=1e-5)
    _close(ct.t21, cj.t21, atol=1e-5)
    _close(ct.ctrl, cj.ctrl, atol=1e-4)
    cj = jinit.classic_relative_pose(jf[0], jf[2], jc, cfg)
    ct = tinit.classic_relative_pose(tf[0], tf[2], tc, tcfg)
    assert bool(ct.ok) == bool(cj.ok)
    _close(ct.R21, cj.R21, atol=2e-3)
    _close(ct.t21, cj.t21, atol=2e-3)


def test_covisibility_matches_jax(ctx):
    Wj = np.asarray(jcov.covisibility_matrix(ctx["jmap"]))
    Wt = tcov.covisibility_matrix(ctx["tmap"])
    np.testing.assert_array_equal(_n(Wt), Wj)
    assert Wj[ctx["kf"]].sum() > 0
    for kf in range(4):
        ij, vj, okj = jcov.covisible_neighbors(jnp.asarray(Wj), kf, 5, 3)
        it, vt, okt = tcov.covisible_neighbors(Wt, kf, 5, 3)
        np.testing.assert_array_equal(_n(it), np.asarray(ij))
        np.testing.assert_array_equal(_n(okt), np.asarray(okj))


def _rotvec(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _ba_problem(rng):
    """A small BA problem: 4 cameras (one fixed), 40 points, one marker
    seen by every camera; observations with 0.5 px noise, the initial
    states perturbed."""
    K, L, M = 4, 40, 2
    X = rng.uniform([-1, -1, 3], [1, 1, 5], (L, 3))
    Rs, ts = [], []
    for k in range(K):
        a = 0.05 * k
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        Rs.append(R)
        ts.append(np.array([-0.2 * k, 0.0, 0.0]))
    Rwm = np.stack([np.eye(3), np.eye(3)])
    twm = np.array([[0.0, 0.0, 4.0], [0.0, 0.0, 0.0]])
    side = np.array([0.3, 0.3])
    f, c = 400.0, 200.0

    def proj(R, t, P):
        q = P @ R.T + t
        return f * q[:, :2] / q[:, 2:] + c

    e_kf = np.repeat(np.arange(K), L)
    e_pt = np.tile(np.arange(L), K)
    e_uv = np.concatenate([proj(Rs[k], ts[k], X) for k in range(K)])
    corners = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]]) * 0.15
    m_uv = np.concatenate([proj(Rs[k], ts[k], corners + twm[0])
                           for k in range(K)])
    e_uv = e_uv + rng.normal(0, 0.5, e_uv.shape)
    m_uv = m_uv + rng.normal(0, 0.5, m_uv.shape)
    dR = [np.eye(3) if k == 0 else _rotvec(rng.normal(0, 0.01, 3))
          for k in range(K)]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    prob = dict(
        Rcw=f32([dR[k] @ Rs[k] for k in range(K)]),
        tcw=f32(np.stack(ts) + rng.normal(0, 0.02, (K, 3)) * (np.arange(K)
                                                               > 0)[:, None]),
        points=f32(X + rng.normal(0, 0.03, X.shape)),
        Rwm=f32(Rwm), twm=f32(twm + [[0.02, -0.01, 0.03], [0, 0, 0]]),
        marker_side=f32(side), e_kf=e_kf.astype(np.int32),
        e_pt=e_pt.astype(np.int32), e_uv=f32(e_uv),
        e_info=f32(np.ones(K * L)), e_mask=f32(rng.random(K * L) > 0.1),
        m_kf=np.repeat(np.arange(K), 4).astype(np.int32),
        m_marker=np.zeros(4 * K, np.int32),
        m_corner=np.tile(np.arange(4), K).astype(np.int32),
        m_uv=f32(m_uv), m_info=f32(np.full(4 * K, 25.0)),
        m_mask=f32(np.ones(4 * K)),
        cam_free=f32([0, 1, 1, 1]), pt_free=f32(np.ones(L)),
        marker_free=f32([1, 0]))
    cam = dict(fx=f, fy=f, cx=c, cy=c, dist=np.zeros(5), width=400,
               height=400)
    return prob, cam


def test_dense_ba_matches_jax():
    rng = np.random.default_rng(3)
    prob, cam = _ba_problem(rng)
    jc = jcam.Camera(**{k: (jnp.float32(v) if k in ("fx", "fy", "cx", "cy")
                            else v) for k, v in cam.items()})
    tc = tcam.camera_from_numpy(cam)
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()})
    pt = tba.BAProblem(**{k: _t(v) for k, v in prob.items()})
    oj = jba.ba_solve(pj, jc, iters=10, lam0=1e-4)
    ot = tba.ba_solve(pt, tc, iters=10, lam0=1e-4)
    assert float(oj.chi2) < 0.5 * float(jba._total_chi2(pj, jc)[0])
    np.testing.assert_allclose(float(ot.chi2), float(oj.chi2), rtol=1e-3)
    _close(ot.Rcw, oj.Rcw, atol=1e-3, rtol=0)
    _close(ot.tcw, oj.tcw, atol=1e-3, rtol=0)
    _close(ot.twm, oj.twm, atol=1e-3, rtol=0)
    _close(ot.points, oj.points, atol=1e-3, rtol=0)
    # the CG branch (the post-loop global BA's, K > 32) on the same
    # problem: the JAX CG's optimum (tests/test_torch_loop.py holds it on
    # a 40-camera problem too)
    oj = jba.ba_solve(pj, jc, iters=10, lam0=1e-4, solver="cg")
    ot = tba.ba_solve(pt, tc, iters=10, lam0=1e-4, solver="cg")
    np.testing.assert_allclose(float(ot.chi2), float(oj.chi2), rtol=1e-3)
    _close(ot.Rcw, oj.Rcw, atol=1e-3, rtol=0)
    _close(ot.tcw, oj.tcw, atol=1e-3, rtol=0)
    _close(ot.points, oj.points, atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# mapping functions on the ref_small map
# ---------------------------------------------------------------------------


def _inserted(ctx):
    """Both maps after create_keyframe of frame 3 (a mid-point frame) at
    its marker pose, with the matches of track_vs_keyframe as its
    observations."""
    cfg, tcfg = ctx["cfg"], ctx["tcfg"]
    jm, tm, kf = ctx["jmap"], ctx["tmap"], ctx["kf"]
    jf, tf = ctx["jframes"][3], ctx["tframes"][3]
    sj = jtrack.bind_markers(jm, jf)
    _, R0, t0, _ = jtrack.aruco_pose_candidate(jm, jf, sj, ctx["jc"], cfg)
    tr = jtrack.track_vs_keyframe(jm, jf, sj, kf, R0, t0, ctx["jc"], cfg)
    slot = int(np.flatnonzero(~np.asarray(jm.kf_valid))[0])
    mk_old = jtrack.old_marker_flags(jm, sj, 10)
    jm2, _ = jmap.create_keyframe(jm, jf, tr.Rcw, tr.tcw, tr.obs_point, sj,
                                  99, 3.3, ctx["jc"], cfg, mk_old=mk_old,
                                  slot=slot)
    tm2, k = tmap.create_keyframe(tm, tf, _t(tr.Rcw), _t(tr.tcw),
                                  _t(tr.obs_point), _t(sj), 99, 3.3,
                                  ctx["tc"], tcfg, mk_old=_t(mk_old),
                                  slot=slot)
    return jm2, tm2, slot


def test_create_keyframe_and_triangulation_match_jax(ctx):
    """create_keyframe, the two-view triangulation against one neighbour,
    and the covisible triangulation: every neighbour's candidate set, then
    the one allocation pass on identical candidates. A candidate may flip
    only where its parallax cosine lies within 1e-6 of the 0.9999 gate
    (the DLT's float32 rounding); the covisible run's point count then
    differs by at most the number of such flips."""
    cfg, tcfg, kf = ctx["cfg"], ctx["tcfg"], ctx["kf"]
    jc, tc = ctx["jc"], ctx["tc"]
    jm2, tm2, slot = _inserted(ctx)
    _assert_maps(tm2, jm2)
    jm3, nj = jmap.triangulate_new_points(jm2, slot, kf, jc, cfg,
                                          max_new=256)
    tm3, nt = tmap.triangulate_new_points(tm2, slot, kf, tc, tcfg,
                                          max_new=256)
    assert int(nt) == int(nj) > 10
    _assert_maps(tm3, jm3, close=("pt_xyz", "pt_normal", "pt_min_dist",
                                  "pt_max_dist"), atol=1e-4)
    flips = 0
    for nb in np.flatnonzero(np.asarray(jm2.kf_valid)):
        if nb == slot:
            continue
        gj, xj, pj, cj = (np.asarray(a) for a in jmap._tri_candidates(
            jm2, slot, int(nb), jc, cfg, jnp.asarray(True)))
        gt, xt, pt, ct = (_n(a) for a in tmap._tri_candidates(
            tm2, slot, torch.tensor([int(nb)]), tc, tcfg,
            torch.tensor(True)))
        np.testing.assert_array_equal(pt, pj)
        d = np.flatnonzero(gt != gj)
        assert (np.abs(cj[d] - 0.9999) < 1e-6).all(), (nb, d, cj[d])
        flips += len(d)
        both = gt & gj
        _close(xt[both], xj[both], atol=1e-4, rtol=1e-3)
        # the allocation pass on the JAX candidates
        nbs = np.full(gj.shape, int(nb), np.int32)
        ja, cja = jmap._allocate_points(jm2, slot, nbs, pj, gj, xj, jc, cfg,
                                        256)
        ta, cta = tmap._allocate_points(tm2, slot, _t(nbs), _t(pj), _t(gj),
                                        _t(xj), tcfg, 256)
        assert int(cta) == int(cja)
        _assert_maps(ta, ja, close=("pt_xyz", "pt_normal", "pt_min_dist",
                                    "pt_max_dist"), atol=1e-5)
    jm4, nj = jmap.triangulate_vs_covisible(jm2, slot, jc, cfg,
                                            n_neighbors=20, max_new=256)
    tm4, nt = tmap.triangulate_vs_covisible(tm2, slot, tc, tcfg,
                                            n_neighbors=20, max_new=256)
    assert int(nj) > 10 and abs(int(nt) - int(nj)) <= flips
    if flips == 0:
        _assert_maps(tm4, jm4, close=("pt_xyz", "pt_normal", "pt_min_dist",
                                      "pt_max_dist"), atol=1e-4)


def test_point_maintenance_matches_jax(ctx):
    """cull_points, fuse_duplicates, update_point_stats and
    distinctive_descriptors (one keyframe and the whole map)."""
    cfg, tcfg, kf = ctx["cfg"], ctx["tcfg"], ctx["kf"]
    jm, tm = ctx["jmap"], ctx["tmap"]
    jm1, cj = jmap.cull_points(jm, 0.25)
    tm1, ct = tmap.cull_points(tm, 0.25)
    assert int(ct) == int(cj)
    _assert_maps(tm1, jm1)
    for radius in (0.05, 0.5):
        jm2, fj, mj = jmap.fuse_duplicates(jm, kf, ctx["jc"], cfg,
                                           radius_scale=radius)
        tm2, ft, mt = tmap.fuse_duplicates(tm, kf, ctx["tc"], tcfg,
                                           radius_scale=radius)
        assert int(ft) == int(fj)
        np.testing.assert_array_equal(_n(mt), np.asarray(mj))
        _assert_maps(tm2, jm2, close=("pt_found", "pt_visible"))
    assert int(fj) > 0                      # the wide radius merges some
    _assert_maps(tmap.update_point_stats(tm, tcfg),
                 jmap.update_point_stats(jm, cfg), close=("pt_normal",))
    for k in (kf, None):
        _assert_maps(tmap.distinctive_descriptors(tm, tcfg, kf=k),
                     jmap.distinctive_descriptors(jm, cfg, kf=k))


def _degenerate_markers(jm, kf):
    """Observation slots a of keyframe kf with a degenerate plane hypothesis:
    5 drawn points (with replacement, as mapping.py:1015 draws them) whose
    covariance has two zero eigenvalues, so its smallest-eigenvalue
    eigenvector is any unit vector of a plane (ROADMAP C2)."""
    obs = np.asarray(jm.kf_obs_point[kf])
    ok = ((obs >= 0) & np.asarray(jm.kf_kp_valid[kf])
          & np.asarray(jm.pt_valid)[np.maximum(obs, 0)])
    X = np.asarray(jm.pt_xyz)[np.maximum(obs, 0)].astype(np.float64)
    w0 = np.asarray(jax.vmap(lambda q: jmap._point_in_quad(
        jm.kf_kp_uv[kf], jnp.broadcast_to(q, (obs.shape[0], 4, 2))))(
        jm.kf_mk_uv[kf])) & ok[None]
    A = w0.shape[0]
    mask = w0 | ~w0.any(axis=1, keepdims=True)
    samp = threefry.categorical_masked_argmax(
        threefry.fold_in(threefry.PRNGKey(17), kf),
        torch.as_tensor(mask)[:, None, :],
        (A, tmap.PLANE_HYPOTHESES, 5)).numpy()
    P = X[samp]
    d = P - P.mean(axis=2, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("ahki,ahkj->ahij", d, d))
    return (ev[..., 1] <= 1e-9 * np.maximum(ev[..., 2], 1e-30)).any(axis=1)


def test_aruco_plane_update_matches_jax(ctx):
    """The marker plane RANSAC on every keyframe of the map, as recorded
    and with scale_done cleared (the one-shot rescale path). Integer and
    boolean outputs equal. Each marker's measured side length within 1e-4
    relative, except on markers that had a degenerate hypothesis
    (`_degenerate_markers`): its normal is any vector of a plane, and
    LAPACK builds differ in which they return, so such a hypothesis may
    win in one package and lose in the other."""
    cfg, tcfg = ctx["cfg"], ctx["tcfg"]
    jm, tm = ctx["jmap"], ctx["tmap"]
    n_exact = n_free = 0
    for scale_done in (True, False):
        jmi = jm._replace(scale_done=jnp.asarray(scale_done))
        tmi = tm._replace(scale_done=torch.tensor(scale_done))
        for kf in np.flatnonzero(np.asarray(jm.kf_valid)):
            jm2, sj = jmap.aruco_plane_update(jmi, int(kf), ctx["jc"], cfg)
            tm2, st = tmap.aruco_plane_update(tmi, int(kf), ctx["tc"], tcfg)
            got = tstate.state_to_numpy(tm2)
            for f in ("pt_aruco", "mk_len_cnt", "mk_well", "mk_nbad",
                      "mk_valid", "scale_done"):
                np.testing.assert_array_equal(
                    got[f], np.asarray(getattr(jm2, f)), err_msg=f)
            slots = np.asarray(jm.kf_mk_slot[kf])
            deg = _degenerate_markers(jm, int(kf))
            lj = np.asarray(jm2.mk_mean_len) / float(sj)
            lt = got["mk_mean_len"] / float(st)
            close = np.isclose(lt, lj, rtol=RTOL, atol=1e-6)
            free = np.zeros_like(close)
            free[slots[(slots >= 0) & deg]] = True
            assert (close | free).all(), (kf, lt, lj)
            n_exact += int((close & ~free).sum())
            n_free += int(free.sum())
            if np.isclose(lt, lj, rtol=RTOL, atol=1e-6).all():
                np.testing.assert_allclose(float(st), float(sj), rtol=RTOL)
            # the rescaled fields are the inputs times each package's s
            for f in ("pt_xyz", "kf_tcw", "mk_twm", "pt_min_dist",
                      "pt_max_dist"):
                _close(got[f] / float(st), np.asarray(getattr(jm, f)),
                       atol=1e-5)
                _close(np.asarray(getattr(jm2, f)) / float(sj),
                       np.asarray(getattr(jm, f)), atol=1e-5)
    assert n_exact > n_free


def test_local_bundle_adjust_and_cull_keyframes_match_jax(ctx):
    cfg, tcfg, kf = ctx["cfg"], ctx["tcfg"], ctx["kf"]
    jm, tm = ctx["jmap"], ctx["tmap"]
    kw = dict(max_cams=cfg.map.local_ba_window, max_pts=2048,
              max_fixed=cfg.map.local_ba_fixed_ring)
    pj = jmap.build_ba_problem(jm, kf, cfg, **kw)
    pt = tmap.build_ba_problem(tm, kf, tcfg, **kw)
    for a, b, f in zip(pt[0], pj[0], pj[0]._fields):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=f)
    for a, b in zip(pt[1:], pj[1:]):
        np.testing.assert_array_equal(_n(a), np.asarray(b))
    jm2, cj = jmap.bundle_adjust(jm, kf, ctx["jc"], cfg, iters=10, **kw)
    tm2, ct = tmap.bundle_adjust(tm, kf, ctx["tc"], tcfg, iters=10, **kw)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3)
    got = tstate.state_to_numpy(tm2)
    for f in ("kf_Rcw", "kf_tcw", "mk_Rwm", "mk_twm"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jm2, f)),
                                   atol=1e-3, err_msg=f)
    # no edge's chi2 in this problem lies near the 5.991 gate: the erased
    # observations are equal
    for f in ("kf_obs_point", "pt_obs_kf", "pt_valid"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jm2, f)),
                                      err_msg=f)
    for force in (False, True):
        jm3, vj = jmap.cull_keyframes(jm, kf, cfg, force=force)
        tm3, vt = tmap.cull_keyframes(tm, kf, tcfg, force=force)
        assert int(vt) == int(vj)
        _assert_maps(tm3, jm3)
    # with every keyframe protected or redundant-free: a forced eviction
    # of the least protected one once the rare-marker rule is lifted
    lifted = dataclasses.replace(cfg.map, kf_cull_marker_min_obs=0)
    jm3, vj = jmap.cull_keyframes(jm, kf, cfg.replace(map=lifted), force=True)
    tm3, vt = tmap.cull_keyframes(
        tm, kf, tcfg.replace(map=dataclasses.replace(
            tcfg.map, kf_cull_marker_min_obs=0)), force=True)
    assert int(vt) == int(vj) >= 0
    _assert_maps(tm3, jm3)
