"""Loop closing of the port against the JAX package on the same inputs:
optim/sim3_opt, optim/pose_graph, the CG branch of optim/ba and every
function of pipeline/loop_closing (on tests/test_loop.py's drifted map).

Stated tolerances: optimize_sim3 within 1e-4 (s, R entries, t) with equal
inlier sets; optimize_pose_graph poses within 1e-4 and chi2 within 1e-3
relative (plus 1e-6); ba_solve(solver="cg") chi2 within 1e-3 relative of
the JAX CG and poses within 1e-4; loop detection, keep flags, loop tables
and every integer field equal; compute_sim3 / compute_sim3_classic within
1e-3 (s, R entries, t) with equal verdicts; correct_loop's keyframe and
marker poses within 1e-3 and points within 1e-3 (each a chain of Sim3 LM,
a 20-iteration pose graph and IPPE, in float32 on two backends).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu.geometry import camera as jcam
from orb_slam2_aruco_tpu.geometry import lie as jlie
from orb_slam2_aruco_tpu.optim import ba as jba
from orb_slam2_aruco_tpu.optim import pose_graph as jpg
from orb_slam2_aruco_tpu.optim import sim3_opt as jsim3
from orb_slam2_aruco_tpu.pipeline import loop_closing as jlc
from orb_slam2_aruco_tpu.worldmap.retrieval import bow_vector
from orb_slam2_aruco_tpu_torch import config as tconfig
from orb_slam2_aruco_tpu_torch.geometry import camera as tcam
from orb_slam2_aruco_tpu_torch.optim import ba as tba
from orb_slam2_aruco_tpu_torch.optim import pose_graph as tpg
from orb_slam2_aruco_tpu_torch.optim import sim3_opt as tsim3
from orb_slam2_aruco_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_aruco_tpu_torch.worldmap import state as tstate

from test_loop import build_drifted_map
from test_optim import CAM, make_scene
from test_torch_slam import _close, _n, _t

TCAM = tcam.camera_from_numpy({k: np.asarray(v)
                               for k, v in CAM._asdict().items()})


def _tcam(jc):
    return tcam.camera_from_numpy({k: np.asarray(v)
                                   for k, v in jc._asdict().items()})


def _port_state(js):
    return tstate.state_from_numpy({f: np.asarray(getattr(js, f))
                                    for f in js._fields})


def _tcfg(cfg):
    return tconfig.SlamConfig.from_dict(dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fix_scale,outliers", [(False, 0), (True, 12)])
def test_optimize_sim3_matches_jax(fix_scale, outliers):
    """tests/test_optim.py::test_sim3_opt_recovers's problem, and with
    scale fixed and a few outlier observations."""
    rng = np.random.default_rng(0)
    n = 80
    p2 = np.asarray(make_scene(rng, n, depth=(3.0, 6.0)))
    s_true = jnp.float32(1.0 if fix_scale else 1.3)
    R_true = jlie.so3_exp(jnp.asarray([0.1, 0.2, -0.05]))
    t_true = jnp.asarray([0.4, -0.2, 0.3])
    p1 = np.asarray(jlie.sim3_apply(s_true[None], R_true, t_true,
                                    jnp.asarray(p2)))
    uv1 = np.array(jcam.project(CAM, jnp.asarray(p1)))
    uv2 = np.asarray(jcam.project(CAM, jnp.asarray(p2)))
    uv1[:outliers] += 40.0
    ones = np.ones(n, np.float32)
    info2 = (1.0 / 1.44 ** rng.integers(0, 3, n)).astype(np.float32)
    t0 = np.asarray([0.3, -0.1, 0.2], np.float32)
    args = (p1, p2, uv1, uv2, ones, ones, info2)
    want = jsim3.optimize_sim3(jnp.float32(1.0), jnp.eye(3), jnp.asarray(t0),
                               *(jnp.asarray(a) for a in args), CAM,
                               fix_scale=fix_scale)
    got = tsim3.optimize_sim3(torch.ones(()), torch.eye(3), _t(t0),
                              *(_t(a) for a in args), TCAM,
                              fix_scale=fix_scale)
    np.testing.assert_array_equal(_n(got.inliers), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) == n - outliers
    for a, b in zip((got.s, got.R, got.t), (want.s, want.R, want.t)):
        _close(a, b, atol=1e-4, rtol=0)


def _pose_graph_problem(rng, K=12):
    """tests/test_optim.py::test_pose_graph_closes_loop's ring."""
    angles = np.linspace(0, 2 * np.pi, K, endpoint=False)
    R_true = jnp.stack([jlie.so3_exp(jnp.asarray([0.0, float(a), 0.0]))
                        for a in angles])
    t_true = jnp.stack([-(R_true[k] @ jnp.asarray(
        [np.cos(a), 0.0, np.sin(a)], jnp.float32))
        for k, a in enumerate(angles)])
    s_true = jnp.ones(K)

    def rel(i, j):
        si, Ri, ti = jlie.sim3_inverse(s_true[i], R_true[i], t_true[i])
        return jlie.sim3_compose(s_true[j], R_true[j], t_true[j], si, Ri, ti)

    e_i = [k + 1 for k in range(K - 1)] + [0]
    e_j = [k for k in range(K - 1)] + [K - 1]
    meas = [rel(i, j) for i, j in zip(e_i, e_j)]
    s0, R0, t0 = [jnp.float32(1.0)], [R_true[0]], [t_true[0]]
    for k in range(1, K):
        sm_, Rm_, tm_ = rel(k - 1, k)
        ds, dR, dt = jlie.sim3_exp(jnp.asarray(rng.normal(size=7) * 0.03,
                                               jnp.float32))
        sm_n, Rm_n, tm_n = jlie.sim3_compose(sm_, Rm_, tm_, ds, dR, dt)
        sk, Rk, tk = jlie.sim3_compose(sm_n, Rm_n, tm_n, s0[-1], R0[-1],
                                       t0[-1])
        s0.append(sk), R0.append(Rk), t0.append(tk)
    return [np.asarray(a) for a in (
        jnp.stack(s0), jnp.stack(R0), jnp.stack(t0),
        jnp.asarray(e_i, jnp.int32), jnp.asarray(e_j, jnp.int32),
        jnp.stack([m[0] for m in meas]), jnp.stack([m[1] for m in meas]),
        jnp.stack([m[2] for m in meas]), jnp.ones(len(meas)),
        jnp.ones(K).at[0].set(0.0))]


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_pose_graph_matches_jax(fix_scale):
    prob = _pose_graph_problem(np.random.default_rng(0))
    want = jpg.optimize_pose_graph(*(jnp.asarray(a) for a in prob), iters=30,
                                   fix_scale=fix_scale)
    got = tpg.optimize_pose_graph(*(_t(a) for a in prob), iters=30,
                                  fix_scale=fix_scale)
    for a, b in zip((got.s, got.R, got.t), (want.s, want.R, want.t)):
        _close(a, b, atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3,
                               atol=1e-6)
    if not fix_scale:
        assert float(got.chi2) < 1e-3


def _cg_problem():
    """tests/test_optim.py::test_ba_cg_matches_dense's problem: 40 cameras,
    600 points, 120 observations per camera."""
    rng = np.random.default_rng(3)
    K, L = 40, 600
    pts = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                    rng.uniform(4, 8, L)], axis=-1).astype(np.float32)
    Rs, ts, e_kf, e_pt, e_uv = [], [], [], [], []
    for k in range(K):
        ang = 0.02 * rng.normal(size=3)
        R = np.asarray(jlie.so3_exp(jnp.asarray(ang, dtype=jnp.float32)))
        t = np.asarray([0.08 * k, 0.0, 0.0], dtype=np.float32)
        Rs.append(R)
        ts.append(t)
        pc = pts @ R.T + t
        uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                       CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], axis=-1)
        sel = rng.permutation(L)[:120]
        e_kf += [k] * len(sel)
        e_pt += sel.tolist()
        e_uv += (uv[sel] + rng.normal(0, 0.3, (len(sel), 2))).tolist()
    E = len(e_kf)
    t_noisy = np.asarray(ts) + rng.normal(0, 0.01, (K, 3)).astype(np.float32)
    t_noisy[0] = ts[0]
    pts_noisy = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    M = 2
    f32 = np.float32
    return dict(
        Rcw=np.asarray(Rs, f32), tcw=t_noisy.astype(f32),
        points=pts_noisy.astype(f32),
        Rwm=np.broadcast_to(np.eye(3, dtype=f32), (M, 3, 3)).copy(),
        twm=np.zeros((M, 3), f32), marker_side=np.full((M,), 0.165, f32),
        e_kf=np.asarray(e_kf, np.int32), e_pt=np.asarray(e_pt, np.int32),
        e_uv=np.asarray(e_uv, f32), e_info=np.ones((E,), f32),
        e_mask=np.ones((E,), f32), m_kf=np.zeros((8,), np.int32),
        m_marker=np.zeros((8,), np.int32),
        m_corner=np.tile(np.arange(4, dtype=np.int32), 2),
        m_uv=np.zeros((8, 2), f32), m_info=np.ones((8,), f32),
        m_mask=np.zeros((8,), f32),
        cam_free=np.r_[0.0, np.ones(K - 1)].astype(f32),
        pt_free=np.ones((L,), f32), marker_free=np.zeros((M,), f32))


def test_ba_cg_branch_matches_jax():
    """The matrix-free PCG branch (the post-loop global BA's) against the
    JAX CG on the same problem; "auto" takes it beyond 32 cameras and
    reaches the dense branch's optimum."""
    prob = _cg_problem()
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()})
    pt = tba.BAProblem(**{k: _t(v) for k, v in prob.items()})
    want = jba.ba_solve(pj, CAM, iters=8, solver="cg")
    got = tba.ba_solve(pt, TCAM, iters=8, solver="cg")
    chi0 = float(jba._total_chi2(pj, CAM)[0])
    assert float(want.chi2) < 0.1 * chi0
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3)
    _close(got.Rcw, want.Rcw, atol=1e-4, rtol=0)
    _close(got.tcw, want.tcw, atol=1e-4, rtol=0)
    auto = tba.ba_solve(pt, TCAM, iters=8)
    np.testing.assert_array_equal(_n(auto.tcw), _n(got.tcw))
    dense = tba.ba_solve(pt, TCAM, iters=8, solver="dense")
    assert float(got.chi2) <= 1.2 * float(dense.chi2)
    with pytest.raises(ValueError, match="solver"):
        tba.ba_solve(pt, TCAM, solver="sparse")


# ---------------------------------------------------------------------------
# loop closing on tests/test_loop.py's drifted map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drifted():
    cfg, jc, js, truth, _ = build_drifted_map(np.random.default_rng(0))
    return cfg, _tcfg(cfg), jc, _tcam(jc), js, _port_state(js), truth


def _assert_detection(got, want):
    assert bool(got.found) == bool(want.found)
    assert int(got.kf_loop) == int(want.kf_loop)
    assert int(got.marker_slot) == int(want.marker_slot)


def _assert_sim3(got, want, atol=1e-3):
    assert bool(got.ok) == bool(want.ok)
    for a, b in zip((got.s, got.R, got.t), (want.s, want.R, want.t)):
        _close(a, b, atol=atol, rtol=0)


def _corners(Rwm, twm, side):
    """World marker corners [M, 4, 3] (x, y in the marker plane)."""
    c = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]],
                 np.float32)
    return (np.einsum("mij,ckj->mci", Rwm, c[None] * side[:, None, None] / 2)
            + twm[:, None])


def _assert_corrected(tm, jm, atol=1e-3):
    """The corrected maps: poses and points within atol; markers by their
    world corners (a fronto-parallel marker's tilt is unobservable in
    float32: both IPPE solutions reproject within 1e-12 px^2, and the JAX
    package's eager and compiled IPPE pick tilts 7e-3 rad apart, 0.6 mm at
    the corners); every other field equal."""
    got = tstate.state_to_numpy(tm)
    for f in jm._fields:
        w = np.asarray(getattr(jm, f))
        if f in ("kf_Rcw", "kf_tcw", "pt_xyz"):
            np.testing.assert_allclose(got[f], w, atol=atol, err_msg=f)
        elif f in ("mk_Rwm", "mk_twm"):
            continue
        else:
            np.testing.assert_array_equal(_n(got[f]), _n(w), err_msg=f)
    side = np.asarray(jm.mk_side)
    np.testing.assert_allclose(
        _corners(got["mk_Rwm"], got["mk_twm"], side),
        _corners(np.asarray(jm.mk_Rwm), np.asarray(jm.mk_twm), side),
        atol=atol)


def test_marker_loop_sim3_and_correction_match_jax(drifted):
    cfg, tcfg, jc, tc, js, ts, truth = drifted
    k = 13
    want = jlc.detect_loop_by_marker(js, jnp.asarray(k), min_gap=5)
    got = tlc.detect_loop_by_marker(ts, k, min_gap=5)
    _assert_detection(got, want)
    assert bool(got.found) and int(got.kf_loop) == 0
    cw = jlc.compute_sim3(js, jnp.asarray(k), want.kf_loop, want.marker_slot,
                          jc, cfg)
    ct = tlc.compute_sim3(ts, k, int(got.kf_loop), int(got.marker_slot), tc,
                          tcfg)
    _assert_sim3(ct, cw)
    assert bool(ct.ok)
    jm, chi_j = jlc.correct_loop(js, jnp.asarray(k), want.kf_loop, cw.s, cw.R,
                                 cw.t, jc, cfg)
    tm, chi_t = tlc.correct_loop(ts, k, 0, ct.s, ct.R, ct.t, tc, tcfg)
    _assert_corrected(tm, jm)
    # and the drift is gone, as tests/test_loop.py asks of the JAX package
    t_true = np.asarray(truth[1])
    assert (np.linalg.norm(_n(tm.kf_tcw[k]) - t_true[k])
            < 0.5 * np.linalg.norm(np.asarray(js.kf_tcw[k]) - t_true[k]))
    # no loop without the marker observation
    js2 = js._replace(kf_mk_valid=js.kf_mk_valid.at[k, 0].set(False))
    ts2 = ts._replace(kf_mk_valid=_t(np.asarray(js2.kf_mk_valid)))
    _assert_detection(tlc.detect_loop_by_marker(ts2, k, min_gap=5),
                      jlc.detect_loop_by_marker(js2, jnp.asarray(k),
                                                min_gap=5))


def test_bow_loop_and_classic_sim3_match_jax(drifted):
    """The appearance path (tests/test_loop.py::
    test_bow_loop_detection_and_classic_sim3): BoW signatures, no marker
    signal; detect_loops, the consistency gate, the classic Sim3 (its
    jax.random.choice draw bit for bit) and the correction."""
    cfg, tcfg, jc, tc, js, _, _ = drifted
    k = 13
    for kf in range(14):
        js = js._replace(kf_bow=js.kf_bow.at[kf].set(bow_vector(
            js.kf_desc[kf], js.kf_kp_valid[kf], cfg.retrieval.num_words)))
    js = js._replace(kf_mk_valid=js.kf_mk_valid.at[k, 0].set(False))
    ts = _port_state(js)
    want = jlc.detect_loops(js, jnp.asarray(k), min_gap=5)
    got = tlc.detect_loops(ts, k, min_gap=5)
    for g, w in zip(got, want):
        _assert_detection(g, w)
    assert not bool(got[0].found) and bool(got[1].found)
    kf_loop = int(got[1].kf_loop)
    cw = jlc.compute_sim3_classic(js, jnp.asarray(k), jnp.asarray(kf_loop),
                                  jc, cfg)
    ct = tlc.compute_sim3_classic(ts, k, kf_loop, tc, tcfg)
    _assert_sim3(ct, cw)
    assert bool(ct.ok)
    assert int(ct.n_inliers) == int(cw.n_inliers)
    jm, _ = jlc.correct_loop(js, jnp.asarray(k), jnp.asarray(kf_loop), cw.s,
                             cw.R, cw.t, jc, cfg)
    tm, _ = tlc.correct_loop(ts, k, kf_loop, ct.s, ct.R, ct.t, tc, tcfg)
    _assert_corrected(tm, jm)
    # the consistency gate and its covisibility reads
    want_row = np.asarray(jlc.covis_row(js, jnp.asarray(3)))
    np.testing.assert_array_equal(_n(tlc.covis_row(ts, 3)), want_row)
    assert int(tlc.covis_weight(ts, 3, 4)) == int(
        jlc.covis_weight(js, jnp.asarray(3), jnp.asarray(4)))
    gj, gt = jlc.ConsistencyTracker(3), tlc.ConsistencyTracker(3)
    for cand in (0, 1, 0, 9, 1, 2, 2, 0):
        assert gt.update(ts, cand) == gj.update(js, cand), cand


def test_covis_edge_set_matches_jax():
    """tests/test_loop.py::test_covis_edge_set_matches_direct_count's
    graph, with a stored loop edge and an empty table row."""
    rng = np.random.default_rng(0)
    K = 24
    W = np.triu(rng.integers(0, 200, size=(K, K)), 1)
    W = (W + W.T).astype(np.int32)
    valid = rng.random(K) > 0.2
    chain = (np.arange(K) - 1).astype(np.int32)
    chain[0] = 0
    li = np.asarray([3, 0], np.int32)
    lj = np.asarray([17, 0], np.int32)
    lv = np.asarray([True, False])
    want = jlc.covis_edge_set(*(jnp.asarray(a) for a in
                                (W, valid, chain, li, lj, lv)), 100)
    got = tlc.covis_edge_set(*(_t(a) for a in (W, valid, chain, li, lj, lv)),
                             100)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b))


def test_second_loop_keeps_the_stored_edge_like_jax(drifted):
    """tests/test_loop.py::test_persistent_loop_edges_protect_old_seam: a
    second correction with a conflicting Sim3 over the stored first loop
    edge gives the JAX package's map and loop table."""
    cfg, tcfg, jc, tc, js, ts, _ = drifted
    k = 13
    cw = jlc.compute_sim3(js, jnp.asarray(k), jnp.asarray(0), jnp.asarray(0),
                          jc, cfg)
    js1, _ = jlc.correct_loop(js, jnp.asarray(k), jnp.asarray(0), cw.s, cw.R,
                              cw.t, jc, cfg)
    ts1 = _port_state(js1)
    R1i, t1i = jlie.se3_inverse(js1.kf_Rcw[1], js1.kf_tcw[1])
    R_rel, t_rel = jlie.se3_compose(js1.kf_Rcw[12], js1.kf_tcw[12], R1i, t1i)
    R_rel2 = jlie.so3_exp(jnp.asarray([0.0, 0.04, 0.0])) @ R_rel
    t_rel2 = t_rel + jnp.asarray([0.05, 0.0, 0.02])
    jm, _ = jlc.correct_loop(js1, jnp.asarray(12), jnp.asarray(1),
                             jnp.float32(1.0), R_rel2, t_rel2, jc, cfg)
    tm, _ = tlc.correct_loop(ts1, 12, 1, torch.ones(()), _t(R_rel2),
                             _t(t_rel2), tc, tcfg)
    _assert_corrected(tm, jm)
    assert int(tm.loop_valid.sum()) == 2
