"""graft_entry_torch.py — the port of __graft_entry__.py — against the JAX
file on the CPU.

The JAX side runs as its own tests run it: on the CPU, the distributed
solve on the virtual devices of tests/conftest.py. Stated tolerances:

  * make_gba_problem: index arrays bit-equal; every float within 1e-5
    relative to its array's scale (rotation entries, |R| <= 1: 1e-5
    absolute); the observations: the port's projection of JAX's own
    poses is JAX's bit for bit (the same fused multiply-add chain), and
    from its own poses (JAX's within a few float32 ulp: sin and cos of
    angles up to 13.7 rad) at most twice the share of values beyond 1e-5
    relative that JAX's own projection moves there when its poses move
    one ulp (edges near the z = 0.02 cut amplify a pose's ulp into
    pixels);
  * ba_solve, dense and CG, and distributed_ba_solve on 4 entries against
    JAX's on 4 virtual devices, on the generator's problem at K = 8: every
    edge 2.6 m or more in front of its camera, and the CG takes steps (from
    K = 12 on, both packages' CG stopping test, r'P r against 1e-8 b'b,
    holds before the first step and the cameras never move; at K = 40
    edges reach the z = 0.02 cut, where one ulp moves JAX's own solve by
    tens of percent): chi2 within 1e-5 of the chi2 before the solve, R 2e-4,
    t 2e-3 (tests/test_parallel.py:18-27), 98 % of the points within
    5e-3 (:93-98);
  * the capacity solve (K=256, L=20000, 256k edges) on the port against
    the recorded JAX solve with exact segment sums
    (data/ref_graft.npz, tests/test_torch_slice.py --graft): chi2 within
    twice what one ulp moves JAX's own solve (the recorded witness), R
    2e-4, t 2e-3, 98 % of the points within 5e-3;
  * entry()'s step against the recorded JAX step: valid keypoints,
    octaves and descriptors equal, pixels within 1e-3 px (JAX's float32
    undistortion gives 46.999996 where the port gives 47), n_inliers
    equal, pose within 0.2 deg / 1 cm.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_slice import GRAFT_PATH, REPO, _rot_err_deg

sys.path.insert(0, REPO)

import __graft_entry__ as jg  # noqa: E402
import chip_smoke  # noqa: E402
import graft_entry_torch as tg  # noqa: E402
from orb_slam2_aruco_tpu.geometry import lie as jlie  # noqa: E402
from orb_slam2_aruco_tpu.optim import ba as jba  # noqa: E402
from orb_slam2_aruco_tpu.parallel import dist_ba as jdist  # noqa: E402
from orb_slam2_aruco_tpu_torch.optim import ba as tba  # noqa: E402
from orb_slam2_aruco_tpu_torch.parallel import dist_ba as tdist  # noqa: E402

REL = 1e-5
DIST_R, DIST_T, DIST_PTS, DIST_SHARE = 2e-4, 2e-3, 5e-3, 0.98
SMALL_K, SMALL_L, SMALL_M = 8, 1500, 2
TOOLS = ("torch_scaling_bench", "torch_profile_mapping",
         "torch_prof_stream_host", "torch_profile_chunk", "torch_prof_common",
         "torch_prof_cascade_split")


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_beyond(a, b, rel=REL):
    """Bool mask of the values of a off b by more than rel of |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) > rel * np.abs(b)


@pytest.fixture(scope="module")
def ref():
    with np.load(GRAFT_PATH) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("shape", [(6, 300, 2), (256, 20000, 16)],
                         ids=["small", "full"])
def test_make_gba_problem_equals_jax(shape, monkeypatch):
    K, L, M = shape
    pj, cj = jg.make_gba_problem(K, L, M)
    pt, ct = tg.make_gba_problem(K, L, M, device="cpu")
    for f in tg.INDEX_FIELDS:
        np.testing.assert_array_equal(_n(getattr(pt, f)),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    assert tg.problem_digest(pt) == tg.problem_digest(pj)
    for f in ("fx", "fy", "cx", "cy"):
        assert float(getattr(ct, f)) == float(getattr(cj, f))
    for f in tba.BAProblem._fields:
        if f in tg.INDEX_FIELDS or f in ("e_uv", "m_uv"):
            continue
        b = np.asarray(getattr(pj, f))
        np.testing.assert_allclose(_n(getattr(pt, f)), b, rtol=0,
                                   atol=REL * max(np.abs(b).max(), 1e-30),
                                   err_msg=f)
    # the projection arithmetic is JAX's: the port's projection of JAX's
    # own poses and points gives JAX's observations, bit for bit
    Rj = torch.as_tensor(np.asarray(pj.Rcw))
    e_uv = tg._project(ct, Rj, pt.tcw, pt.e_kf,
                       torch.as_tensor(_xyz(K, L))[pt.e_pt])
    m_uv = tg._project(ct, Rj, pt.tcw, pt.m_kf,
                       _corners(pt).repeat(K, 1))
    np.testing.assert_array_equal(_n(e_uv), np.asarray(pj.e_uv))
    np.testing.assert_array_equal(_n(m_uv), np.asarray(pj.m_uv))
    # with the port's own poses: at most twice the share JAX's own
    # observations move beyond 1e-5 when its poses move one ulp
    orig = jlie.so3_exp
    monkeypatch.setattr(jlie, "so3_exp",
                        lambda w: jnp.nextafter(orig(w), jnp.inf))
    pj_ulp, _ = jg.make_gba_problem(K, L, M)
    for f in ("e_uv", "m_uv"):
        want = np.asarray(getattr(pj, f))
        got = _rel_beyond(_n(getattr(pt, f)), want).mean()
        witness = _rel_beyond(np.asarray(getattr(pj_ulp, f)), want).mean()
        assert got <= 2 * witness, (f, got, witness)


def _xyz(K, L, seed=0):
    """The generator's points (its first draws), as float32."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-2, 2, L), rng.uniform(-1, 1, L),
                     rng.uniform(3, 6, L)], axis=-1).astype(np.float32)


def _corners(pt):
    from orb_slam2_aruco_tpu_torch.optim.residuals import (
        marker_corner_points_world,
    )

    return marker_corner_points_world(pt.Rwm, pt.twm,
                                      pt.marker_side).reshape(-1, 3)


def _assert_solve_close(got, want, chi2_0):
    g = [_n(x) for x in (got.Rcw, got.tcw, got.points, got.chi2)]
    w = [_n(x) for x in (want.Rcw, want.tcw, want.points, want.chi2)]
    assert abs(float(g[3]) - float(w[3])) <= REL * chi2_0
    _, dR, dt, _, share = chip_smoke.solve_errors(g, w, DIST_PTS)
    assert dR <= DIST_R and dt <= DIST_T and share >= DIST_SHARE, (
        dR, dt, share)


def _small():
    pj, cj = jg.make_gba_problem(SMALL_K, SMALL_L, SMALL_M)
    pt, ct = tg.make_gba_problem(SMALL_K, SMALL_L, SMALL_M, device="cpu")
    return pj, cj, pt, ct, float(jba._total_chi2(pj, cj)[0])


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_ba_solve_matches_jax(solver):
    pj, cj, pt, ct, chi2_0 = _small()
    want = jba.ba_solve(pj, cj, iters=2, solver=solver)
    got = tba.ba_solve(pt, ct, iters=2, solver=solver)
    # the solve does work: chi2 falls by orders of magnitude, cameras move
    assert float(want.chi2) < 1e-3 * chi2_0
    assert float(np.abs(np.asarray(want.tcw - pj.tcw)).max()) > 1e-5
    _assert_solve_close(got, want, chi2_0)


def test_distributed_ba_solve_on_four_cpu_entries_matches_jax():
    pj, cj, pt, ct, chi2_0 = _small()
    want = jdist.distributed_ba_solve(pj, cj, jdist.make_mesh(4), iters=2)
    got = tdist.distributed_ba_solve(pt, ct, ["cpu"] * 4, iters=2)
    _assert_solve_close(got, want, chi2_0)
    _assert_solve_close(got, tba.ba_solve(pt, ct, iters=2), chi2_0)


def test_capacity_solves_match_the_recording(ref):
    """The port's single-device solve and dryrun_multichip on 4 CPU
    entries at K=256 / L=20000 / 256k edges against JAX's solves with
    exact segment sums (the recording's exact_*), within the witness
    limits; the problem's digest and chi2 before the solve are JAX's."""
    pt, ct = tg.make_gba_problem(tg.GBA_K, tg.GBA_L, tg.GBA_M, device="cpu")
    dig = tg.problem_digest(pt)
    assert [dig[f][0] for f in ref["prob_fields"]] == ref["prob_sums"].tolist()
    assert [dig[f][1] for f in ref["prob_fields"]] == ref["prob_sha"].tolist()
    chi2_0 = float(tba._total_chi2(pt, ct)[0])
    assert abs(chi2_0 - float(ref["prob_chi2_0"])) <= REL * chi2_0
    chi2_tol = 2 * float(ref["witness_chi2"])
    for got, pre in ((tba.ba_solve(pt, ct, iters=tg.DRYRUN_ITERS),
                      "exact_single_"),
                     (tg.dryrun_multichip(4, ["cpu"] * 4), "exact_dist8_")):
        err = chip_smoke.solve_errors(
            [_n(x) for x in (got.Rcw, got.tcw, got.points, got.chi2)],
            [ref[pre + k] for k in ("R", "t", "P", "chi2")], DIST_PTS)
        assert err[0] <= chi2_tol, (pre, err)
        assert err[1] <= DIST_R and err[2] <= DIST_T, (pre, err)
        assert err[4] >= DIST_SHARE, (pre, err)


def test_recording_holds_what_the_phase_relies_on(ref):
    """JAX's exact single and 8-device solves agree; its shipped single
    solve leaves the points where they were (both LM steps rejected); the
    witness is non-trivial."""
    err = chip_smoke.solve_errors(
        [ref["exact_dist8_" + k] for k in ("R", "t", "P", "chi2")],
        [ref["exact_single_" + k] for k in ("R", "t", "P", "chi2")])
    assert err[0] < 1e-5 and err[4] == 1.0
    assert float(ref["shipped_single_P_moved"]) == 0.0
    assert float(ref["shipped_single_chi2"]) == float(ref["prob_chi2_0"])
    assert 0 < float(ref["witness_chi2"]) and ref["witness_pts_share"] >= 0.98
    assert os.path.getsize(GRAFT_PATH) < 2**20


def test_entry_step_matches_the_recording(ref):
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    step, args = tg.entry("cpu")
    R, t, n_in = step(*args)
    cfg = tg._flagship_config()
    frame = make_frame(args[0], camera_from_config(cfg.camera, "cpu"), cfg)
    valid = _n(frame.kp_valid)
    np.testing.assert_array_equal(valid, ref["entry_valid"])
    np.testing.assert_array_equal(_n(frame.kp_octave)[valid],
                                  ref["entry_octave"])
    np.testing.assert_array_equal(_n(frame.desc)[valid], ref["entry_desc"])
    np.testing.assert_allclose(_n(frame.kp_uv)[valid], ref["entry_uv"],
                               rtol=0, atol=1e-3)
    assert int(n_in) == int(ref["entry_n_inliers"])
    assert _rot_err_deg(_n(R), ref["entry_R"]) <= 0.2
    assert np.linalg.norm(_n(t) - ref["entry_t"]) <= 0.01


def test_entry_inputs_are_the_jax_files():
    """The map's points and descriptors and the noise image come from the
    same draws as JAX's, bit for bit."""
    _, (img, state, R0, t0) = tg.entry("cpu")
    _, (jimg, jstate, jR0, jt0) = jg.entry()
    np.testing.assert_array_equal(_n(img), np.asarray(jimg))
    L = tg.ENTRY_POINTS
    np.testing.assert_array_equal(_n(state.pt_xyz), np.asarray(jstate.pt_xyz))
    np.testing.assert_array_equal(_n(state.pt_valid),
                                  np.asarray(jstate.pt_valid))
    np.testing.assert_array_equal(_n(state.pt_desc)[:L],
                                  np.asarray(jstate.pt_desc)[:L].view(
                                      np.int32))
    np.testing.assert_array_equal(_n(R0), np.asarray(jR0))
    np.testing.assert_array_equal(_n(t0), np.asarray(jt0))


def test_dryrun_refuses_a_short_mesh(monkeypatch):
    built = []
    monkeypatch.setattr(tg, "make_gba_problem",
                        lambda *a, **k: built.append(1))
    with pytest.raises(ValueError, match="the mesh has 2 entries"):
        tg.dryrun_multichip(8, ["cpu"] * 2)
    assert built == []


def test_raises_without_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tg.entry()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tg.make_gba_problem(6, 300, 2)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tg.dryrun_multichip(1)
    prob, _ = tg.make_gba_problem(6, 300, 2, device="cpu")
    assert prob.Rcw.device.type == "cpu"


def test_entry_point_and_tools_import_nothing_of_jax():
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["orb_slam2_aruco_tpu"] = None
sys.path.insert(0, "tools")
import graft_entry_torch
for name in {TOOLS!r}:
    __import__(name)
prob, cam = graft_entry_torch.make_gba_problem(6, 300, 2, device="cpu")
bad = [m for m in sys.modules if sys.modules[m] is not None and (
    m == "jax" or m.startswith("jax.") or m == "orb_slam2_aruco_tpu"
    or m.startswith("orb_slam2_aruco_tpu."))]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_graft_holds_refuse_departures(ref):
    """chip_smoke's graft holds: the recording passes itself; a pose 1e-3
    off, 5 % of the points 1 cm off, a chi2 beyond the witness limit, a
    changed descriptor and another n_inliers each fail."""
    import types

    want = tuple(ref["exact_single_" + k] for k in ("R", "t", "P", "chi2"))
    tol = 2 * float(ref["witness_chi2"])
    chip_smoke.hold_graft_solve("self", want, want, tol)
    R, t, P, chi2 = want
    P_off = P.copy()
    P_off[:len(P) // 20] += 0.01
    for bad in ((R + 1e-3, t, P, chi2), (R, t + 3e-3, P, chi2),
                (R, t, P_off, chi2), (R, t, P, chi2 * (1 + 1.01 * tol))):
        with pytest.raises(chip_smoke.PhaseError):
            chip_smoke.hold_graft_solve("bad", bad, want, tol)
    valid = ref["entry_valid"]
    n = len(valid)

    def frame(desc_flip=False):
        uv = np.zeros((n, 2), np.float32)
        uv[valid] = ref["entry_uv"]
        octave = np.zeros(n, np.int64)
        octave[valid] = ref["entry_octave"]
        desc = np.zeros((n, 8), np.int32)
        desc[valid] = ref["entry_desc"]
        if desc_flip:
            desc[np.flatnonzero(valid)[0], 0] ^= 1
        return types.SimpleNamespace(kp_valid=valid, kp_uv=uv,
                                     kp_octave=octave, desc=desc)

    good = (ref["entry_R"], ref["entry_t"], ref["entry_n_inliers"])
    chip_smoke.hold_graft_entry(ref, frame(), *good)
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.hold_graft_entry(ref, frame(desc_flip=True), *good)
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.hold_graft_entry(ref, frame(), good[0], good[1],
                                    int(good[2]) + 1)
