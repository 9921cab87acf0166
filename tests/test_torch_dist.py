"""The distributed global BA of the port against the JAX package:
parallel/dist_ba.py over a device list, the sharded form of
optim/ba.ba_solve, mapping.bundle_adjust_distributed, the system's
distributed GBA branch and optim/segsum.py.

The JAX side runs as its own tests run it: on the 8 virtual CPU devices of
tests/conftest.py. The port's counterpart of that mesh is `["cpu"] * 8`,
one controller summing the shards' partial sums.

Stated tolerances: partition_edges_by_point's permutation and the padded
problem equal to JAX's; a one-entry mesh equal to ba_solve bit for bit;
the sharded solve within JAX's own distributed-vs-single limits
(tests/test_parallel.py:18-27: R 2e-4, t 2e-3, points 5e-3) of the port's
single-device solve and of JAX's distributed_ba_solve, edge_chi2 in the
caller's order within 1e-3 relative (plus 1e-6) of the single solve's;
bundle_adjust_distributed against JAX's on ref_small's map within 1e-4
(poses, markers) and 1e-3 (points), chi2 within 1e-3 relative, equal
observation tables; the system's distributed branch over the loop step
and the drain within the loop limits (0.5 deg / 2 cm, points 5 %) of the
single-device branch; segment_sum_sorted within 1e-5 of JAX's.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu.optim import segsum as jsegsum
from orb_slam2_aruco_tpu.parallel import dist_ba as jdist
from orb_slam2_aruco_tpu_torch import config as tconfig
from orb_slam2_aruco_tpu_torch.optim import ba as tba
from orb_slam2_aruco_tpu_torch.optim import segsum as tsegsum
from orb_slam2_aruco_tpu_torch.parallel import dist_ba as tdist

from test_optim import CAM, _make_ba_problem
from test_torch_loop import TCAM, _cg_problem
from test_torch_loop_slice import (
    LOOP_POINTS,
    LOOP_ROT_DEG,
    LOOP_TRANS_M,
    _load_loop_step,
    loop_reference,
)
from test_torch_slam import _n, _t
from test_torch_slam_slice import _frame
from test_torch_slice import DATA_DIR, SETUPS, _rot_err_deg

DIST_R, DIST_T, DIST_PTS = 2e-4, 2e-3, 5e-3
CPU8 = ["cpu"] * 8

# (K, L, M, masked share): test_parallel's even and uneven problems, and
# the even one with a fifth of its point edges masked out
PROBLEMS = {"even": (4, 48, 2, 0.0), "uneven": (3, 30, 1, 0.0),
            "masked": (4, 48, 2, 0.2)}


def _problem(name):
    K, L, M, masked = PROBLEMS[name]
    rng = np.random.default_rng(0)
    prob, truth = _make_ba_problem(rng, K=K, L=L, M=M)
    if masked:
        mask = (rng.random(prob.e_mask.shape[0]) >= masked).astype(
            np.float32)
        prob = prob._replace(e_mask=jnp.asarray(mask))
    return prob, tba.BAProblem(*(_t(np.asarray(f)) for f in prob)), truth


def _assert_dist_close(got, want):
    np.testing.assert_allclose(_n(got.Rcw), _n(want.Rcw), atol=DIST_R)
    np.testing.assert_allclose(_n(got.tcw), _n(want.tcw), atol=DIST_T)
    np.testing.assert_allclose(_n(got.points), _n(want.points),
                               atol=DIST_PTS)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("n_shards", [3, 8])
def test_partition_edges_by_point_equals_jax(name, n_shards):
    pj, pt, _ = _problem(name)
    want, w_scatter = jdist.partition_edges_by_point(pj, n_shards)
    got, scatter = tdist.partition_edges_by_point(pt, n_shards)
    np.testing.assert_array_equal(scatter, w_scatter)
    want = jdist.pad_edges_to(want, n_shards)
    got = tdist.pad_edges_to(got, n_shards)
    for f, a, b in zip(tba.BAProblem._fields, got, want):
        np.testing.assert_array_equal(_n(a), np.asarray(b), err_msg=f)


def test_one_entry_mesh_is_ba_solve_bit_for_bit():
    for name in ("even", "masked"):
        _, pt, _ = _problem(name)
        single = tba.ba_solve(pt, TCAM, iters=8)
        for got in (tdist.distributed_ba_solve(pt, TCAM, ["cpu"], iters=8),
                    tba.ba_solve(pt, TCAM, iters=8, mesh=["cpu"])):
            for f, a, b in zip(tba.BAResult._fields, got, single):
                assert torch.equal(a, b), (name, f)
    prob = {k: _t(v) for k, v in _cg_problem().items()}
    pt = tba.BAProblem(**prob)
    single = tba.ba_solve(pt, TCAM, iters=4, solver="cg")
    got = tba.ba_solve(pt, TCAM, iters=4, solver="cg", mesh=["cpu"])
    for f, a, b in zip(tba.BAResult._fields, got, single):
        assert torch.equal(a, b), f


@pytest.mark.parametrize("name", ["even", "uneven", "masked"])
def test_distributed_ba_solve_on_eight_cpu_shards(name):
    pj, pt, truth = _problem(name)
    single = tba.ba_solve(pt, TCAM, iters=8)
    multi = tdist.distributed_ba_solve(pt, TCAM, CPU8, iters=8)
    _assert_dist_close(multi, single)
    jmulti = jdist.distributed_ba_solve(pj, CAM, jdist.make_mesh(8),
                                        iters=8)
    _assert_dist_close(multi, jmulti)
    np.testing.assert_allclose(_n(multi.Rcw), np.asarray(truth["R"]),
                               atol=2e-3)
    # edge_chi2 back in the caller's order
    assert multi.edge_chi2.shape == single.edge_chi2.shape
    np.testing.assert_allclose(_n(multi.edge_chi2), _n(single.edge_chi2),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(_n(multi.edge_chi2),
                               np.asarray(jmulti.edge_chi2), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("partitioned", [False, True])
def test_sharded_cg_matches_single(partitioned):
    """The CG branch (the post-loop global BA's) on 4 shards, its edges cut
    in their own order or partitioned by point."""
    prob = {k: _t(v) for k, v in _cg_problem().items()}
    pt = tba.BAProblem(**prob)
    single = tba.ba_solve(pt, TCAM, iters=6, solver="cg")
    if partitioned:
        pt2, scatter = tdist.partition_edges_by_point(pt, 4)
        pt2 = tdist.pad_edges_to(pt2, 4)
    else:
        pt2 = tdist.pad_edges_to(pt, 4)
    multi = tba.ba_solve(pt2, TCAM, iters=6, solver="cg", mesh=["cpu"] * 4)
    _assert_dist_close(multi, single)
    np.testing.assert_allclose(float(multi.chi2), float(single.chi2),
                               rtol=1e-3)
    with pytest.raises(ValueError, match="divide"):
        tba.ba_solve(pt, TCAM, iters=1, mesh=["cpu"] * 7)


def test_make_mesh():
    mesh = tdist.make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh == [torch.device("cpu")] * 3
    assert tdist.make_mesh(2, devices=CPU8) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.make_mesh(devices=["cuda"])


def test_bundle_adjust_distributed_matches_jax():
    """A global BA over ref_small's map (test_parallel.py:45's setting: 16
    camera slots, 2048 points, 4 LM iterations) sharded over 8 devices in
    both packages. Not the loop scene's map after its drain: there JAX's
    cumsum segment sums cancel and its steps are rejected (ROADMAP.md
    C2)."""
    from orb_slam2_aruco_tpu.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu.pipeline import mapping as jmapping
    from orb_slam2_aruco_tpu.worldmap.state import MapState as JMap
    from orb_slam2_aruco_tpu_torch.geometry.camera import (
        camera_from_config as tcamera_from_config,
    )
    from orb_slam2_aruco_tpu_torch.pipeline import mapping as tmapping
    from orb_slam2_aruco_tpu_torch.worldmap.state import (
        MapState as TMap,
        state_from_numpy,
    )

    with np.load(os.path.join(DATA_DIR, "ref_small.npz")) as z:
        arrays = {f: z[f] for f in TMap._fields}
        cfgd = json.loads(str(z["ref_cfg"]))
    jcfg = SETUPS["small"]()[0]
    tcfg = tconfig.SlamConfig.from_dict(cfgd)
    valid = np.flatnonzero(arrays["kf_valid"])
    k = int(valid[np.argmax(arrays["kf_frame_id"][valid])])
    kw = dict(max_cams=16, max_pts=2048, iters=4)
    jmap = JMap(**{f: jnp.asarray(v) for f, v in arrays.items()})
    want, wchi = jmapping.bundle_adjust_distributed(
        jmap, jnp.asarray(k), camera_from_config(jcfg.camera), jcfg,
        jdist.make_mesh(8), **kw)
    tcam_ = tcamera_from_config(tcfg.camera)
    got, chi = tmapping.bundle_adjust_distributed(
        state_from_numpy(arrays), k, tcam_, tcfg, CPU8, **kw)
    np.testing.assert_allclose(float(chi), float(wchi), rtol=1e-3)
    # the BA moved the map by far more than the tolerances
    assert np.abs(_n(got.pt_xyz) - arrays["pt_xyz"]).max() > 0.1
    for f in ("kf_Rcw", "kf_tcw", "mk_Rwm", "mk_twm"):
        np.testing.assert_allclose(_n(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=1e-4,
                                   err_msg=f)
    np.testing.assert_allclose(_n(got.pt_xyz), np.asarray(want.pt_xyz),
                               atol=1e-3)
    for f in ("kf_obs_point", "pt_obs_kf", "pt_valid"):
        np.testing.assert_array_equal(_n(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    # and against the port's single-device slice on the same map
    single, _ = tmapping.bundle_adjust(state_from_numpy(arrays), k, tcam_,
                                       tcfg, window_all=True, **kw)
    np.testing.assert_allclose(_n(got.kf_Rcw), _n(single.kf_Rcw), atol=DIST_R)
    np.testing.assert_allclose(_n(got.kf_tcw), _n(single.kf_tcw), atol=DIST_T)
    np.testing.assert_allclose(_n(got.pt_xyz), _n(single.pt_xyz),
                               atol=DIST_PTS)


def test_bundle_adjust_distributed_needs_the_map_device_first():
    """The solve's result lies on the mesh's first device and is written
    into the map: a mesh led by another device is refused before any
    work."""
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
    from orb_slam2_aruco_tpu_torch.pipeline import mapping as tmapping
    from orb_slam2_aruco_tpu_torch.worldmap.state import (
        MapState as TMap,
        state_from_numpy,
    )

    with np.load(os.path.join(DATA_DIR, "ref_small.npz")) as z:
        arrays = {f: z[f] for f in TMap._fields}
        cfg = tconfig.SlamConfig.from_dict(json.loads(str(z["ref_cfg"])))
    state = state_from_numpy(arrays)
    with pytest.raises(ValueError, match="lead device meta"):
        tmapping.bundle_adjust_distributed(
            state, 0, camera_from_config(cfg.camera), cfg, ["meta", "cpu"],
            max_cams=16, max_pts=2048, iters=1)


def test_system_takes_the_distributed_branch():
    """From the JAX system's state before the small scene's loop step: the
    step (its loop correction and first two GBA slices) and the drain with
    optim.distributed_gba over a 4-entry CPU mesh, against the
    single-device branch."""
    import dataclasses

    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem
    from test_torch_slice import LOOP_SNAPSHOT_STEP

    ref = loop_reference("small")
    base = tconfig.SlamConfig.from_dict(json.loads(str(ref["cfg"])))
    i = LOOP_SNAPSHOT_STEP["small"]
    out = {}
    for dist in (False, True):
        cfg = base.replace(optim=dataclasses.replace(
            base.optim, distributed_gba=dist))
        system = SlamSystem(cfg, device="cpu")
        if dist:
            system._gba_mesh = tdist.make_mesh(devices=["cpu"] * 4)
        snap = _load_loop_step(system, ref, 0)
        system.frame_id = i + 1
        system._step_frame(_frame(snap, "frame"), i, i / 30.0)
        assert system.state.value == ref["state"][i]
        fids, _, R, t = system.keyframe_trajectory()
        out[dist] = (system, fids, R, t)
    (s0, f0, R0, t0), (s1, f1, R1, t1) = out[False], out[True]
    n_slices = s1.stats["gba_slices"]
    assert n_slices == s0.stats["gba_slices"] > 0
    assert s1.stats["gba_slices_distributed"] == n_slices
    assert "gba_slices_distributed" not in s0.stats
    np.testing.assert_array_equal(f1, f0)
    for a, b, c, d in zip(R1, R0, t1, t0):
        assert _rot_err_deg(a, b) <= LOOP_ROT_DEG
        assert np.linalg.norm(np.asarray(c) - np.asarray(d)) <= LOOP_TRANS_M
    n0, n1 = int(s0.map.pt_valid.sum()), int(s1.map.pt_valid.sum())
    assert abs(n1 - n0) <= LOOP_POINTS * n0
    # a one-entry mesh keeps the single-device branch
    cfg = base.replace(optim=dataclasses.replace(base.optim,
                                                 distributed_gba=True))
    one = SlamSystem(cfg, device="cpu")
    assert one._gba_mesh is None
    _load_loop_step(one, ref, 1)
    one.pending_gba_iters = cfg.optim.gba_slice_iters
    one._gba_slice()
    assert one._gba_mesh == [torch.device("cpu")]
    assert "gba_slices_distributed" not in one.stats


@pytest.mark.parametrize("shape,n_seg", [((50,), 7), ((64, 3), 5),
                                         ((40, 2, 3), 11), ((1, 4), 3)])
def test_segment_sum_sorted_matches_jax(shape, n_seg):
    rng = np.random.default_rng(len(shape) + n_seg)
    vals = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(-2, n_seg + 2, size=shape[0]).astype(np.int32)
    want = np.asarray(jsegsum.segment_sum_sorted(jnp.asarray(vals),
                                                 jnp.asarray(ids), n_seg))
    got = tsegsum.segment_sum_sorted(torch.as_tensor(vals),
                                     torch.as_tensor(ids), n_seg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(_n(got), want, atol=1e-5)
    ok = (ids >= 0) & (ids < n_seg)
    exact = np.zeros((n_seg,) + shape[1:], np.float64)
    np.add.at(exact, ids[ok], vals[ok].astype(np.float64))
    np.testing.assert_allclose(_n(got), exact, atol=1e-5)
