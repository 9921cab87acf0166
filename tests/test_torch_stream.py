"""The port's chunked localization serving against the JAX package:
`tracking.track_batch` in each mode, `SlamSystem.localize_stream` with a
rewind, `SlamSystem.track_monocular_batch` and the `StagedSource` ingest.

The JAX runs are recorded in orb_slam2_aruco_tpu_torch/data/ref_small.npz
(tests/test_torch_slice.py add_serving_reference: chunk 4 on the ref_small
map). Tolerances are slice 1's: per frame 1e-3 rad and 1e-3 m on the pose
from the same inputs (0.2 deg and 1 cm along a stream, where each frame
chains on the port's own previous poses), local-map inlier counts within 3,
branch flags, reference-keyframe counts and the carry's integer fields
exact.
"""

import json

import numpy as np
import pytest
import torch

from orb_slam2_aruco_tpu_torch.geometry import camera as tcam
from orb_slam2_aruco_tpu_torch.io import checkpoint as tckpt
from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource
from orb_slam2_aruco_tpu_torch.pipeline import tracking as ttrack
from orb_slam2_aruco_tpu_torch.pipeline.system import (
    SlamSystem,
    TrackingState,
)

from test_torch_slice import (
    ROT_TOL_DEG,
    TB_CARRY,
    TB_INPUTS,
    TB_MODES,
    TRANS_TOL_M,
    _load_ref,
    _port_frames,
    _rot_err_deg,
    serving_cfg,
    stream_frames,
)


@pytest.fixture(scope="module")
def small():
    path, ref = _load_ref("small")
    cfg, imgs, _ = _port_frames(ref)
    return path, ref, cfg, imgs


def _inputs(ref):
    ins = {k: np.array(ref[f"ref_tb_in_{k}"]) for k in TB_INPUTS}
    out = {k: torch.as_tensor(v) for k, v in ins.items()}
    out["last_desc"] = torch.as_tensor(ins["last_desc"].view(np.int32))
    for k in ("last_obs", "last_octave", "ref_kf"):
        out[k] = out[k].to(torch.int64)
    return out


@pytest.mark.parametrize("mode", list(TB_MODES))
def test_track_batch_matches_jax(small, mode):
    path, ref, cfg, imgs = small
    ins = _inputs(ref)
    state = tckpt.load_map(path, device="cpu")._replace(
        pt_visible=ins["pt_visible"], pt_found=ins["pt_found"])
    mcfg = serving_cfg(cfg, *TB_MODES[mode])
    cam = tcam.camera_from_config(cfg.camera)
    stack = torch.as_tensor(np.stack(imgs[2:6]))
    ttrack.SYNCS["count"] = 0
    ctrls, carry = ttrack.track_batch(
        state, stack, ins["R_last"], ins["t_last"], ins["vel_R"],
        ins["vel_t"], torch.tensor(True),
        *[ins[k] for k in TB_INPUTS[4:11]], cam, mcfg)
    syncs = ttrack.SYNCS["count"]
    # extrapolate: no host sync in the chunk; the cascades: two per frame
    assert syncs == (0 if TB_MODES[mode][0] == "extrapolate" else 2 * 4)

    c, cj = ctrls.numpy(), ref[f"ref_tb_{mode}_ctrl"]
    assert c.shape == cj.shape == (4, 20)
    assert (cj[:, 0] >= 30).all()                    # all four tracked
    np.testing.assert_allclose(c[:, :2], cj[:, :2], atol=3)
    np.testing.assert_array_equal(c[:, 2:5], cj[:, 2:5])     # branch flags
    np.testing.assert_array_equal(c[:, 17:20], cj[:, 17:20])  # ref-KF counts
    for j in range(4):
        Rj = cj[j, 5:14].reshape(3, 3)
        assert np.radians(_rot_err_deg(c[j, 5:14].reshape(3, 3), Rj)) < 1e-3
        np.testing.assert_allclose(c[j, 14:17], cj[j, 14:17], atol=1e-3)

    got = dict(zip(TB_CARRY, carry))
    want = {k: ref[f"ref_tb_{mode}_{k}"] for k in TB_CARRY}
    assert np.radians(_rot_err_deg(got["R"].numpy(), want["R"])) < 1e-3
    np.testing.assert_allclose(got["t"].numpy(), want["t"], atol=1e-3)
    assert np.radians(_rot_err_deg(got["vel_R"].numpy(),
                                   want["vel_R"])) < 2e-3
    np.testing.assert_allclose(got["vel_t"].numpy(), want["vel_t"],
                               atol=2e-3)
    assert bool(got["ok"]) == bool(want["ok"])
    # the last frame's features and map-point links: integers exact
    for k in ("kp_octave", "kp_valid", "obs"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    np.testing.assert_array_equal(got["desc"].numpy(),
                                  want["desc"].view(np.int32))
    for k in ("kp_uv", "kp_angle"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4)
    # visible / found counts: the same points, within the inlier tolerance
    for k in ("pt_visible", "pt_found"):
        d = np.abs(got[k].numpy() - want[k])
        assert d.sum() <= 3 * 4 * 2, (k, d.sum())


def test_localize_stream_matches_jax_with_a_rewind(small):
    path, ref, cfg, imgs = small
    spec = dict(**json.loads(str(ref["ref_stream_spec"])),
                order=ref["ref_stream_order"].tolist())
    system = SlamSystem(serving_cfg(cfg, spec["loc_seed_mode"],
                                    spec["loc_extrap_passes"]), device="cpu")
    system.load_map(path)
    system.track_monocular(imgs[0], ts=0.0)
    assert system.state is TrackingState.OK
    src = StagedSource(stream_frames(imgs, spec["order"]),
                       batch=spec["chunk"], device="cpu")
    ttrack.SYNCS["count"] = 0
    out = list(system.localize_stream(src, chunk=spec["chunk"],
                                      depth=spec["depth"]))
    assert [f for f, _, _ in out] == ref["ref_stream_fid"].tolist()
    ok = [p is not None for _, _, p in out]
    assert ok == ref["ref_stream_ok"].tolist()
    assert not all(ok)                       # the blank frame was lost
    assert system.stats["reloc"] == int(ref["ref_stream_reloc"]) == 2
    for j, (_, _, p) in enumerate(out):
        if p is not None:
            assert _rot_err_deg(p[0], ref["ref_stream_R"][j]) < ROT_TOL_DEG
            assert np.linalg.norm(p[1] - ref["ref_stream_t"][j]) < TRANS_TOL_M
    assert [r.frame_id for r in system.get_trajectory()] == list(
        range(len(out) + 1))


def test_track_monocular_batch_is_one_track_batch_and_rewinds(small):
    """The facade's chunk path (default two-stage mode) returns exactly the
    poses of one track_batch call from its state and commits its carry; a
    chunk with a lost frame sends that frame and the rest of the chunk
    through the per-frame path (relocalization) from the state before the
    chunk."""
    path, ref, cfg, imgs = small
    system = SlamSystem(cfg, device="cpu")
    system.load_map(path)
    for i in range(2):
        system.track_monocular(imgs[i], ts=i / 30.0)
    lf = system.last_frame
    ctrls, carry = ttrack.track_batch(
        system.map, torch.as_tensor(np.stack(imgs[2:6])), *system.last_pose,
        *system.vel, torch.tensor(True), lf.kp_uv, lf.desc, system.last_obs,
        lf.kp_valid, lf.kp_octave, lf.kp_angle, torch.tensor(system.ref_kf),
        system.cam, cfg)
    poses = system.track_monocular_batch(imgs[2:6], [0.1, 0.2, 0.3, 0.4])
    c = ctrls.numpy()
    for j, (R, t) in enumerate(poses):
        np.testing.assert_array_equal(R, c[j, 5:14].reshape(3, 3))
        np.testing.assert_array_equal(t, c[j, 14:17])
    assert torch.equal(system.last_pose[0], carry[0])
    assert torch.equal(system.last_obs, carry[7])
    assert system.frame_id == 6 and system.state is TrackingState.OK

    blank = np.full_like(imgs[0], 128)
    poses = system.track_monocular_batch([imgs[6], blank, imgs[7], imgs[6]],
                                         [0.5, 0.6, 0.7, 0.8])
    assert [p is not None for p in poses] == [True, False, True, True]
    assert system.stats["reloc"] == 2 and system.state is TrackingState.OK
    assert [r.frame_id for r in system.get_trajectory()] == list(range(10))


@pytest.mark.parametrize("tracked", [0, 1])
def test_facade_and_sequential_track_batch_agree_bit_for_bit(small, tracked,
                                                             monkeypatch):
    """The per-frame facade and track_batch's sequential mode share one
    motion model and one tracking context: from the same state (frame 0
    relocalized, then `tracked` frames per frame: without a velocity, and
    with one), over the same four frames, their control vectors are
    bit-equal and the chunk's carry is the context the facade commits."""
    path, ref, cfg, imgs = small
    system = SlamSystem(serving_cfg(cfg, *TB_MODES["sequential"]),
                        device="cpu")
    system.load_map(path)
    for i in range(1 + tracked):
        assert system.track_monocular(imgs[i], ts=i / 30.0) is not None
    assert (system.vel is not None) == bool(tracked)
    chunk = imgs[1 + tracked:5 + tracked]
    ctrls, carry = system._run_chunk(torch.as_tensor(np.stack(chunk)))
    seen = []
    track_full = ttrack.track_full

    def spy(*a, **k):
        out = track_full(*a, **k)
        seen.append(out.ctrl)
        return out

    monkeypatch.setattr(ttrack, "track_full", spy)
    for j, im in enumerate(chunk):
        assert system.track_monocular(im, ts=(2 + j) / 30.0) is not None
    assert torch.equal(torch.stack(seen), ctrls)
    want = (*system.last_pose, *system.vel, torch.tensor(True),
            *ttrack._frame_context(system.last_frame, system.last_obs),
            system.map.pt_visible, system.map.pt_found)
    assert len(carry) == len(want) == len(TB_CARRY)
    for name, got, w in zip(TB_CARRY, carry, want):
        assert torch.equal(got, w), name


def test_staged_source_on_cpu():
    frames = [(np.full((6, 8), k, np.uint8), k / 10) for k in range(7)]
    per_frame = list(StagedSource(frames, device="cpu"))
    assert [int(f[0, 0]) for f, _ in per_frame] == list(range(7))
    batches = list(StagedSource(frames, batch=3, device="cpu").batches())
    assert [b.shape[0] for b, _ in batches] == [3, 3, 1]
    assert batches[1][1] == [0.3, 0.4, 0.5]
    assert batches[0][0].dtype == torch.uint8
    flat = list(StagedSource(frames, batch=3, device="cpu"))
    assert [int(f[0, 0]) for f, _ in flat] == list(range(7))

    def broken():
        yield frames[0]
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(StagedSource(broken(), device="cpu"))


@pytest.mark.parametrize("mode", list(TB_MODES))
def test_track_batch_counts_no_marker_old_on_an_aged_map(small, mode,
                                                         monkeypatch):
    """Every track_batch mode localizes against a final map: on the map
    aged so that every marker is old to SLAM-mode tracking
    (old_marker_flags), no mode leaves a bound marker out of its seed, and
    each chunk is the one it tracks on the map as loaded, bit for bit."""
    from test_torch_tracking import _aged

    path, ref, cfg, imgs = small
    ins = _inputs(ref)
    state = tckpt.load_map(path, device="cpu")._replace(
        pt_visible=ins["pt_visible"], pt_found=ins["pt_found"])
    aged = _aged(state)
    mcfg = serving_cfg(cfg, *TB_MODES[mode])
    cam = tcam.camera_from_config(cfg.camera)
    stack = torch.as_tensor(np.stack(imgs[2:6]))
    olds = []
    candidate = ttrack.aruco_pose_candidate

    def spy(state, frame, slots, *a, old=None, **k):
        olds.append((slots, old, ttrack.old_marker_flags(
            state, slots, mcfg.loop.min_kfs_between_loops)))
        return candidate(state, frame, slots, *a, old=old, **k)

    monkeypatch.setattr(ttrack, "aruco_pose_candidate", spy)

    def run(st):
        return ttrack.track_batch(
            st, stack, ins["R_last"], ins["t_last"], ins["vel_R"],
            ins["vel_t"], torch.tensor(True),
            *[ins[k] for k in TB_INPUTS[4:11]], cam, mcfg)

    ctrls, carry = run(aged)
    assert len(olds) >= 4
    for slots, old, flags in olds:
        assert not bool(old.any())
        # the aged map's bound markers are all old to SLAM-mode tracking
        assert torch.equal(flags, slots >= 0) and bool(flags.any())
    assert (ctrls[:, 0] >= 30).all()
    ctrls0, carry0 = run(state)
    assert torch.equal(ctrls, ctrls0)
    for a, b in zip(carry, carry0):
        assert torch.equal(a, b)
