"""chip_smoke.py's serve phase and its recordings, on the CPU.

The serve phase holds, on the card, track_batch in its four modes, the
default serving form (`localize_stream` and `SlamConfig` at their
defaults, with a rewind) and `track_monocular_batch` to the JAX package's
runs (`python tests/test_torch_slice.py --serving full --parts
tb,dstream`: ref_tb_* and ref_dstream_* in ref_full.npz), and its pipe
phase holds the full-width rewind run (`--pipe full`: ref_pipe_rewind_*).
Here the phase's own hold functions run on CPU tensors against ref_small's
track_batch recording and its rewinding stream, each must refuse a run
that departs from the recording, and the new ref_full recordings are
checked against their specs. Tolerances are the phase's: OK flags, frame
ids, OK/None, rewinds and relocalizations equal; poses within 0.2 deg /
1 cm; track_monocular_batch bit-equal to one track_batch call.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_slice import (
    DATA_DIR,
    DSTREAM_ORDER,
    PIPE_DEPTH,
    PIPE_REWIND_ORDER,
    REPO,
    TB_CHUNK,
    TB_MODES,
    _load_ref,
    _port_frames,
    default_stream_spec,
    serving_cfg,
    stream_frames,
)

sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def small():
    path, ref = _load_ref("small")
    cfg, imgs, _ = _port_frames(ref)
    return path, ref, cfg, imgs


def test_the_phases_modes_are_the_recorders():
    assert chip_smoke.TB_MODES == TB_MODES
    assert chip_smoke.MAX_SCAN_SYNCS == 2 * chip_smoke.SERVE_DEBUG_FRAMES + 1


@pytest.mark.parametrize("mode", list(TB_MODES))
def test_serve_holds_track_batch_on_the_cpu(small, mode):
    """run_track_batch + hold_track_batch on CPU tensors pass against
    ref_small's recording, and refuse a flipped OK flag and a pose 0.3 deg
    off."""
    path, ref, cfg, imgs = small
    min_m = cfg.tracking.min_matches_local_map
    ctrls, carry, ms, syncs = chip_smoke.run_track_batch(
        path, cfg, ref, imgs, mode, "cpu")
    assert ctrls.shape == (TB_CHUNK["small"], 20) and ms > 0
    assert syncs == (0 if TB_MODES[mode][0] == "extrapolate"
                     else 2 * TB_CHUNK["small"])
    worst_r, worst_t = chip_smoke.hold_track_batch(ref, mode, ctrls, carry,
                                                   min_m)
    assert worst_r < chip_smoke.ROT_TOL_DEG
    assert worst_t < chip_smoke.TRANS_TOL_M

    lost = ctrls.clone()
    lost[1, 0] = min_m - 1
    with pytest.raises(chip_smoke.PhaseError, match="OK flags"):
        chip_smoke.hold_track_batch(ref, mode, lost, carry, min_m)
    a = np.radians(0.3)
    turn = torch.tensor([[np.cos(a), -np.sin(a), 0.0],
                         [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]],
                        dtype=torch.float32)
    off = ctrls.clone()
    off[2, 5:14] = (turn @ off[2, 5:14].reshape(3, 3)).reshape(9)
    with pytest.raises(chip_smoke.PhaseError, match="poses off"):
        chip_smoke.hold_track_batch(ref, mode, off, carry, min_m)


def test_serve_holds_the_rewinding_stream_on_the_cpu(small):
    """hold_stream and the frames-built count on ref_small's stream (chunk
    4, depth 2, a blank frame at position 6): the rewind discards the lost
    chunk's last 2 frames and the one chunk in flight (4), so 17 + 6 frames
    are built; the hold refuses another rewind count and a lost pose."""
    from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    path, ref, cfg, imgs = small
    spec = json.loads(str(ref["ref_stream_spec"]))
    order = ref["ref_stream_order"].tolist()
    system = SlamSystem(serving_cfg(cfg, spec["loc_seed_mode"],
                                    spec["loc_extrap_passes"]), device="cpu")
    system.load_map(path)
    system.track_monocular(imgs[0], ts=0.0)
    assert system.state is TrackingState.OK
    built = chip_smoke.count_frames_built(system)
    src = StagedSource(stream_frames(imgs, order), batch=spec["chunk"],
                       device="cpu")
    out = [(f, p) for f, _, p in system.localize_stream(
        src, chunk=spec["chunk"], depth=spec["depth"])]
    worst_r, worst_t = chip_smoke.hold_stream(ref, "ref_stream_", out,
                                              system.stats, 1)
    assert worst_r < chip_smoke.ROT_TOL_DEG
    lost_at = order.index(-1) % spec["chunk"]
    replayed = spec["chunk"] - lost_at + spec["chunk"] * (spec["depth"] - 1)
    assert built["chunk"] + built["frame"] == len(order) + replayed == 23

    with pytest.raises(chip_smoke.PhaseError, match="rewinds"):
        chip_smoke.hold_stream(ref, "ref_stream_", out, system.stats, 2)
    dropped = list(out)
    dropped[3] = (dropped[3][0], None)
    with pytest.raises(chip_smoke.PhaseError, match="OK/None"):
        chip_smoke.hold_stream(ref, "ref_stream_", dropped, system.stats, 1)


def test_serve_holds_track_monocular_batch_on_the_cpu(small):
    """The phase's track_monocular_batch check on the CPU: poses bit-equal
    to one track_batch call, the blank chunk relocalizing; it refuses a
    pose one ulp off and a missing relocalization."""
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    path, ref, cfg, imgs = small
    system = SlamSystem(cfg, device="cpu")
    system.load_map(path)
    for i in range(2):
        system.track_monocular(imgs[i], ts=i / 30.0)
    lf = system.last_frame
    ctrls, _ = tracking.track_batch(
        system.map, torch.as_tensor(np.stack(imgs[2:6])), *system.last_pose,
        *system.vel, torch.tensor(True), lf.kp_uv, lf.desc, system.last_obs,
        lf.kp_valid, lf.kp_octave, lf.kp_angle, torch.tensor(system.ref_kf),
        system.cam, cfg)
    poses = system.track_monocular_batch(imgs[2:6], [0.1, 0.2, 0.3, 0.4])
    blank = np.full_like(imgs[0], 128)
    blank_poses = system.track_monocular_batch(
        [imgs[6], blank, imgs[7], imgs[6]], [0.5, 0.6, 0.7, 0.8])
    chip_smoke.hold_monocular_batch(ctrls, poses, blank_poses,
                                    system.stats["reloc"])

    R, t = poses[1]
    nudged = list(poses)
    nudged[1] = (R, np.nextafter(t, np.float32(np.inf)).astype(t.dtype))
    with pytest.raises(chip_smoke.PhaseError, match="not track_batch's"):
        chip_smoke.hold_monocular_batch(ctrls, nudged, blank_poses,
                                        system.stats["reloc"])
    with pytest.raises(chip_smoke.PhaseError, match="blank frame"):
        chip_smoke.hold_monocular_batch(ctrls, poses, blank_poses, 1)


def test_the_default_serving_form_is_both_packages_defaults():
    """ref_dstream_spec is localize_stream's and SlamConfig's defaults, in
    the JAX package and in the port alike."""
    from orb_slam2_aruco_tpu import config as jconfig
    from orb_slam2_aruco_tpu.pipeline.system import SlamSystem as JSystem
    from orb_slam2_aruco_tpu_torch import config as tconfig
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    _, ref = _load_ref("full")
    want = default_stream_spec(jconfig, JSystem.localize_stream)
    assert default_stream_spec(tconfig, SlamSystem.localize_stream) == want
    spec = json.loads(str(ref["ref_dstream_spec"]))
    assert dict(spec, order=list(DSTREAM_ORDER)) == want
    assert chip_smoke.default_stream_spec() == spec
    assert spec == dict(chunk=16, depth=2, loc_seed_mode="scan",
                        loc_extrap_passes=2, loc_two_stage=True,
                        detect_downsample=1)


def test_full_reference_holds_the_serving_and_rewind_recordings():
    """ref_full's track_batch chunk (16 frames, every mode tracked), its
    default-form stream (65 frames, the blank mid-chunk lost, at least one
    rewind, every frame emitted once, the frames built = 65 + the replayed
    ones) and its depth-4 rewind run (initialized before the black frames,
    LOST on them, a relocalization after them)."""
    _, ref = _load_ref("full")
    B = TB_CHUNK["full"]
    for mode in TB_MODES:
        c = ref[f"ref_tb_{mode}_ctrl"]
        assert c.shape == (B, 20) and np.isfinite(c).all()
        assert (c[:, 0] >= 30).all(), mode
        assert ref[f"ref_tb_{mode}_R"].shape == (3, 3)
    assert ref["ref_tb_in_pt_visible"].shape == ref["ref_tb_in_pt_found"].shape

    order = ref["ref_dstream_order"].tolist()
    assert order == DSTREAM_ORDER and len(order) == 65
    spec = json.loads(str(ref["ref_dstream_spec"]))
    assert order.index(-1) % spec["chunk"] not in (0, spec["chunk"] - 1)
    fid = ref["ref_dstream_fid"].tolist()
    assert fid == list(range(1, len(order) + 1))
    ok = ref["ref_dstream_ok"].tolist()
    assert not ok[order.index(-1)] and sum(ok) == len(order) - 1
    rewinds = int(ref["ref_dstream_rewinds"])
    assert rewinds >= 1 and int(ref["ref_dstream_reloc"]) >= 2
    lost_at = order.index(-1) % spec["chunk"]
    replayed = spec["chunk"] - lost_at + spec["chunk"] * (spec["depth"] - 1)
    assert int(ref["ref_dstream_built"]) == len(order) + replayed
    assert ref["ref_dstream_R"].shape == (len(order), 3, 3)

    pre = "ref_pipe_rewind_"
    assert ref[pre + "order"].tolist() == PIPE_REWIND_ORDER
    states = ref[pre + "state"].tolist()
    first_black = PIPE_REWIND_ORDER.index(-1)
    assert ref[pre + "fid"].tolist() == list(range(len(PIPE_REWIND_ORDER)))
    assert 2 in states[:first_black]
    assert 3 in states[first_black:first_black + 3 + PIPE_DEPTH["full"]]
    assert states[-1] == 2 and len(ref[pre + "reloc_fid"]) >= 1
    assert 0.0 < float(ref[pre + "ate"]) < 0.05


# sha256 over (name, dtype, shape, bytes) of every key each file held
# before the default serving form, the full-width track_batch chunk and the
# full-width rewind run were recorded: those recordings, and the later one
# of bench.py's workload (ref_bench_*), leave them equal
PRE_SERVE_DIGESTS = {
    "small": (436, "3bfb7911409f02b68fba67aa2b81197b"
                   "de8d93905edf54846883d0e7cf3a1479"),
    "full": (122, "2d62aa5f1daf8e39e6c69e82d078faa2"
                  "6ac489c8416ce4a2fae28107a753df87"),
}
NEW_KEYS = {"small": (), "full": ("ref_tb_", "ref_dstream_",
                                  "ref_pipe_rewind_", "ref_bench_")}


@pytest.mark.parametrize("name", ["small", "full"])
def test_serve_recordings_keep_the_other_keys_byte_equal(name):
    from test_torch_slice import _digest

    path = os.path.join(DATA_DIR, f"ref_{name}.npz")
    assert _digest(path, NEW_KEYS[name]) == PRE_SERVE_DIGESTS[name]
