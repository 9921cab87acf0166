"""bench_torch.py — bench.py's workload on the port — on the CPU.

bench_torch.py runs bench.py's workload through orb_slam2_aruco_tpu_torch on
one CUDA device; chip_smoke.py's bench phase runs it at full size on the
card and holds it to the JAX package's recording of bench.py's sequence
(`python tests/test_torch_slice.py --bench`: ref_bench_* in ref_full.npz).
Here, on the CPU at small sizes:

  * bench_scene renders bench.py's frames: the JAX package's synthetic
    render of bench.py's sweep, equal to the grey level (tolerance 0), and
    bench.py's configuration field for field;
  * slam_pass, stream_pass and ba_rate run with device="cpu" on the small
    setup's shifted scene, and bench_line carries every key of bench.py's
    JSON line (read from bench.py with `ast`);
  * the port's serving pass from the recorded warm JAX system's state over
    the first frames of the recorded warm-up chunk equals the recording:
    ids and OK/None equal, poses within 0.5 deg / 2 cm (the card's SLAM
    limits). In extrapolate mode every frame of a chunk is seeded from the
    chunk's start state alone (port pipeline/tracking.py track_batch), so a
    chunk's first frames give the same results as the whole chunk's;
  * bench_torch imports with `jax` and `orb_slam2_aruco_tpu` blocked;
  * main(device="cuda") without a card raises before it renders or runs
    anything.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_slice import (
    DATA_DIR,
    PIPE_DEPTH,
    REPO,
    _rot_err_deg,
    pipe_cfg,
    pipe_scene,
)

sys.path.insert(0, REPO)

import bench_torch  # noqa: E402

REF_FULL = os.path.join(DATA_DIR, "ref_full.npz")
ROT_DEG, TRANS_M = 0.5, 0.02
# frames of the recorded warm-up chunk the port serves here (2.5 s a
# full-width frame on one CPU thread)
PREFIX = 10


def _bench_py_keys():
    """The keys of the dict bench.py's main() prints with json.dumps."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("bench.py prints no json.dumps dict")


def _jax_bench_scene():
    """bench.py's config and frames (bench.py:89-126), by the JAX
    package."""
    from orb_slam2_aruco_tpu.config import CameraConfig, SlamConfig
    from orb_slam2_aruco_tpu.io import synthetic

    camc = CameraConfig(fx=500.0, fy=500.0, cx=480.0, cy=270.0,
                        dist=(0, 0, 0, 0, 0), width=960, height=540)
    cfg = SlamConfig().replace(camera=camc)
    cfg = cfg.replace(aruco=cfg.aruco.__class__(detect_downsample=2),
                      tracking=cfg.tracking.__class__(pipeline_depth=4))
    world = synthetic.build_world([3, 17, 42, 99, 7, 23, 55, 88],
                                  px_per_m=500.0, spacing=0.6, grid_cols=4,
                                  marker_size=0.165)
    n_base, n_frames = 16, 32
    xs = np.concatenate([np.linspace(0.5, 1.3, n_base),
                         np.linspace(1.3, 0.5, n_frames - n_base)])
    frames = {}
    for i in (0, 9, 16, 31):
        R, t = synthetic.look_at_plane_pose(
            (xs[i], 0.3), 2.0, yaw=0.1 * np.sin(2 * np.pi * i / n_frames),
            pitch=0.04)
        frames[i] = np.clip(synthetic.render_view(world, camc, R, t), 0,
                            255).astype(np.uint8)
    return cfg, frames


def test_bench_scene_is_bench_pys():
    cfg, frames = bench_torch.bench_scene("cpu")
    jcfg, jframes = _jax_bench_scene()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert len(frames) == 32
    for i, want in jframes.items():
        assert frames[i].dtype == np.uint8 and frames[i].shape == (540, 960)
        np.testing.assert_array_equal(frames[i], want)


def test_bench_passes_run_on_the_cpu():
    """The bench's three measured passes at a small size: the SLAM pass at
    depth 2 over the small shifted scene (12 frames), the serving pass
    (n_timed 16, chunk 8) from that warm system, two BA iterations; the
    line has bench.py's keys."""
    from orb_slam2_aruco_tpu_torch.config import SlamConfig
    from orb_slam2_aruco_tpu_torch.io import synthetic
    from orb_slam2_aruco_tpu_torch.pipeline.system import TrackingState

    with np.load(os.path.join(DATA_DIR, "ref_small.npz")) as z:
        base = SlamConfig.from_dict(json.loads(str(z["ref_cfg"])))
        inserts = z["ref_pipe_inserts"].tolist()
    cfg = pipe_cfg(base, PIPE_DEPTH["small"])
    frames, _ = pipe_scene("small", cfg, synthetic)
    system, records, created, per_call, m = bench_torch.slam_pass(
        cfg, frames, "cpu")
    assert system.device.type == "cpu" and system.state is TrackingState.OK
    assert [r.frame_id for r in records] == list(range(len(frames)))
    assert created == inserts and sum(per_call) == len(created)
    assert 0 < m["drop"] < len(frames) and m["slam_fps"] > 0
    assert 0 < m["p50_ms"] <= m["p90_ms"]

    st = bench_torch.stream_pass(system, frames, n_timed=16, chunk=8)
    n0 = len(frames) + 8
    assert [f for f, _ in st["out"]] == list(range(n0, n0 + 16))
    assert all(p is not None for _, p in st["out"])
    assert st["warm"]["built"] == 8 and st["built"] == 16
    assert st["rewinds"] == 0 and len(st["bursts_ms"]) == 2
    assert st["fps"] > 0 and st["loc_chunk_latency_ms"] > 0
    assert system.localization_only
    assert system.cfg.tracking.loc_seed_mode == "extrapolate"

    ba = bench_torch.ba_rate(system, cfg, iters=2)
    assert ba["cams_live"] == int(system.map.kf_valid.sum()) >= 2
    assert ba["cams_live"] + ba["cams_masked"] == cfg.map.max_keyframes
    assert np.isfinite(ba["chi2"]) and ba["ba_iters_per_s"] > 0

    idle = bench_torch.idle_share(lambda: None, "cpu")[:2]
    line = bench_torch.bench_line(m, st, ba, bench_torch.card("cpu"),
                                  (idle, idle))
    assert set(_bench_py_keys()) <= set(line)
    assert line["metric"] == "tracking_fps_960x540_1000feat"
    assert line["vs_baseline"] == line["value"] / 30.0
    assert (line["chunk"], line["n_timed"], line["ba_iters"]) == (8, 16, 2)
    assert (line["device"], line["power_limit"]) == ("cpu", None)
    assert {"idle_share_slam", "idle_share_stream"} <= set(line)
    json.dumps(line)


def test_idle_share_is_not_measured_on_the_cpu():
    share, counts, out = bench_torch.idle_share(lambda: 7, "cpu")
    assert (share, out, counts["device_events"], counts["busy_s"]) == (
        None, 7, 0, None)
    assert counts["window_s"] >= 0


def test_union_of_device_spans():
    assert bench_torch.union_ns([]) == 0
    assert bench_torch.union_ns([(5, 9), (0, 2), (1, 3), (9, 10),
                                 (20, 21)]) == 9


def _warm_system(ref, cfg, frames):
    """A port SlamSystem on the CPU in the recorded JAX warm system's state
    (ref_bench_in_*: the map is ref_full's, the tracking state the one the
    JAX stream started from), in bench.py's serving mode."""
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame
    from orb_slam2_aruco_tpu_torch.pipeline.system import (
        SlamSystem,
        TrackingState,
    )

    system = SlamSystem(cfg, device="cpu")
    system.load_map(REF_FULL)
    frame = make_frame(torch.as_tensor(frames[-1]), system.cam, cfg)

    def rec(k, like):
        return torch.as_tensor(ref["ref_bench_in_" + k]).to(like.dtype)

    system.last_frame = frame._replace(
        kp_uv=rec("last_uv", frame.kp_uv), desc=rec("last_desc", frame.desc),
        kp_valid=rec("last_valid", frame.kp_valid),
        kp_octave=rec("last_octave", frame.kp_octave),
        kp_angle=rec("last_angle", frame.kp_angle))
    system.last_obs = rec("last_obs", frame.kp_octave)
    R = torch.as_tensor(ref["ref_bench_in_R_last"])
    system.last_pose = (R, torch.as_tensor(ref["ref_bench_in_t_last"]))
    system.vel = ((torch.as_tensor(ref["ref_bench_in_vel_R"]),
                   torch.as_tensor(ref["ref_bench_in_vel_t"]))
                  if bool(ref["ref_bench_in_has_vel"]) else None)
    system.ref_kf = int(ref["ref_bench_in_ref_kf"])
    system.map = system.map._replace(
        pt_visible=rec("pt_visible", system.map.pt_visible),
        pt_found=rec("pt_found", system.map.pt_found))
    system.frame_id = int(ref["ref_bench_in_frame_id"])
    system.state = TrackingState.OK
    bench_torch.serving_mode(system)
    return system


def test_serving_pass_matches_the_jax_recording():
    with np.load(REF_FULL) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_bench_")}
    spec = json.loads(str(ref["ref_bench_spec"]))
    assert (spec["chunk"], spec["n_timed"], spec["ba_iters"]) == (
        bench_torch.CHUNK, bench_torch.N_TIMED, bench_torch.BA_ITERS)
    assert len(ref["ref_bench_warm_fid"]) == spec["chunk"]
    assert len(ref["ref_bench_fid"]) == spec["n_recorded"]
    assert int(ref["ref_bench_rewinds"]) == 0 == int(
        ref["ref_bench_warm_rewinds"])
    assert ref["ref_bench_ok"].all() and ref["ref_bench_warm_ok"].all()

    cfg, frames = bench_torch.bench_scene("cpu")
    system = _warm_system(ref, cfg, frames)
    got = bench_torch.serve(system, frames, PREFIX, PREFIX)
    fids = [f for f, _ in got["out"]]
    assert fids == ref["ref_bench_warm_fid"][:PREFIX].tolist()
    assert got["rewinds_at"][-1] == 0 and got["built"] == PREFIX
    for j, (_, p) in enumerate(got["out"]):
        assert p is not None, j
        assert _rot_err_deg(p[0], ref["ref_bench_warm_R"][j]) < ROT_DEG
        assert np.linalg.norm(np.asarray(p[1], np.float64)
                              - ref["ref_bench_warm_t"][j]) < TRANS_M


def test_bench_torch_needs_nothing_of_the_jax_package():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["orb_slam2_aruco_tpu"] = None
import bench_torch
cfg, frames = bench_torch.bench_scene("cpu")
assert len(frames) == 32 and cfg.tracking.pipeline_depth == 4
bad = [m for m in sys.modules if sys.modules[m] is not None and (
    m == "jax" or m.startswith("jax.") or m == "orb_slam2_aruco_tpu"
    or m.startswith("orb_slam2_aruco_tpu."))]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_main_without_a_card_raises_and_runs_nothing(monkeypatch):
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_torch, "bench_scene",
                        lambda *a, **k: ran.append("scene"))
    monkeypatch.setattr(bench_torch, "slam_pass",
                        lambda *a, **k: ran.append("slam"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench_torch.main()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench_torch.main(device="cuda")
    assert ran == []


def test_chip_smoke_bench_hold_refuses_a_departing_stream():
    """chip_smoke's hold of the bench stream against ref_bench_*: the
    recording itself passes; a None pose, another id, a rewind and a pose
    0.6 deg off each fail."""
    import chip_smoke

    with np.load(REF_FULL) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_bench_")}
    pre = "ref_bench_"
    good = [(int(f), (R, t)) for f, R, t in zip(ref[pre + "fid"],
                                                ref[pre + "R"],
                                                ref[pre + "t"])]
    assert chip_smoke.hold_bench_stream("bench", good, ref, pre, 0) == (
        0.0, 0.0)
    a = np.radians(0.6)
    turn = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]])
    bad = {"none": good[:5] + [(good[5][0], None)] + good[6:],
           "id": [(good[0][0] + 1, good[0][1])] + good[1:],
           "pose": good[:7] + [(good[7][0], (turn @ good[7][1][0],
                                             good[7][1][1]))] + good[8:]}
    for got in bad.values():
        with pytest.raises(chip_smoke.PhaseError):
            chip_smoke.hold_bench_stream("bench", got, ref, pre, 0)
    with pytest.raises(chip_smoke.PhaseError, match="rewinds"):
        chip_smoke.hold_bench_stream("bench", good, ref, pre, 1)
