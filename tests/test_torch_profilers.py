"""The port's profilers of the frontend, tracking and insert stages on the
CPU at ref_small's size: each of tools/torch_build_bench_map.py,
torch_prof_track_batch.py, torch_prof_loc_variants.py, torch_prof_all.py,
torch_prof_stages.py, torch_prof_frontend.py, torch_prof_orb_split.py and
torch_profile_detect.py runs its main with --device cpu --small, prints
the card line first ("cpu" here) and, as its last line, one JSON object
with its keys and finite numbers; without a card and without --device cpu
each raises before it measures anything. A process that cannot import
`jax` or `orb_slam2_aruco_tpu` imports every module the eleven new tools
name. The bench map the build tool writes reloads equal in the JAX
package's loader and the port's. The stages the profilers time apart
are held to the code they time: make_frame's ORB part (orb_upto) to
make_frame, the detector's steps (detect_upto) to detect_markers. The
numbers are the CPU's: the tools' readings are taken on the card.
"""

import ast
import contextlib
import io
import json
import math
import os
import subprocess
import sys

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_slice import REPO

TOOLS_DIR = os.path.join(REPO, "tools")
sys.path.insert(0, REPO)
sys.path.insert(0, TOOLS_DIR)

import chip_smoke  # noqa: E402
import torch_build_bench_map  # noqa: E402
import torch_prof_all  # noqa: E402
import torch_prof_common  # noqa: E402
import torch_prof_frontend  # noqa: E402
import torch_prof_loc_variants  # noqa: E402
import torch_prof_orb_split  # noqa: E402
import torch_prof_stages  # noqa: E402
import torch_prof_track_batch  # noqa: E402
import torch_profile_detect  # noqa: E402
from orb_slam2_aruco_tpu.io import checkpoint as jax_checkpoint  # noqa: E402
from orb_slam2_aruco_tpu_torch.io import checkpoint  # noqa: E402

# {name: (module, extra arguments, keys of its JSON, rows of its table)}
TOOLS = {
    "build_bench_map": (torch_build_bench_map, [],
                        ("keyframes", "points", "markers", "digest"), None),
    "prof_track_batch": (torch_prof_track_batch, ["--b", "1"],
                         ("ms_per_chunk", "ms_per_frame_minus_null"),
                         ("frontend", "track_batch scan",
                          "track_batch extrap p2", "track_batch extrap p1")),
    "prof_loc_variants": (torch_prof_loc_variants, ["--n", "1"],
                          ("variants",),
                          tuple(v[0] for v in
                                torch_prof_loc_variants.VARIANTS)),
    "prof_all": (torch_prof_all, [], ("ms", "wall_ms", "keyframes"), (
        "null launch", "frontend: pyramid", "frontend: pyramid+FAST",
        "frontend: pyramid+FAST+blur+BRIEF",
        "frontend: aruco detect (full, refine)",
        "frontend: make_frame (all of the above + BoW)",
        "track_full (cascade, pre-made frame)",
        "frame step: make_frame + track_full",
        "track_batch chunk=2 (localization)", "track_batch per frame",
        "mapping: triangulate_vs_covisible (top-20)", "mapping: cull_points",
        "mapping: fuse_duplicates", "mapping: update_point_stats",
        "mapping: distinctive_descriptors", "mapping: aruco_plane_update",
        "mapping: local BA (8 cams + 8 fixed ring, 2048 pts, 10 it)",
        "mapping: cull_keyframes", "loop: detect_loop_by_marker",
        "loop: detect_loop_by_bow")),
    "prof_stages": (torch_prof_stages, [], ("ms_per_frame", "null_ms"), (
        "pyramid", "pyramid+FAST", "pyramid+FAST+blur+angles+BRIEF",
        "aruco adaptive_threshold", "aruco thresh+CC+quads",
        "aruco full detect (no refine)")),
    "prof_frontend": (torch_prof_frontend, [], ("ms_per_chunk", "null_ms"), (
        "full make_frame", "ORB pyramid+descr only", "BoW only",
        "ArUco detect (no refine)", "refine top-16")),
    "prof_orb_split": (torch_prof_orb_split, [], ("ms_per_chunk", "null_ms"),
                       tuple(f"upto {s}" for s in
                             torch_prof_orb_split.ORDER)),
    "profile_detect": (torch_profile_detect, [], ("ms_per_chunk",),
                       ("thresh", "thresh+K3 CC+quads", "+decode",
                        "+refine (full)")),
}
# the eleven tools of the JAX side's last measurement and data tools
NEW_TOOLS = ["torch_" + n for n in TOOLS] + [
    "torch_independent_seq", "torch_extract_cv2_dicts", "torch_gen_mip25h7"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """run(name) -> (printed lines, returned dict) of the tool's main with
    --device cpu --small, once per tool in this module (the bench map into
    a temporary directory)."""
    base = str(tmp_path_factory.mktemp("bench_map") / "bench_map")
    done = {}

    def go(name):
        if name not in done:
            mod, extra, _, _ = TOOLS[name]
            if name == "build_bench_map":
                extra = extra + ["--out", base]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                ret = mod.main(["--device", "cpu", "--small"] + extra)
            done[name] = out.getvalue().strip().splitlines(), ret
        return done[name]

    go.base = base
    return go


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_the_cpu_and_prints_its_json_last(name, run):
    _, _, keys, rows = TOOLS[name]
    lines, ret = run(name)
    assert lines[0] == "cpu"
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(ret))
    assert last["card"] == "cpu" and last["small"] is True
    for k in keys:
        assert k in last, k
    nums = torch_prof_common.json_numbers(last)
    assert nums and all(math.isfinite(n) for n in nums)
    if name == "prof_loc_variants":
        assert list(last["variants"]) == list(rows)
        assert all(v["primed"] and v["n"] == 1 and 0 <= v["ok"] <= 1
                   and v["fps"] > 0 for v in last["variants"].values())
    elif rows is not None:
        table = last[keys[0]]
        assert list(table) == list(rows)
    if name == "prof_all":
        assert last["out"] is None
        assert list(last["wall_ms"]) == list(rows)
        assert any(line.startswith("| stage |") for line in lines)
    if name == "build_bench_map":
        assert last["keyframes"] >= 2 and last["points"] > 0


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_without_a_card_raises(name, monkeypatch, tmp_path):
    mod, extra, _, _ = TOOLS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "build_bench_map":
        extra = extra + ["--out", str(tmp_path / "m")]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mod.main(["--small"] + extra)
    assert not os.listdir(tmp_path)


def _imported_modules(path):
    """Every module an `import` or `from ... import` of the file names,
    inside functions too (the tools import lazily)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def test_the_new_tools_need_nothing_of_the_jax_package():
    """In a process where `jax` and `orb_slam2_aruco_tpu` cannot be
    imported, the eleven tools and every module any of them imports,
    lazily or not, import."""
    mods = sorted(set().union(*(
        _imported_modules(os.path.join(TOOLS_DIR, n + ".py"))
        for n in NEW_TOOLS)) | set(NEW_TOOLS))
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "orb_slam2_aruco_tpu")], mods
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["orb_slam2_aruco_tpu"] = None
sys.path.insert(0, {TOOLS_DIR!r})
for m in {mods!r}:
    importlib.import_module(m)
bad = [m for m in sys.modules if sys.modules[m] is not None and (
    m == "jax" or m.startswith("jax.") or m == "orb_slam2_aruco_tpu"
    or m.startswith("orb_slam2_aruco_tpu."))]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_the_bench_map_reloads_equal_in_jax_and_the_port(run):
    """torch_build_bench_map --small: JAX's io/checkpoint.load_map reads
    every array equal to the port's load_map (bit for bit: the port keeps
    packed descriptors as int32, JAX as uint32), which gives the digest
    the tool printed; the frames file holds the scene's frames."""
    _, ret = run("build_bench_map")
    path = run.base + ".npz"
    mine = checkpoint.load_map(path, "cpu")
    theirs = jax_checkpoint.load_map(path)
    assert mine._fields == theirs._fields
    for f in mine._fields:
        a, b = getattr(mine, f).numpy(), np.asarray(getattr(theirs, f))
        if a.dtype != b.dtype and a.dtype.itemsize == b.dtype.itemsize:
            a = a.view(b.dtype)
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert torch_build_bench_map.map_digest(mine) == ret["digest"]
    frames = torch_prof_common.scene(torch.device("cpu"), True)[1]
    with np.load(run.base + "_frames.npz") as z:
        assert np.array_equal(z["frames"], np.stack(frames))


@pytest.fixture(scope="module")
def small_scene():
    """ref_small's configuration, camera and two of its map frames on the
    CPU."""
    from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config

    cfg, frames, _ = torch_prof_common.scene(torch.device("cpu"), True)
    return cfg, camera_from_config(cfg.camera, "cpu"), [
        torch.as_tensor(f) for f in frames[:2]]


@pytest.mark.parametrize("order", [torch_prof_common.ORB_STAGES,
                                   torch_prof_orb_split.ORDER],
                         ids=["make_frame_order", "orb_split_order"])
def test_orb_upto_is_make_frames_orb_part(order, small_scene):
    """orb_upto up to describe, in either order the profilers run it,
    gives make_frame's keypoint flags, angles and descriptors bit for
    bit (the profilers time the ORB part make_frame runs)."""
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    cfg, cam, imgs = small_scene
    for img in imgs:
        fr = make_frame(img, cam, cfg)
        have = torch_prof_common.orb_upto(img, cfg, "describe", order=order)
        assert torch.equal(torch.cat([kp.valid for kp in have["fast"]]),
                           fr.kp_valid)
        assert torch.equal(torch.cat(have["angles"]), fr.kp_angle)
        assert torch.equal(torch.cat(have["describe"]), fr.desc)
        assert int(fr.kp_valid.sum()) > 0


@pytest.mark.parametrize("fused", [True, False], ids=["K3", "plain_cc"])
def test_detect_upto_is_detect_markers(fused, small_scene, monkeypatch):
    """On both quad routes, detect_upto's quads are the quads and flags
    detect_markers hands decode_quads, and up to decode it is
    detect_markers without refinement before it drops repeated ids (same
    corners, ids and flags); `detect` is detect_markers as make_frame
    calls it, whose first max_markers_per_frame detections are
    make_frame's markers."""
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector
    from orb_slam2_aruco_tpu_torch.ops.topk import stable_topk
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame

    handed = []
    decode = detector.decode_quads

    def spy(img, quads, valid, *args, **kw):
        handed.append((quads, valid))
        return decode(img, quads, valid, *args, **kw)

    monkeypatch.setattr(detector, "decode_quads", spy)

    cfg, cam, imgs = small_scene
    a = dataclasses.replace(cfg.aruco, use_pallas_cc=fused)
    cfg = cfg.replace(aruco=a)
    for img in imgs:
        handed.clear()
        gray = img.float()
        ref = torch_prof_common.detect(gray, a, refine=False)
        det = torch_prof_common.detect_upto(gray, a, "decode", fused=fused)
        ids = det.ids
        same = (ids[:, None] == ids[None, :]) & (ids[:, None] >= 0)
        dup = (same & torch.ones_like(same).tril(-1)).any(dim=1)
        ok = det.valid & ~dup
        assert torch.equal(ref.corners, det.corners)
        assert torch.equal(ref.valid, ok)
        assert torch.equal(ref.ids, torch.where(ok, ids, -1))
        quads, qvalid = torch_prof_common.detect_upto(gray, a, "quads",
                                                      fused=fused)
        assert torch.equal(quads, handed[0][0])
        assert torch.equal(qvalid, handed[0][1])
        assert int(qvalid.sum()) > 0
        fr = make_frame(img, cam, cfg)
        _, order = stable_topk(ref.valid, a.max_markers_per_frame)
        assert torch.equal(torch.where(ref.valid[order], ref.ids[order], -1),
                           fr.mk_ids)
        assert int(fr.mk_valid.sum()) > 0


@pytest.mark.parametrize("argv,want", [
    ([], (16, 20)), (["--small"], (2, 1)), (["--b", "4", "--reps", "1"],
                                            (4, 1)),
    (["--small", "--b", "3"], (3, 1)), (["--reps", "2"], (16, 2))])
def test_counts_take_b_and_reps_over_the_defaults(argv, want):
    args = torch_prof_common.parser("x", counts=True).parse_args(argv)
    assert torch_prof_common.counts(args, 16, 20) == want


def test_the_tools_phase_runs_every_profiler_at_bench_width():
    """chip_smoke's tools phase runs the eight profilers of TOOLS at
    bench.py's configuration (none with --small)."""
    assert sorted(n for n, _ in chip_smoke.TOOL_RUNS) == sorted(
        "torch_" + n for n in TOOLS)
    for name, argv in chip_smoke.TOOL_RUNS:
        assert "--small" not in argv, name
        mod = TOOLS[name[len("torch_"):]][0]
        assert mod.__name__ == name
