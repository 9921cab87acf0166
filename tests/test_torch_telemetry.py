"""The port's spans and read counters (utils/telemetry.annotate,
tracking.SYNCS) on the CPU: the span totals, the profiler ranges they open
only while a profiler records, the frame id in a device_trace, and a
localization run on ref_small whose stage spans, branch passes and host
reads are counted frame by frame, with the same poses whether a profiler
records or not."""

import contextlib
import json
import sys
import time

import numpy as np
import pytest
import torch
from test_torch_slice import _load_ref, _port_frames

from orb_slam2_aruco_tpu_torch.pipeline import tracking
from orb_slam2_aruco_tpu_torch.utils.telemetry import (
    SPAN_CALLS,
    SPAN_NS,
    annotate,
    device_trace,
)

STAGES = ("tracking.motion", "tracking.retry", "tracking.refkf",
          "tracking.local_map")
# ref_small's 8 frames, then jumps back and forth: the motion model's seed
# for the last frame is far off, so it takes both fallbacks
ORDER = [0, 1, 2, 3, 4, 5, 6, 7, 0, 7, 2]
# deliberate host reads a frame, as counted before the reads went through
# tracking.host_read: the first frame relocalizes (4), every later one
# makes the cascade's two branch reads and the control read
READS = [4] + [3] * (len(ORDER) - 1)


def test_annotate_adds_to_the_totals_nested_and_as_a_decorator():
    calls0 = dict(SPAN_CALLS)
    ns0 = {k: SPAN_NS[k] for k in ("test.outer", "test.inner")}
    with annotate("test.outer"):
        time.sleep(0.002)
        for _ in range(2):
            with annotate("test.inner"):
                time.sleep(0.001)

    @annotate("test.inner")
    def inner(x):
        return x + 1

    assert inner(1) == 2 and inner.__name__ == "inner"
    assert SPAN_CALLS["test.outer"] - calls0.get("test.outer", 0) == 1
    assert SPAN_CALLS["test.inner"] - calls0.get("test.inner", 0) == 3
    outer = SPAN_NS["test.outer"] - ns0["test.outer"]
    inner_ns = SPAN_NS["test.inner"] - ns0["test.inner"]
    assert outer >= 4e6 and 2e6 <= inner_ns < outer


def test_a_name_never_entered_reads_zero():
    assert SPAN_NS["test.never_entered"] == 0
    assert SPAN_CALLS["test.never_entered"] == 0
    assert tracking.SYNCS["wait_ns"] >= 0


def test_no_profiler_no_profiler_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with annotate("test.off"), annotate("frame", {"frame_id": 1}):
        pass
    # under a profiler the same spans open their ranges
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            with annotate("test.on"):
                pass


def test_device_trace_holds_the_spans_and_the_frame_id(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        with annotate("frame", {"frame_id": 7}):
            with annotate("tracking.motion"):
                with annotate("pose_lm"):
                    torch.ones(16).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    spans = {e["name"]: e for e in events["traceEvents"]
             if e.get("ph") == "X" and e.get("name") in (
                 "frame", "tracking.motion", "pose_lm")}
    assert set(spans) == {"frame", "tracking.motion", "pose_lm"}
    assert spans["frame"]["args"]["frame_id"] == 7
    for outer, inner in (("frame", "tracking.motion"),
                         ("tracking.motion", "pose_lm")):
        o, i = spans[outer], spans[inner]
        assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def _localize(profile: bool):
    """ref_small's frames in ORDER against its map: per frame the poses,
    the span calls, the reads and their wait, and what the cascade's two
    branch reads returned; with `profile`, the profiler's host events."""
    path, ref = _load_ref("small")
    cfg, imgs, _ = _port_frames(ref)
    from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem

    system = SlamSystem(cfg, device="cpu")
    system.load_map(path)
    branch = []
    read = tracking.host_sync

    def host_sync(x):
        out = read(x)
        if sys._getframe(1).f_code.co_name in ("_cascade_seed",
                                                "_fallbacks"):
            branch[-1].append(out)
        return out

    frames = []
    ctx = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True)
        if profile else contextlib.nullcontext())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracking, "host_sync", host_sync)
        with ctx as prof:
            for j, i in enumerate(ORDER):
                calls0, syncs0 = dict(SPAN_CALLS), dict(tracking.SYNCS)
                branch.append([])
                pose = system.track_monocular(imgs[i], ts=j / 30.0)
                frames.append(dict(
                    pose=pose, branch=branch[-1],
                    calls={k: SPAN_CALLS[k] - calls0.get(k, 0)
                           for k in STAGES + ("pose_lm", "frame")},
                    reads=tracking.SYNCS["count"] - syncs0["count"],
                    wait_ns=tracking.SYNCS["wait_ns"] - syncs0["wait_ns"]))
    events = None
    if profile:
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                   e.kwinputs() if e.name() == "frame" else None)
                  for e in prof.profiler.kineto_results.events()
                  if e.name() in ("frame",) + STAGES + ("pose_lm",)]
    return frames, events


@pytest.fixture(scope="module")
def runs():
    return _localize(False), _localize(True)


def test_each_tracked_frame_enters_each_stage_once(runs):
    (frames, _), _ = runs
    assert frames[0]["calls"]["tracking.motion"] == 0   # relocalized
    for f in frames:
        assert f["calls"]["frame"] == 1
    for f in frames[1:]:
        assert f["pose"] is not None
        assert f["calls"]["tracking.motion"] == 1
        assert f["calls"]["tracking.local_map"] == 1
        assert f["calls"]["pose_lm"] >= 2


def test_fallback_passes_equal_the_branch_reads_taken(runs):
    (frames, _), _ = runs
    for f in frames[1:]:
        retry, refkf = f["branch"]
        assert f["calls"]["tracking.retry"] == int(retry)
        assert f["calls"]["tracking.refkf"] == int(refkf)
    # the jump back takes both fallbacks; the smooth frames take neither
    assert frames[-1]["branch"] == [True, True]
    assert sum(f["calls"]["tracking.retry"] for f in frames[1:-1]) == 0


def test_reads_a_frame_are_unchanged_and_timed(runs):
    for frames, _ in runs:
        assert [f["reads"] for f in frames] == READS
        assert all(f["wait_ns"] > 0 for f in frames)


def test_poses_are_bit_equal_under_a_profiler(runs):
    (off, _), (on, _) = runs
    for a, b in zip(off, on):
        assert (a["pose"] is None) == (b["pose"] is None)
        if a["pose"] is not None:
            for x, y in zip(a["pose"], b["pose"]):
                np.testing.assert_array_equal(x, y)
        assert a["calls"] == b["calls"] and a["branch"] == b["branch"]


def test_profiled_spans_nest_in_their_frame_with_its_id(runs):
    _, (frames, events) = runs
    roots = sorted((e for e in events if e[0] == "frame"),
                   key=lambda e: e[1])
    assert [e[3]["frame_id"] for e in roots] == list(range(len(ORDER)))
    stages = [e for e in events if e[0] != "frame"]
    assert len(stages) == sum(
        sum(n for k, n in f["calls"].items() if k != "frame")
        for f in frames)
    for name, a, b, _ in stages:
        assert any(r[1] <= a and b <= r[2] for r in roots), name
