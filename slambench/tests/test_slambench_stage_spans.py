"""The readers of the program's own spans and counters on the CPU at a tiny
size: the tiny cell, traced, with BENCHMARK.json's stage metrics, prints
each of them above 0, and the stages fit inside the benchmark's own wraps
of the same frames."""

import copy
import json
import os

import torch

import run

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))

STAGE_METRICS = ("motion_ms.loc", "local_map_ms.loc", "pose_lm_ms.loc",
                 "passes_per_frame.loc", "sync_wait_ms.loc", "orb_ms.loc",
                 "aruco_ms.loc")
# the stage spans run on the host clock, the wraps on the same clock here
# (CUDA events on the card): a little room for the clock reads between them
SLACK = 1.01


def tiny_bench():
    """The tiny cell's benchmark with BENCHMARK.json's stage metrics in it."""
    with open(os.path.join(DATA, "bench.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        accepted = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in STAGE_METRICS:
        m = copy.deepcopy(accepted[name])
        m["workloads"] = ["tiny.loc"]
        bench["per_layer"].append(m)
    return bench


def test_stage_metrics_are_printed_and_fit_inside_the_wraps(capsys):
    torch.set_num_threads(2)
    rc = run.main(["--workload", "tiny.loc", "--seed", str(2 ** 31 + 11),
                   "--seconds", "3", "--trace", "1"], device="cpu",
                  bench=tiny_bench(), root=DATA, files=DATA)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    for name in STAGE_METRICS:
        assert metrics[name] > 0, name
    assert metrics["passes_per_frame.loc"] >= 2
    # per window frame against the wraps' mean a call: a lost frame makes
    # no track_full call and no stage span, so the bound only loosens
    stages = metrics["motion_ms.loc"] + metrics["local_map_ms.loc"]
    assert stages <= metrics["tracking_ms.loc"] * SLACK
    if line["failed"] == 0:
        # every pose LM ran inside the two stages (a relocalization runs
        # its own)
        assert metrics["pose_lm_ms.loc"] < stages
    frontend = metrics["orb_ms.loc"] + metrics["aruco_ms.loc"]
    assert frontend <= metrics["frontend_ms.loc"] * SLACK
    assert line["metrics"]["orb_ms.loc"]["unit"] == "ms"
    assert line["metrics"]["passes_per_frame.loc"]["unit"] == "passes/frame"
