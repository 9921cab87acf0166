"""The KITTI-shaped cell on the CPU at a tiny size: a rectified camera of
odd width (621x188), a row of markers, an out-and-back lane and a pace that
binds nothing (data/configs/tiny-kitti.json, data/traffic/
tiny-loc-drive.json). The cell is added to the tiny benchmark of
test_slambench_harness.py as kitti.loc-frame is added to BENCHMARK.json:
a configuration, a workload, and its name appended to each metric's
`workloads`. Its contract line is checked by that file's rules, and the
control on the card comes out not correct on kitti.loc-frame as on
tum1.loc-frame."""

import json
import os

import pytest
import torch

import run

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))

WORKLOAD = "tiny.drive"
CONTROL = json.dumps({"aruco": {"marker_size": 0.165}})


def drive_bench():
    """The tiny benchmark with the tiny drive added."""
    with open(os.path.join(DATA, "bench.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-kitti",
                             "file": "configs/tiny-kitti.json"})
    bench["workloads"].append({"name": WORKLOAD, "config": "tiny-kitti",
                               "traffic": "tiny-loc-drive", "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(WORKLOAD)
    return bench


def test_the_drive_is_kitti_shaped():
    with open(os.path.join(DATA, "configs", "tiny-kitti.json")) as f:
        cam = json.load(f)["slam"]["camera"]
    with open(os.path.join(DATA, "traffic", "tiny-loc-drive.json")) as f:
        traffic = json.load(f)
    assert cam["width"] % 2 == 1 and not any(cam["dist"])
    assert traffic["scene"]["rows"] == 1
    out, back = traffic["sequences"]["window"]["segments"]
    assert out["from"] == back["to"] and out["to"] == back["from"]
    assert traffic["window"]["pace_hz"] >= 1000.0


@pytest.mark.parametrize("trace", [0, 1])
def test_drive_prints_the_contract_line(trace, capsys, tmp_path):
    torch.set_num_threads(2)
    bench = drive_bench()
    report = tmp_path / "report.json"
    rc = run.main(["--workload", WORKLOAD, "--seed", str(2 ** 31 + 7),
                   "--seconds", "3.0", "--trace", str(trace),
                   "--report", str(report)],
                  device="cpu", bench=bench, root=DATA, files=DATA)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    with open(report) as f:
        rep = json.load(f)
    assert len(rep["posed"]) == line["attempted"] + \
        line["window"]["frames_profiled"]
    if trace == 0:
        want = {m["name"] for m in bench["end_to_end"]
                if WORKLOAD in m.get("workloads", [WORKLOAD])}
        assert set(line["metrics"]) == want == {"loc_fps", "loc_p95_ms",
                                                "setup_s"}
    else:
        names = {m["name"] for m in bench["per_layer"]
                 if WORKLOAD in m["workloads"]}
        assert {"frontend_ms.loc", "tracking_ms.loc"} \
            <= set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert m["value"] > 0


def test_the_benchmark_reports_the_kitti_cell():
    """kitti.loc-frame reports the end-to-end metrics of tum1.loc-frame
    and every per-layer metric that reads either cell."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    cell = {w["name"]: w for w in b["workloads"]}["kitti.loc-frame"]
    assert cell["chips"] == 1 and cell["config"] == "kitti00-1241x376"
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "tum1.loc-frame" in m["workloads"]:
            assert "kitti.loc-frame" in m["workloads"], m["name"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23])
def test_control_is_not_correct_on_the_kitti_cell(seed, cuda_device,
                                                  capsys):
    rc = run.main(["--workload", "kitti.loc-frame", "--seed", str(seed),
                   "--seconds", "20", "--trace", "0", "--control", CONTROL])
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
