"""The harness on the CPU at a tiny size: a cell found by name prints the
contract's last line with tracing off and on; BENCHMARK.json keeps the
contract's shape; nothing the benchmark imports is JAX or the JAX package,
and the reference imports nothing of the program."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import run

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny(workload, trace, capsys, seconds=3.0, seed=2 ** 31 + 7,
         extra=()):
    """Run a tiny cell on the CPU; returns (exit code, the last stdout line
    as a dict or None, stderr)."""
    torch.set_num_threads(2)
    with open(os.path.join(DATA, "bench.json")) as f:
        bench = json.load(f)
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace), *extra],
                  device="cpu", bench=bench, root=DATA, files=DATA)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_the_contract_line(trace, capsys, tmp_path):
    workload = "tiny.loc"
    report = tmp_path / "report.json"
    rc, line, err = tiny(workload, trace, capsys,
                         extra=("--report", str(report)))
    assert rc == 0, err
    with open(report) as f:
        rep = json.load(f)
    assert len(rep["posed"]) == line["attempted"] + \
        line["window"]["frames_profiled"]
    assert rep["numbers"]["pose_err_max_cm"] == \
        line["checks"]["pose_err_max_cm"]["value"]
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    with open(os.path.join(DATA, "bench.json")) as f:
        bench = json.load(f)
    if trace == 0:
        want = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(line["metrics"]) == want
    else:
        # off the card the profiler's metrics have nothing to read and
        # are left out; the span and counter metrics are there
        names = {m["name"] for m in bench["per_layer"]
                 if workload in m["workloads"]}
        assert set(line["metrics"]) <= names
        assert {n for n in names if n.startswith(("frontend_ms",
                                                  "tracking_ms"))} \
            <= set(line["metrics"])
    for m in line["metrics"].values():
        assert m["value"] > 0
    # the compared numbers, each beside its limit, end standard error
    tail = err.strip().splitlines()[-len(line["checks"]) - 1:]
    assert tail[0] == f"correct {line['correct']}"
    for row, (k, v) in zip(tail[1:], line["checks"].items()):
        assert row == f"check {k} {v['value']!r} limit {v['limit']!r}"


def test_no_card_no_result(capsys):
    """From the command line the benchmark runs on the card only."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "tum1.loc-frame", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "no CUDA card" in err


def test_without_the_program_no_result(tmp_path):
    """In a folder with only BENCHMARK.json and the benchmark's files the
    run fails and prints nothing on standard output."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload",
                        "tum1.loc-frame", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_json_keeps_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "slambench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        c = configs[w["config"]]
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("slambench/")
        with open(os.path.join(BENCH, "traffic",
                               w["traffic"] + ".json")) as f:
            run.find("drives", json.load(f)["window"]["drive"])
        with open(os.path.join(BENCH, "limits", w["name"] + ".json")) as f:
            assert json.load(f)["limits"]
        reports = [m for m in b["end_to_end"]
                   if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reports) >= 2
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        run.reader(m["name"])                    # its reader is found


def modules_after(code):
    """Top-level module names loaded by `code` in a fresh interpreter."""
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([BENCH, ROOT])))
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_nothing_the_run_imports_is_jax():
    """run.py and every module of the program that a run drives; compared by
    whole top-level names, since the program's name begins with the JAX
    package's."""
    tops = modules_after(
        "import run, generator, spans\n"
        "from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem\n"
        "from orb_slam2_aruco_tpu_torch.kernels import build\n"
        "run.find('drives', 'frame')\n"
        "for m in __import__('json').load(open('BENCHMARK.json'))"
        "['per_layer']: run.reader(m['name'])")
    assert "orb_slam2_aruco_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            with open(os.path.join(ref, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom):
                    tops = {(node.module or "").split(".")[0]}
                else:
                    continue
                assert not tops & {"orb_slam2_aruco_tpu_torch", "jax",
                                   "orb_slam2_aruco_tpu", "run",
                                   "generator", "spans"}, (name, tops)
    tops = modules_after("from reference import compare, kernels, scene, "
                         "trace_math")
    assert not tops & {"orb_slam2_aruco_tpu_torch", *run.FORBIDDEN}
