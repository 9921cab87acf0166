"""The reader of cascade_graph_share.loc (layers/cascade_graph_share.py):
the program's counter `tracking.GRAPH` by route, read as the harness reads
it, and through a traced run of the tiny cell on the CPU, where every
cascade takes the eager route."""

import copy
import json
import os

import torch

import run
from orb_slam2_aruco_tpu_torch.pipeline import tracking

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))
NAME = "cascade_graph_share.loc"


class _Trace:
    def __init__(self, counters, frames=10):
        self.counters, self.frames = counters, frames


def test_reader_reads_the_replayed_share():
    r = run.reader(NAME)
    assert r.COUNTERS == {
        "cascade_graph.replay": (tracking.__name__, "GRAPH", "replay"),
        "cascade_graph.eager": (tracking.__name__, "GRAPH", "eager")}
    # the card in localization mode, once set-up has captured the key
    assert r.read(_Trace({"cascade_graph.replay": 3300.0,
                          "cascade_graph.eager": 0.0})) == 100.0
    # the CPU
    assert r.read(_Trace({"cascade_graph.replay": 0.0,
                          "cascade_graph.eager": 40.0})) == 0.0
    assert r.read(_Trace({"cascade_graph.replay": 3.0,
                          "cascade_graph.eager": 1.0})) == 75.0


def test_a_window_without_cascades_leaves_the_metric_out():
    r = run.reader(NAME)
    assert r.read(_Trace({"cascade_graph.replay": 0.0,
                          "cascade_graph.eager": 0.0})) is None


def test_a_program_without_the_counter_leaves_the_metric_out(monkeypatch):
    monkeypatch.delattr(tracking, "GRAPH")
    r = run.reader(NAME)
    assert r.COUNTERS == {}
    assert r.read(_Trace({})) is None


def test_the_tiny_cell_reads_the_eager_route_on_the_cpu(capsys):
    with open(os.path.join(DATA, "bench.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = copy.deepcopy({m["name"]: m for m in
                           json.load(f)["per_layer"]}[NAME])
    m["workloads"] = ["tiny.loc"]
    bench["per_layer"].append(m)
    torch.set_num_threads(2)
    rc = run.main(["--workload", "tiny.loc", "--seed", str(2 ** 31 + 24),
                   "--seconds", "2", "--trace", "1"], device="cpu",
                  bench=bench, root=DATA, files=DATA)
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metrics"][NAME] == {"value": 0.0, "unit": "%"}
