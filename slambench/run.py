#!/usr/bin/env python3
"""The port's benchmark: one cell of BENCHMARK.json, run once on one card.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell names a configuration (configs/<file>.json: the camera, ORB,
ArUco and map settings as run, over SlamConfig's defaults), a traffic mix
(traffic/<mix>.json: the scene and camera paths that generator.py renders,
the set-up, and the window's drive) and its limits (limits/<cell>.json).
Set-up builds the CUDA kernels, renders every frame from the seed, builds
the map (a mix with a mapping sequence runs it in SLAM mode, then
localization mode) and warms up. The window then steps the mix's drive
(drives/<drive>.py, found by the name in the mix) for --seconds: the drive
hands frames to the program and records each pose and latency. Then the
program's poses, map and marker detections are compared with the scene's
truth (reference/compare.py), and the last line of standard output is one
JSON object: correct, attempted, failed, metrics, device, (with --trace 1)
breakdown, and the compared numbers with their limits.

--trace 0 reports the cell's end-to-end metrics: each of the kinds the
mix names for it, as its drive reads them (a rate over the window's time,
which ends in a synchronize; a percentile of every window frame's
latency), and setup_s (process start to the window's start).
--trace 1 runs the same window with the spans and counters the cell's
per-layer readers (layers/<metric>.py) ask for, then profiles a few more
frames of the same traffic with torch.profiler, and reports the per-layer
metrics.

Exits non-zero without a result when there is no CUDA card (or fewer than
the cell asks for), when the program is missing, or when JAX or the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import generator  # noqa: E402
import spans as tracing  # noqa: E402
from reference import compare  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_aruco_tpu")
PROGRAM = "orb_slam2_aruco_tpu_torch"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card():
    """(name, power limit) as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.rsplit(",", 1))
        return name, limit
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return torch.cuda.get_device_name(0), None


def merge(base: dict, over: dict) -> dict:
    out = {k: dict(v) for k, v in base.items()}
    for k, v in over.items():
        out.setdefault(k, {}).update(v)
    return out


def find(folder: str, name: str):
    """The module <folder>/<name>.py of the benchmark, else <folder>/<the
    name before its first dot>.py."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, folder, stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"slambench_{folder}_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no {folder}/{name}.py")


def reader(name: str):
    """The per-layer reader of a metric (layers/)."""
    return find("layers", name)


class TraceData:
    """What a per-layer reader reads: the window's spans, counters and
    frames, the profiled frames' device events, the configuration."""

    def __init__(self, spans, frames, counters, prof, slam):
        self.spans, self.frames, self.counters = spans, frames, counters
        self.profile, self.slam = prof, slam

    def span_ms(self, name):
        """Milliseconds of the window's spans called `name`."""
        return [s.ms for s in self.spans if s.name == name and s.frame >= 0]


def map_arrays(state) -> dict:
    """The map's valid keyframes, markers and points as host arrays."""
    kf = state.kf_valid.cpu().numpy()
    mk = state.mk_valid.cpu().numpy()
    pt = state.pt_valid.cpu().numpy()
    return dict(kf_frame_id=state.kf_frame_id.cpu().numpy()[kf],
                kf_Rcw=state.kf_Rcw.cpu().numpy()[kf],
                kf_tcw=state.kf_tcw.cpu().numpy()[kf],
                mk_id=state.mk_id.cpu().numpy()[mk],
                mk_Rwm=state.mk_Rwm.cpu().numpy()[mk],
                mk_twm=state.mk_twm.cpu().numpy()[mk],
                pt_xyz=state.pt_xyz.cpu().numpy()[pt])


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--report", default=None,
                    help="write each frame's latency and errors to this "
                         "JSON file")
    ap.add_argument("--control", default=None,
                    help="JSON settings laid over the program's "
                         "configuration only (the scene keeps the stated "
                         "ones): the control runs")
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"slambench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None, device=None, bench=None, root=ROOT,
         files=HERE) -> int:
    """Run one cell; returns the exit code. `device`, `bench` (the
    benchmark's dict), `root` (what a configuration's `file` is relative
    to) and `files` (the folder of traffic/ and limits/) are for the CPU
    tests; a run from the command line takes the card, BENCHMARK.json, the
    checkout and this folder."""
    args = parse(argv)
    try:
        bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    except OSError as e:
        return fail(f"cannot read BENCHMARK.json: {e}")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    if device is None:
        if not torch.cuda.is_available():
            return fail("no CUDA card: the benchmark runs on the card only")
        if torch.cuda.device_count() < int(cell["chips"]):
            return fail(f"the cell asks for {cell['chips']} cards, "
                        f"{torch.cuda.device_count()} present")
        device = "cuda"
    device = torch.device(device)
    cuda = device.type == "cuda"
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, conf_entry["file"]))
    traffic = load_json(os.path.join(files, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(files, "limits",
                                     cell["name"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    e2e_names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if (cell["name"] in m["workloads"] if "workloads" in m
                  else m["moves"] in e2e_names)]
    try:
        from orb_slam2_aruco_tpu_torch.config import SlamConfig
        from orb_slam2_aruco_tpu_torch.pipeline.system import SlamSystem
    except ImportError as e:
        return fail(f"the program {PROGRAM} cannot be imported: {e}")
    slam_settings = config["slam"]
    if args.control:
        slam_settings = merge(slam_settings, json.loads(args.control))
    cfg = SlamConfig.from_dict(slam_settings)
    # one process with few threads: the program's host work is one thread
    # of launches, and idle intra-op workers only add noise
    torch.set_num_threads(1)
    if cuda:
        from orb_slam2_aruco_tpu_torch.kernels import build
        build.build_all()
        torch.cuda.reset_peak_memory_stats(device)

    # set-up: frames, map, warm-up
    tr = generator.make_traffic(traffic, config, args.seed, device)
    fps = tr.cam["fps"]
    system = SlamSystem(cfg, device=device)
    setup = traffic["setup"]
    truth = {}
    if setup.get("map"):
        seq = tr.sequences[setup["map"]]
        for img, pose in zip(seq.frames, seq.poses):
            truth[system.frame_id] = pose
            system.track_monocular(img, len(truth) / fps)
        system.activate_localization_mode()
    win = traffic["window"]
    readers = {m["name"]: reader(m["name"]) for m in layers} \
        if args.trace else {}
    recorder = None
    if args.trace:
        sites = [s for r in readers.values() for s in getattr(r, "SPANS", [])]
        recorder = tracing.Recorder(sites, device)
    run = find("drives", win["drive"]).Drive(
        system, tr.sequences[win["sequence"]], fps, win, recorder)
    run.handed, run.truth = len(truth), truth
    for _ in range(int(setup.get("warmup_steps", 0))):
        run.step(-1, keep=False)
    counters = {k: v for r in readers.values()
                for k, v in getattr(r, "COUNTERS", {}).items()}
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()

    # the window
    if recorder is not None:
        recorder.install()
    c0 = tracing.read_counters(counters)
    setup_s = time.perf_counter() - T0
    w0 = time.perf_counter()
    k = 0
    while run.more() and (k == 0 or time.perf_counter() - w0 < args.seconds):
        run.step(k, keep=True)
        k += 1
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - w0
    c1 = tracing.read_counters(counters)
    n_window = len(run.records)

    prof = None
    if args.trace:
        tcfg = traffic.get("trace", {})

        def steps(n):
            def go():
                for _ in range(n):
                    if run.more():
                        run.step(-1, keep=True)
            return go
        if cuda:
            prof = tracing.profile(steps(int(tcfg.get("profile_steps", 6))),
                                   device)
            recorder.annotate = True
            host = tracing.profile(steps(int(tcfg.get("host_steps", 2))),
                                   device, host=True)
            recorder.annotate = False
            prof["idle_gaps"] = tracing.idle_gaps_by_host(host["device"],
                                                          host["host"])
        spans_ms = recorder.finish()
        recorder.restore()

    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    # the program's outputs to the host, then its state freed
    mp = map_arrays(system.map)
    detections = [(fid, *(x.cpu().numpy() for x in rest))
                  for fid, *rest in run.detections]
    records = run.records
    del system, run.system, run.detections
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers = compare.compare(tr.world, tr.cam, truth,
                              [(fid, p) for fid, p, _ in records], mp,
                              detections,
                              tr.sequences[win["sequence"]].distance)
    per_frame = numbers.pop("per_frame", [])
    wrong_ids = numbers.pop("wrong_id_list", [])
    correct, rows = compare.judge(numbers, limits["limits"])
    if args.report:
        def lists(x):
            return np.asarray(x, np.float64).tolist()
        lat = {fid: sec for fid, _, sec in records}
        with open(args.report, "w") as f:
            json.dump({"frames": [[fid, lat.get(fid), cm, deg]
                                  for fid, cm, deg in per_frame],
                       "lost": [fid for fid, p, _ in records if p is None],
                       "wrong_ids": wrong_ids,
                       "numbers": numbers,
                       "truth": {fid: [lists(R), lists(t)]
                                 for fid, (R, t) in truth.items()},
                       "posed": [[fid, None if p is None else
                                  [lists(p[0]), lists(p[1])]]
                                 for fid, p, _ in records],
                       "map": {k: lists(v) for k, v in mp.items()},
                       "detections": [[fid] + [lists(x) for x in rest]
                                      for fid, *rest in detections]}, f)
    # frames the program gave no pose after its first one (all, if none)
    first = next((i for i, r in enumerate(records) if r[1] is not None),
                 n_window)
    failed = (n_window if first >= n_window else
              sum(r[1] is None for r in records[first:n_window]))

    found = forbidden_modules()
    if found:
        print(f"slambench: loaded in this process: {', '.join(found)} "
              f"(top-level names of JAX or the JAX package)",
              file=sys.stderr, flush=True)
        return 3

    name, limit = card() if cuda else ("cpu", None)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": int(cell["chips"]), "memory_peak_bytes": peak,
           "power_limit": limit}
    line = {"correct": correct, "attempted": n_window, "failed": failed}
    if args.trace:
        data = TraceData(spans_ms, n_window,
                         {k: c1[k] - c0[k] for k in counters}, prof,
                         config["slam"])
        metrics = {}
        for m in layers:
            v = readers[m["name"]].read(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        line["metrics"] = metrics
        if prof is not None:
            from reference import trace_math
            busy = trace_math.union_ns([(a, b) for _, a, b in prof["device"]])
            dev["busy_s"] = busy / 1e9
            dev["window_s"] = prof["window_ns"] / 1e9
            ops = sorted(tracing.kernel_totals(prof["device"]).items(),
                         key=lambda kv: -kv[1][1])[:10]
            gaps = sorted(prof["idle_gaps"].items(), key=lambda kv: -kv[1])
            line["breakdown"] = {
                "device_ops": [[n[:200], v[1]] for n, v in ops],
                "idle_gaps": [[n[:200], s] for n, s in gaps[:10]]}
    else:
        metrics = {}
        for m in e2e:
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = run.value(traffic["metrics"][m["name"]], n_window,
                              window_s)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        line["metrics"] = metrics
    line["device"] = dev
    line["window"] = {"frames": n_window, "seconds": window_s,
                      "frames_profiled": len(records) - n_window}
    line["diagnostics"] = {k: v for k, v in numbers.items()
                           if k not in limits["limits"]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    print(f"correct {correct}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
