"""Spans, counters and the profiler for the traced run.

Spans are recorded from the benchmark's side: `Recorder` replaces a
function of the program, at the name the program looks it up by, with a
wrapper that records CUDA events around each call (the host clock off
CUDA) and the window's frame it belongs to.
Per-layer readers (layers/<metric>.py) name the functions they need.
`profile` runs a stretch of frames under torch.profiler and returns the
device's kernels and copies, read from the raw trace (a frame launches
some 20 000 kernels, too many for the profiler's per-event objects).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from typing import Callable, Dict, List, Tuple

import torch

from reference import trace_math

ANNOTATION = "slambench."


@dataclasses.dataclass
class Span:
    name: str
    frame: int
    start: object
    end: object
    ms: float = 0.0


def resolve(module: str, attr: str):
    """(owner, attribute name) of `module`:`attr`, where attr may be
    Class.method."""
    owner = importlib.import_module(module)
    *path, last = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, last


class Recorder:
    """Wraps the program's functions named by `sites` = [(module, attr,
    span name)] while installed; `frame` is set by the harness before each
    frame, `annotate` marks each span for the profiler too."""

    def __init__(self, sites, device):
        self.sites = list(dict.fromkeys(tuple(s) for s in sites))
        self.cuda = torch.device(device).type == "cuda"
        self.spans: List[Span] = []
        self.frame = -1
        self.annotate = False
        self._saved = []

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def _wrap(self, fn: Callable, name: str) -> Callable:
        def wrapper(*args, **kwargs):
            ctx = (torch.profiler.record_function(ANNOTATION + name)
                   if self.annotate else contextlib.nullcontext())
            start = self._mark()
            try:
                with ctx:
                    return fn(*args, **kwargs)
            finally:
                self.spans.append(Span(name, self.frame, start,
                                       self._mark()))
        return wrapper

    def install(self):
        for module, attr, name in self.sites:
            owner, last = resolve(module, attr)
            fn = owner.__dict__[last] if isinstance(owner, type) \
                else getattr(owner, last)
            self._saved.append((owner, last, fn))
            setattr(owner, last, self._wrap(fn, name))

    def restore(self):
        for owner, last, fn in reversed(self._saved):
            setattr(owner, last, fn)
        self._saved = []

    def finish(self) -> List[Span]:
        """Every span with its milliseconds (after a synchronize)."""
        if self.cuda:
            torch.cuda.synchronize()
        for s in self.spans:
            s.ms = (s.start.elapsed_time(s.end) if self.cuda
                    else (s.end - s.start) * 1e3)
            s.start = s.end = None
        return self.spans


def read_counters(counters: Dict[str, Tuple[str, str, str]]) -> Dict[str, float]:
    """{name: value} of each (module, dict attribute, key) counter."""
    out = {}
    for name, (module, attr, key) in counters.items():
        owner, last = resolve(module, attr)
        out[name] = float(getattr(owner, last)[key])
    return out


def profile(fn: Callable, device, host: bool = False) -> dict:
    """Run fn() under torch.profiler (the device's activity; with `host`
    the host's operators and the spans' annotations too). Returns {device:
    [(name, start ns, end ns)] of every kernel and copy, window_ns: the host
    window around fn(), which ends in a synchronize, host: [(name, start
    ns, end ns)] of the host's events (with `host`)}."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize(device)
        window_ns = time.perf_counter_ns() - t0
    dev, hst = [], []
    cuda_type = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == cuda_type:
            # a record_function range is drawn on the device's timeline
            # too; it is no device work
            if not (span[0].startswith(ANNOTATION)
                    or getattr(e, "is_user_annotation", bool)()):
                dev.append(span)
        elif host:
            hst.append(span)
    return dict(device=dev, window_ns=window_ns, host=hst)


def kernel_totals(device_events) -> Dict[str, List[float]]:
    """{name: [launches, seconds]} of the device's events."""
    out: Dict[str, List[float]] = {}
    for name, a, b in device_events:
        row = out.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (b - a) / 1e9
    return out


def idle_gaps_by_host(device_events, host_events) -> Dict[str, float]:
    """{what the host was in: idle seconds}: each gap between the device's
    busy intervals, labelled by the innermost benchmark span and the
    innermost host operator around the gap's midpoint ("between frames",
    "python" where there is none)."""
    gaps = trace_math.gaps([(a, b) for _, a, b in device_events])
    if not gaps:
        return {}
    events = sorted(host_events, key=lambda e: (e[1], -e[2]))
    queries = sorted(((a + b) // 2, b - a) for a, b in gaps)
    out: Dict[str, float] = {}
    stack: List[Tuple[str, int, int]] = []
    i = 0
    for t, length in queries:
        while i < len(events) and events[i][1] <= t:
            while stack and stack[-1][2] <= events[i][1]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        live = [e for e in stack if e[2] > t]
        span = next((e[0][len(ANNOTATION):] for e in reversed(live)
                     if e[0].startswith(ANNOTATION)), "between frames")
        op = next((e[0] for e in reversed(live)
                   if not e[0].startswith(ANNOTATION)), "python")
        key = f"{span} / {op}"
        out[key] = out.get(key, 0.0) + length / 1e9
    return out
