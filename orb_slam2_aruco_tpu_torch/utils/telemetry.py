"""Frame-time metrics, spans and device tracing.

Port of orb_slam2_aruco_tpu/utils/telemetry.py. The reference times
TrackMonocular on the wall clock and prints the sorted median / mean
(Examples/Monocular/mono_marker.cc:247-264, 279-287): `FrameTimer` keeps
that as an object. `device_trace` wraps a region in a torch.profiler trace
of the host and the card, written as a Chrome trace (Perfetto,
chrome://tracing).

`annotate(name)` is the program's one span. It always adds its host-clock
nanoseconds to `SPAN_NS[name]` and one call to `SPAN_CALLS[name]` (a name
never entered reads 0), and while a profiler is active it is also a
torch.profiler range of that name, in the same trace as the card's
kernels; with no profiler it costs two clock reads. The spans the program
enters, each frame nested in the root span `frame`:

  frame               SlamSystem.track_monocular (its frame id in the trace)
  frontend.orb        make_frame: pyramid, FAST, patches, angles, BRIEF, BoW
  frontend.aruco      make_frame: detector, corner refinement, undistortion,
                      IPPE
  tracking.motion     the cascade's marker seed and motion-model track,
                      through its first branch read
  tracking.retry      the widened-window track (when taken)
  tracking.refkf      the reference-keyframe track (when taken)
  tracking.local_map  the local-map search, pose refine and keyframe inputs
  pose_lm             every call of optim/pose_opt.optimize_pose
  mapping.insert      SlamSystem._insert_keyframe (SLAM mode)
  mapping.local_ba    the mapping phase's local bundle adjustment
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

# host nanoseconds and calls of each span name since the process started;
# readers take differences
SPAN_NS: Dict[str, int] = collections.defaultdict(int)
SPAN_CALLS: Dict[str, int] = collections.defaultdict(int)


class FrameTimer:
    """Wall-clock per-frame latencies with percentiles and a histogram.

        timer = FrameTimer(warmup=5)
        with timer.frame():
            slam.track_monocular(img, ts)
        print(timer)
    """

    def __init__(self, warmup: int = 0):
        self.warmup = warmup
        self.times_s: List[float] = []

    @contextlib.contextmanager
    def frame(self, n: int = 1):
        """Time one unit of work covering `n` frames (n > 1 for a chunk,
        e.g. SlamSystem.track_monocular_batch)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) / max(n, 1)
            self.times_s.extend([dt] * n)

    def _ms(self) -> np.ndarray:
        return np.asarray(self.times_s[self.warmup:], dtype=np.float64) * 1e3

    def percentile(self, q: float) -> float:
        ms = self._ms()
        return float(np.percentile(ms, q)) if ms.size else float("nan")

    def histogram(self, bins: int = 20) -> Dict[str, np.ndarray]:
        ms = self._ms()
        if not ms.size:
            return {"edges_ms": np.zeros(1), "counts": np.zeros(0, int)}
        counts, edges = np.histogram(ms, bins=bins)
        return {"edges_ms": edges, "counts": counts}

    def report(self) -> Dict[str, float]:
        ms = self._ms()
        if not ms.size:
            return {"frames": 0}
        return {
            "frames": int(ms.size),
            "median_ms": float(np.median(ms)),
            "mean_ms": float(np.mean(ms)),
            "p90_ms": float(np.percentile(ms, 90)),
            "p99_ms": float(np.percentile(ms, 99)),
            "fps": float(1e3 / np.mean(ms)),
        }

    def __str__(self):
        r = self.report()
        if not r.get("frames"):
            return "FrameTimer(empty)"
        return (f"median tracking time: {r['median_ms']:.1f} ms | "
                f"mean: {r['mean_ms']:.1f} ms | p90: {r['p90_ms']:.1f} ms | "
                f"{r['fps']:.1f} fps over {r['frames']} frames")


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Trace the region with torch.profiler (host ops with their input
    shapes, which also carry each `frame` span's frame id, and the card's
    kernels and copies when CUDA is available) into `log_dir`/trace.json.
    Nothing happens when log_dir is None, so a command-line flag can be
    passed straight through."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Span:
    """One entry of a span (see annotate). `args` ({key: int or str}) is
    shown with the range in a trace that records input shapes."""

    __slots__ = ("name", "args", "_t0", "_range")

    def __init__(self, name: str, args: Optional[dict] = None):
        self.name, self.args = name, args

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            # torch.profiler.record_function drops its string argument
            # from the trace; the fast range keeps keyword values
            self._range = (
                torch.profiler.record_function(self.name) if self.args is None
                else torch._C._profiler._RecordFunctionFast(
                    self.name, [], self.args))
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        SPAN_NS[self.name] += time.perf_counter_ns() - self._t0
        SPAN_CALLS[self.name] += 1
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def __call__(self, fn):
        """As a decorator: every call of fn is one span."""
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with _Span(self.name, self.args):
                return fn(*args, **kwargs)
        return spanned


def annotate(name: str, args: Optional[dict] = None) -> _Span:
    """A span named `name`, entered with `with` or put on a function as a
    decorator: host-clock totals in SPAN_NS / SPAN_CALLS always, and a
    named range inside a device_trace (or any torch.profiler) timeline
    while one is recording. `args` ({key: value}) goes with the range."""
    return _Span(name, args)
