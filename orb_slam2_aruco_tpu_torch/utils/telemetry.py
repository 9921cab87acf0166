"""Frame-time metrics and device tracing.

Port of orb_slam2_aruco_tpu/utils/telemetry.py. The reference times
TrackMonocular on the wall clock and prints the sorted median / mean
(Examples/Monocular/mono_marker.cc:247-264, 279-287): `FrameTimer` keeps
that as an object. `device_trace` wraps a region in a torch.profiler trace
of the host and the card, written as a Chrome trace (Perfetto,
chrome://tracing); `annotate` names a host region inside it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np


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
    """Trace the region with torch.profiler (host ops, and the card's
    kernels and copies when CUDA is available) into
    `log_dir`/trace.json. Nothing happens when log_dir is None, so a
    command-line flag can be passed straight through."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named host region inside a device_trace timeline
    (torch.profiler.record_function)."""
    import torch

    with torch.profiler.record_function(name):
        yield
