"""The per-frame drive: one camera in a closed loop. Each step hands the
next frame of the sequence to `SlamSystem.track_monocular` and waits for
its pose on the host; the next frame goes no sooner than the mix's
`pace_hz` allows (the window's frames only; warm-up frames are not paced).
The sequence is cycled where the mix says `cycle`.

A frame's latency runs from the moment it is handed to the moment its pose
is on the host; a frame with no pose (LOST) is recorded with None.

Metric kinds a traffic file may name for this drive:

  rate   frames over the window's seconds (which end in a synchronize)
  pNN    the NN-th percentile of every window frame's latency, in ms
"""

import time

import numpy as np
import torch


class Drive:
    """One run's frames: what was handed and what came back.

    records:    [(frame id, (Rcw, tcw) float64 or None, seconds)] of the
                frames kept for the checks, in the order handed
    truth:      {frame id: true (Rcw, tcw)} of every frame handed
    detections: [(frame id, mk_ids, mk_corners, mk_valid, mk_tcm)] of the
                kept frames that got a pose and built a frame
    """

    def __init__(self, system, seq, fps, window, recorder=None):
        self.system, self.seq, self.fps = system, seq, fps
        self.cycle = bool(window.get("cycle", False))
        self.pace = 1.0 / float(window["pace_hz"])
        self.pos = 0                # next index into the sequence
        self.handed = 0             # frames handed to the program so far
        self.truth = {}
        self.records = []
        self.detections = []
        self.recorder = recorder
        self.last_start = None

    def more(self) -> bool:
        return self.cycle or self.pos < len(self.seq.frames)

    def step(self, tag: int, keep: bool):
        """Hand the next frame, paced; record its pose and latency (`keep`:
        the pose and the detections join the checks). `tag` is the window's
        frame number for the spans (-1 outside the window)."""
        i = self.pos % len(self.seq.frames)
        self.pos += 1
        sysm = self.system
        if keep and self.last_start is not None:
            wait = self.last_start + self.pace - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        fid = sysm.frame_id
        self.truth[fid] = self.seq.poses[i]
        if self.recorder is not None:
            self.recorder.frame = tag
        before = sysm.last_frame
        t0 = time.perf_counter()
        pose = sysm.track_monocular(self.seq.frames[i],
                                    self.handed / self.fps)
        if pose is not None:
            pose = tuple(np.asarray(torch.as_tensor(p).cpu(), np.float64)
                         for p in pose)
        seconds = time.perf_counter() - t0
        self.last_start = t0
        self.handed += 1
        if keep:
            self.records.append((fid, pose, seconds))
            lf = sysm.last_frame
            if pose is not None and lf is not None and lf is not before:
                self.detections.append((fid, lf.mk_ids, lf.mk_corners,
                                        lf.mk_valid, lf.mk_tcm))

    def value(self, kind: str, n: int, window_s: float) -> float:
        """A metric of the kind above over the window's first `n` records."""
        if kind == "rate":
            return n / window_s
        if kind.startswith("p"):
            return 1e3 * float(np.percentile(
                [r[2] for r in self.records[:n]], float(kind[1:])))
        raise ValueError(f"unknown metric kind {kind!r}")
