"""Frame ingestion: video files, image folders, camera files, and the
double-buffered host->device staging.

Port of orb_slam2_aruco_tpu/io/ingest.py, replacing the reference CLIs'
input machinery:
  * createYMLfromOpencvCamera (Examples/Monocular/mono_cvcam.cc:31-95):
    an OpenCV calibration file with optional rescaling of fx/fy/cx/cy to
    the processing size -> camera_from_opencv_yaml;
  * the ORB-SLAM-style yml (Camera.fx: ..., Tracking.cc:58-143) ->
    camera_from_slam_yaml (pure Python);
  * the cv::VideoCapture frame loop (mono_cvcam.cc:115-181) -> VideoSource;
  * LoadImages, an image folder + timestamps (mono_marker.cc:355-376) ->
    ImageFolderSource;
  * the production frame loop (mono_cvcam.cc:141-148) -> StagedSource.

cv2 decodes on the host and is imported only when a function needs it
(`_require_cv2`): without it those functions raise ImportError, nothing
falls back. Every source yields (gray uint8 [H, W], timestamp seconds)
resized to the camera geometry.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch import require_device
from orb_slam2_aruco_tpu_torch.config import CameraConfig


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:
        raise ImportError(
            "orb_slam2_aruco_tpu_torch.io.ingest needs opencv-python for "
            "host-side video/image decode") from e


def camera_from_opencv_yaml(path: str,
                            out_size: Optional[Tuple[int, int]] = None,
                            fps: float = 30.0) -> CameraConfig:
    """An OpenCV calibration FileStorage yml/xml (camera_matrix,
    distortion_coefficients, image_width/height) as a CameraConfig, the
    intrinsics rescaled when `out_size` = (width, height) differs from the
    calibrated size (createYMLfromOpencvCamera, mono_cvcam.cc:52-61)."""
    cv2 = _require_cv2()
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    if not fs.isOpened():
        raise FileNotFoundError(path)
    K = fs.getNode("camera_matrix").mat()
    dist = fs.getNode("distortion_coefficients").mat()
    w = int(fs.getNode("image_width").real())
    h = int(fs.getNode("image_height").real())
    fs.release()
    if K is None or dist is None:
        raise ValueError(f"{path}: missing camera_matrix / "
                         "distortion_coefficients")
    K = K.astype(np.float64)
    d = dist.reshape(-1).astype(np.float64)
    d = np.concatenate([d, np.zeros(max(0, 5 - d.size))])[:5]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if out_size is not None:
        sx = out_size[0] / float(w)
        sy = out_size[1] / float(h)
        fx, cx = fx * sx, cx * sx
        fy, cy = fy * sy, cy * sy
        w, h = out_size
    return CameraConfig(fx=float(fx), fy=float(fy), cx=float(cx),
                        cy=float(cy), dist=tuple(float(v) for v in d),
                        width=int(w), height=int(h), fps=fps)


def camera_from_slam_yaml(path: str) -> CameraConfig:
    """The reference's ORB-SLAM-style yml (Camera.fx etc., the format
    createYMLfromOpencvCamera writes and Tracking.cc:58-143 reads) as a
    CameraConfig; needs no cv2."""
    vals = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if ":" not in line or line.startswith("%"):
                continue
            k, v = line.split(":", 1)
            try:
                vals[k.strip()] = float(v.strip())
            except ValueError:
                pass
    need = ["Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy"]
    if any(k not in vals for k in need):
        raise ValueError(f"{path}: missing {need}")
    dist = tuple(vals.get(k, 0.0) for k in
                 ("Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2",
                  "Camera.k3"))
    return CameraConfig(
        fx=vals["Camera.fx"], fy=vals["Camera.fy"], cx=vals["Camera.cx"],
        cy=vals["Camera.cy"], dist=dist,
        width=int(vals.get("Camera.width", 0) or 0) or 960,
        height=int(vals.get("Camera.height", 0) or 0) or 540,
        fps=vals.get("Camera.fps", 30.0))


def _to_gray(frame: np.ndarray, size: Tuple[int, int], cv2) -> np.ndarray:
    if frame.ndim == 3:
        # the reference converts with the yml's RGB flag (Tracking.cc:167)
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    if (frame.shape[1], frame.shape[0]) != size:
        frame = cv2.resize(frame, size, interpolation=cv2.INTER_AREA)
    return np.ascontiguousarray(frame, dtype=np.uint8)


@dataclasses.dataclass
class VideoSource:
    """Video-file frame iterator (mono_cvcam.cc:115-181): resizes to the
    camera geometry, yields (gray uint8, timestamp)."""

    path: str
    camera: CameraConfig

    def __iter__(self) -> Iterator[Tuple[np.ndarray, float]]:
        cv2 = _require_cv2()
        cap = cv2.VideoCapture(self.path)
        if not cap.isOpened():
            raise FileNotFoundError(self.path)
        fps = cap.get(cv2.CAP_PROP_FPS) or self.camera.fps
        size = (self.camera.width, self.camera.height)
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield _to_gray(frame, size, cv2), idx / max(fps, 1e-6)
            idx += 1
        cap.release()


@dataclasses.dataclass
class ImageFolderSource:
    """Image-directory iterator. With `times_file` it follows the reference
    LoadImages convention (mono_marker.cc:355-376): each line is a stem;
    image = dir/<stem><ext>, timestamp = float(stem) / 1e6. Without it the
    images are taken in sorted order at the camera fps."""

    path: str
    camera: CameraConfig
    times_file: Optional[str] = None
    ext: str = ".png"

    def _entries(self):
        if self.times_file:
            with open(self.times_file) as f:
                stems = [ln.strip() for ln in f if ln.strip()]
            return [(os.path.join(self.path, s + self.ext), float(s) / 1e6)
                    for s in stems]
        names = sorted(
            n for n in os.listdir(self.path)
            if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
        return [(os.path.join(self.path, n), i / self.camera.fps)
                for i, n in enumerate(names)]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, float]]:
        cv2 = _require_cv2()
        size = (self.camera.width, self.camera.height)
        for fname, ts in self._entries():
            img = cv2.imread(fname, cv2.IMREAD_UNCHANGED)
            if img is None:
                raise FileNotFoundError(fname)
            yield _to_gray(img, size, cv2), ts


class StagedSource:
    """Wraps any (frame, ts) iterator and yields (device uint8 tensor, ts),
    the next frames' transfer overlapping the current frames' compute.

    A producer thread drains the source, stacks `batch` frames into pinned
    host memory and copies them to the device with a non-blocking copy on a
    side stream, recording an event; up to `depth` staged items wait in a
    bounded queue. The consumer's current stream waits on an item's event
    before the item is handed out, so nothing reads a frame before its copy
    has landed. uint8 staging moves a quarter of the bytes of float32."""

    def __init__(self, source, depth: int = 2, batch: int = 1,
                 device="cuda"):
        """depth: staged queue items (batches when batch > 1). batch:
        frames per host->device copy; match it to the consumer's chunk
        size (SlamSystem.localize_stream then takes each batch whole)."""
        self.source = source
        self.depth = max(1, int(depth))
        self.batch = max(1, int(batch))
        self.device = require_device(device)

    def _pump(self):
        """Start the producer thread; a generator over queue items:
        (frame [H, W], ts) when batch == 1, else (stack [b, H, W], ts
        list)."""
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        end = object()
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def to_u8(frame):
            arr = np.ascontiguousarray(frame)
            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            return arr

        def stage(arr):
            host = torch.from_numpy(arr)
            if not cuda:
                return host.to(self.device), None
            host = host.pin_memory()
            with torch.cuda.stream(side):
                dev = host.to(self.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(side)
            return dev, ready

        def producer():
            try:
                if self.batch == 1:
                    for frame, ts in self.source:
                        q.put((*stage(to_u8(frame)), ts))
                    return
                buf = []
                for frame, ts in self.source:
                    buf.append((to_u8(frame), ts))
                    if len(buf) == self.batch:
                        q.put((*stage(np.stack([f for f, _ in buf])),
                               [t for _, t in buf]))
                        buf = []
                if buf:
                    q.put((*stage(np.stack([f for f, _ in buf])),
                           [t for _, t in buf]))
            except Exception as e:       # re-raised by the consumer
                q.put(e)
            finally:
                q.put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        def drain():
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, Exception):
                    raise item
                data, ready, ts = item
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    # the side stream allocated it: keep the block from
                    # reuse until the consumer's work on it is done
                    data.record_stream(stream)
                yield data, ts
            t.join()

        return drain()

    def batches(self):
        """Iterate (device stack [b, H, W], ts list): each staged batch
        whole, for chunked consumers (SlamSystem.localize_stream)."""
        if self.batch == 1:
            raise ValueError("batches() needs batch > 1")
        return self._pump()

    def __iter__(self):
        for item in self._pump():
            if self.batch == 1:
                yield item
            else:
                stack, ts_list = item
                for i, ts in enumerate(ts_list):
                    yield stack[i], ts
