"""Frame ingestion: double-buffered host->device staging.

Port of orb_slam2_aruco_tpu/io/ingest.py `StagedSource` (the production
ingest path the reference's frame loop, mono_cvcam.cc:141-148, corresponds
to). `VideoSource` and `ImageFolderSource` decode with cv2 and are not
ported yet.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch import require_device


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
