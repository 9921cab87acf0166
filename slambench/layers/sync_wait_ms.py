"""sync_wait_ms: host milliseconds a window frame spent blocked in the
program's deliberate host reads of device values (`tracking.SYNCS`
"wait_ns", timed in `host_sync`, `host_read` and `HostCopy.read`), summed
over the window and divided by its frames. Small while the host is the
pace; it grows as the device becomes the pace."""

try:
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
except ImportError:
    tracking = None

# a program that does not time its reads has nothing to read, and the
# metric is left out
COUNTERS = ({"syncs.wait_ns": (tracking.__name__, "SYNCS", "wait_ns")}
            if "wait_ns" in getattr(tracking, "SYNCS", {}) else {})


def read(t):
    ns = t.counters.get("syncs.wait_ns")
    return ns / 1e6 / t.frames if ns is not None and t.frames else None
