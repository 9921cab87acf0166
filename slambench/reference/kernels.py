"""Frozen operation and byte counts of the port's hand-written kernels K1-K3
for one frame, the data sheet's peaks, and the least time they give.

The counts depend on the work a frame asks for, not on how a kernel does
it: the frame's pyramid, its keypoint quotas and the detector's binary
image. They are copied from the kernel phase of the port's on-card smoke
run and frozen here; the pyramid sizes follow the port's rule (each level
round(size / scale^l), at least 8).

  K1 fast_score_nms   every level's pixels read once and its score written
                      once (8 bytes a pixel); FAST_OPS_PER_PX a pixel
  K2 extract_patches  every patch of the frame's keypoint quotas written
                      once (32 x 32 float32); the windows it reads are left
                      out, so the bound is a lower one
  K3 cc_fused         the binary read once, three int32 maps written; three
                      rounds of two 8-neighbour steps and four scans over
                      four fields of the padded grid
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# H100 SXM, NVIDIA's data sheet: HBM3 bytes/s and float32 operations/s
# outside the tensor cores (the integer compares counted at that rate)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
FAST_OPS_PER_PX = 16 * 12 + 4 * 17 + 11

# the device kernel of each, as the profiler names it
KERNEL_NAMES = {"fast": "fast_score_nms_kernel",
                "patches": "extract_patches_kernel",
                "cc_fused": "cc_fused_kernel"}


def pyramid_shapes(h: int, w: int, levels: int,
                   scale: float) -> List[Tuple[int, int]]:
    return [(max(8, int(round(h / scale ** l))),
             max(8, int(round(w / scale ** l)))) for l in range(levels)]


def level_quotas(n: int, levels: int, scale: float) -> List[int]:
    raw = [(1.0 / scale) ** l for l in range(levels)]
    s = sum(raw)
    q = [max(8, int(round(n * r / s))) for r in raw]
    q[0] += n - sum(q)
    return q


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the memory bandwidth and the operations over the scalar rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


def frame_bounds(slam: dict) -> Dict[str, float]:
    """{kernel: least seconds of one launch} for one frame of a
    configuration (its `slam` section: camera, orb, aruco)."""
    cam, orb = slam["camera"], slam.get("orb", {})
    H, W = int(cam["height"]), int(cam["width"])
    levels = int(orb.get("num_levels", 8))
    scale = float(orb.get("scale_factor", 1.2))
    feats = int(orb.get("num_features", 1000))
    px = sum(h * w for h, w in pyramid_shapes(H, W, levels, scale))
    patches = sum(level_quotas(feats, levels, scale))
    ds = int(slam.get("aruco", {}).get("detect_downsample", 1))
    h, w = -(-H // ds), -(-W // ds)
    hp, wp = -(-h // 8) * 8, -(-w // 128) * 128
    return {
        "fast": bound_s(8 * px, FAST_OPS_PER_PX * px),
        "patches": bound_s(4 * patches * 32 * 32, 0),
        "cc_fused": bound_s(h * w * (1 + 3 * 4),
                            hp * wp * 3 * (2 * 8 * 4 + 4 * 4)),
    }
