"""FAST-9/16 corner detection with spatial balancing, plus kernel K1.

Port of orb_slam2_aruco_tpu/ops/fast.py (reference ORBextractor::
ComputeKeyPointsOctTree, src/ORBextractor.cc:765-853). The score + NMS +
bonus stage is `fast_score_nms`, which replaces the TPU kernel
ops/pallas_fast.py::fast_score_nms:

  * `fast_score_nms_levels_cuda` launches the hand-written kernel
    (kernels/csrc/fast.cu) once for every pyramid level of a frame on CUDA
    tensors; `fast_score_nms_cuda` is the same launch on one level;
  * `fast_score_nms_torch` is the plain PyTorch version of the same
    arithmetic (terms summed in _CIRCLE order), used for CPU tensors.

`fast_score_nms_levels` and `fast_score_nms` pick between them only by the
tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.ops.topk import stable_topk

# Bresenham circle of radius 3 (row, col offsets), standard FAST-16 order
_CIRCLE = np.asarray(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

BONUS = 1e6


class Keypoints(NamedTuple):
    xy: torch.Tensor      # [N, 2] float32 (x, y) in level coords
    score: torch.Tensor   # [N]
    valid: torch.Tensor   # [N] bool


def _arc9(bits):
    """Contiguous arc of >= 9 set bits on the 16-bit ring (int64 bits)."""
    b = bits | (bits << 16)
    acc = b
    for s in range(1, 9):
        acc = acc & (b >> s)
    return (acc & 0xFFFF) != 0


def fast_score_nms_torch(img, t_hi: float, t_lo: float):
    """FAST score map for one level: sum over the 16 circle pixels of
    max(|d| - t_lo, 0) for the passing polarity, 3-px border zeroed, strict
    3x3 NMS, +1e6 where the t_hi arc passes. img [H, W] float32; pixels
    outside the image read as 0."""
    H, W = img.shape
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    zero_i = torch.zeros((H, W), dtype=torch.int64, device=img.device)
    lb, ld, hb, hd = zero_i, zero_i, zero_i, zero_i
    sb = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    sd = torch.zeros_like(sb)
    for i, (dy, dx) in enumerate(_CIRCLE):
        d = p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - img
        nd = -d
        one = 1 << i
        lb = lb | torch.where(d > t_lo, one, 0)
        ld = ld | torch.where(nd > t_lo, one, 0)
        hb = hb | torch.where(d > t_hi, one, 0)
        hd = hd | torch.where(nd > t_hi, one, 0)
        sb = sb + torch.clamp(d - t_lo, min=0.0)
        sd = sd + torch.clamp(nd - t_lo, min=0.0)
    b_lo, d_lo = _arc9(lb), _arc9(ld)
    hi = _arc9(hb) | _arc9(hd)
    score = torch.where(b_lo, sb, 0.0) + torch.where(d_lo, sd, 0.0)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    border = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    score = torch.where((b_lo | d_lo) & border, score, 0.0)
    m = torch.nn.functional.max_pool2d(score[None, None], 3, stride=1,
                                       padding=1)[0, 0]
    score = torch.where(score >= m, score, 0.0)
    return torch.where((score > 0.0) & hi, score + BONUS, score)


# levels one K1 launch takes (kMaxLevels in kernels/csrc/fast.cu)
_MAX_LEVELS = 8


def fast_score_nms_levels_cuda(levels, t_hi: float, t_lo: float):
    """Launch kernel K1 (kernels/csrc/fast.cu) once over 1 to 8 CUDA float32
    [H_l, W_l] levels. Returns one [H_l, W_l] view per level of a single
    output buffer."""
    if not 1 <= len(levels) <= _MAX_LEVELS:
        raise ValueError(f"K1 takes 1 to {_MAX_LEVELS} levels per launch")
    device = levels[0].device
    if not all(img.is_cuda and img.dtype == torch.float32 and img.dim() == 2
               and img.device == device for img in levels):
        raise ValueError("K1 takes CUDA float32 [H, W] levels on one device")
    levels = [img.contiguous() for img in levels]
    shapes = [img.shape for img in levels]
    buf = torch.empty((sum(h * w for h, w in shapes),), dtype=torch.float32,
                      device=device)
    outs = [o.view(h, w) for o, (h, w) in zip(
        buf.split([h * w for h, w in shapes]), shapes)]
    table = np.array([(img.data_ptr(), o.data_ptr(), h, w)
                      for img, o, (h, w) in zip(levels, outs, shapes)],
                     dtype=np.int64)
    err = kernels.build.launcher("fast")(
        table.ctypes.data, len(levels), float(t_hi), float(t_lo),
        torch.cuda.current_stream(device).cuda_stream)
    kernels.check_launch("fast", err)
    return outs


def fast_score_nms_cuda(img, t_hi: float, t_lo: float):
    """Kernel K1 on one CUDA float32 [H, W] level: the one-level launch."""
    return fast_score_nms_levels_cuda([img], t_hi, t_lo)[0]


def fast_score_nms_levels(levels, t_hi: float, t_lo: float):
    """K1 on every level: one launch on CUDA tensors, the plain version per
    level on CPU tensors."""
    if levels[0].is_cuda:
        return fast_score_nms_levels_cuda(levels, t_hi, t_lo)
    return [fast_score_nms_torch(img, t_hi, t_lo) for img in levels]


def fast_score_nms(img, t_hi: float, t_lo: float):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if img.is_cuda:
        return fast_score_nms_cuda(img, t_hi, t_lo)
    return fast_score_nms_torch(img, t_hi, t_lo)


def detect_level(img, threshold_high: float, threshold_low: float,
                 cell_size: int, per_cell_k: int, max_kps: int,
                 edge_margin: int = 16, score=None) -> Keypoints:
    """FAST corners on one pyramid level with spatial balancing: score at
    the low threshold (+bonus above the high one), per-cell top-k, then
    global top-max_kps. `score`, where given, is the level's
    fast_score_nms map at these thresholds, computed beforehand (as
    make_frame does for all levels in one K1 launch)."""
    h, w = img.shape
    dev = img.device
    s = (fast_score_nms(img, threshold_high, threshold_low) if score is None
         else score)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    inside = ((yy >= edge_margin) & (yy < h - edge_margin)
              & (xx >= edge_margin) & (xx < w - edge_margin))
    s = torch.where(inside, s, 0.0)
    ch = -(-h // cell_size) * cell_size
    cw = -(-w // cell_size) * cell_size
    sp = torch.nn.functional.pad(s, (0, cw - w, 0, ch - h))
    ncy, ncx = ch // cell_size, cw // cell_size
    cells = sp.reshape(ncy, cell_size, ncx, cell_size).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell_size * cell_size)
    topv, topi = stable_topk(cells, per_cell_k, dim=1)
    cell = torch.arange(ncy * ncx, device=dev)[:, None]
    gy = (cell // ncx) * cell_size + topi // cell_size
    gx = (cell % ncx) * cell_size + topi % cell_size
    flat_v = topv.reshape(-1)
    k = min(max_kps, flat_v.shape[0])
    vals, idx = stable_topk(flat_v, k)
    sel_y = gy.reshape(-1)[idx]
    sel_x = gx.reshape(-1)[idx]
    valid = vals > 0
    xy = torch.stack([sel_x.float(), sel_y.float()], dim=-1)
    if k < max_kps:
        pad = max_kps - k
        xy = torch.cat([xy, xy.new_zeros((pad, 2))])
        vals = torch.cat([vals, vals.new_zeros((pad,))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    score = torch.where(vals > BONUS / 2, vals - BONUS, vals)
    return Keypoints(xy=xy, score=score, valid=valid)
