"""Batched descriptor matching.

Port of orb_slam2_aruco_tpu/ops/matching.py (reference ORBmatcher
search-by-projection entry points, src/ORBmatcher.h:48-83). Hamming
distance is the +-1 inner product, (256 - <a, b>) / 2, as one float32
matmul: every sum is an integer of at most 256, exact in float32. Window,
scale and octave gates are masks on the distance matrix; the rotation
histogram is a fixed-shape bincount.

Ties follow jax.lax.top_k / argmin (lower index first): the best column is
`argmin` (first minimum) and the second-best distance is the minimum over
the other columns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.ops.orb import unpack_pm1
from orb_slam2_aruco_tpu_torch.ops.topk import stable_topk

INF = 1e9


class Matches(NamedTuple):
    idx: torch.Tensor      # [N] index into B (-1 if unmatched)
    dist: torch.Tensor     # [N] float32 Hamming distance of the match
    valid: torch.Tensor    # [N] bool


def distance_matrix(packed_a, packed_b, mask_a=None, mask_b=None):
    """Hamming distances [N, M]; masked rows / columns are INF."""
    d = (256.0 - unpack_pm1(packed_a) @ unpack_pm1(packed_b).T) * 0.5
    if mask_a is not None:
        d = torch.where(mask_a[:, None], d, INF)
    if mask_b is not None:
        d = torch.where(mask_b[None, :], d, INF)
    return d


def nn_match(dist, max_dist: float, nn_ratio: float = 1.0,
             mutual: bool = False) -> Matches:
    """Row-wise nearest neighbour with the Lowe ratio, optional mutual check
    and one row per column (the closest)."""
    N, M = dist.shape
    idx = torch.argmin(dist, dim=1)          # first minimum, as top_k
    best = torch.gather(dist, 1, idx[:, None])[:, 0]
    others = dist.scatter(1, idx[:, None], float("inf"))
    second = torch.min(others, dim=1).values
    ok = (best <= max_dist) & (best <= nn_ratio * second)
    if mutual:
        back = torch.argmin(dist, dim=0)
        ok = ok & (back[idx] == torch.arange(N, device=dist.device))
    col_best = torch.full((M,), INF, dtype=dist.dtype, device=dist.device)
    col_best = col_best.scatter_reduce(0, idx, torch.where(ok, best, INF),
                                       "amin", include_self=True)
    ok = ok & (best <= col_best[idx])
    return Matches(idx=torch.where(ok, idx, -1), dist=best, valid=ok)


def window_mask(pos_a, pos_b, radius, octave_a=None, octave_b=None,
                max_octave_diff: int = 1):
    """[N, M] bool: b within `radius` (scalar or per-row [N]) of a's
    predicted position, in the reference's expanded |a|^2 + |b|^2 - 2<a,b>
    form."""
    na = torch.sum(pos_a * pos_a, dim=-1)
    nb = torch.sum(pos_b * pos_b, dim=-1)
    d2 = na[:, None] + nb[None, :] - 2.0 * (pos_a @ pos_b.T)
    if isinstance(radius, torch.Tensor) and radius.dim() > 0:
        m = d2 <= (radius * radius)[:, None]
    else:
        m = d2 <= radius * radius
    if octave_a is not None and octave_b is not None:
        m = m & (torch.abs(octave_a[:, None] - octave_b[None, :])
                 <= max_octave_diff)
    return m


def rotation_consistency(angles_a, angles_b, matches: Matches,
                         histo_length: int = 30, keep_bins: int = 3):
    """Keep matches whose rotation offset falls in the most popular bins
    (reference ComputeThreeMaxima)."""
    idx_safe = torch.clamp(matches.idx, min=0)
    rot = torch.remainder(angles_a - angles_b[idx_safe], 2.0 * np.pi)
    bins = torch.floor(rot * histo_length / (2.0 * np.pi)).to(torch.int64)
    bins = torch.clamp(bins, 0, histo_length - 1)
    hist = torch.zeros(histo_length, dtype=torch.float32,
                       device=angles_a.device)
    hist.index_add_(0, bins, matches.valid.to(torch.float32))
    top_vals, top_bins = stable_topk(hist, keep_bins)
    bin_ok = top_vals >= 0.1 * top_vals[0]
    in_top = ((bins[:, None] == top_bins[None, :]) & bin_ok[None, :]).any(-1)
    ok = matches.valid & in_top
    return Matches(idx=torch.where(ok, matches.idx, -1), dist=matches.dist,
                   valid=ok)


def match_in_window(packed_a, packed_b, pos_pred_a, pos_b, radius,
                    mask_a=None, mask_b=None, octave_a=None, octave_b=None,
                    max_octave_diff: int = 1, max_dist: float = 100.0,
                    nn_ratio: float = 1.0, mutual: bool = False,
                    angles_a=None, angles_b=None,
                    check_rotation: bool = False,
                    histo_length: int = 30) -> Matches:
    """Projection-window constrained NN matching (SearchByProjection)."""
    d = distance_matrix(packed_a, packed_b, mask_a, mask_b)
    wm = window_mask(pos_pred_a, pos_b, radius, octave_a, octave_b,
                     max_octave_diff)
    d = torch.where(wm, d, INF)
    m = nn_match(d, max_dist=max_dist, nn_ratio=nn_ratio, mutual=mutual)
    if check_rotation and angles_a is not None:
        m = rotation_consistency(angles_a, angles_b, m, histo_length)
    return m
