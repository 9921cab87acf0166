"""Covisibility graph as one matrix product.

Port of orb_slam2_aruco_tpu/worldmap/covisibility.py (reference
KeyFrame::UpdateConnections and its ordered neighbour lists,
src/KeyFrame.cc:386-476): the weight between two keyframes is the number
of map points both observe, W = B B^T over the [K, L] incidence matrix B.
The product runs in float32: its entries are counts of 0/1 products below
2**24, exact in any summation order (the JAX package feeds bf16 0/1
operands with a float32 accumulator, the same counts).
"""

from __future__ import annotations

import torch

from orb_slam2_aruco_tpu_torch.ops.topk import stable_topk
from orb_slam2_aruco_tpu_torch.worldmap.state import MapState


def incidence_matrix(state: MapState, dtype=torch.float32):
    """[K, L] 1 where keyframe k observes valid point l: the masked
    transpose of the maintained [L, K] table state.pt_obs_kf."""
    inc = state.pt_obs_kf & state.pt_valid[:, None] & state.kf_valid[None, :]
    return inc.T.to(dtype)


def covisibility_matrix(state: MapState):
    """[K, K] int64 shared-point counts (diagonal = own point count)."""
    B = incidence_matrix(state)
    return (B @ B.T).to(torch.int64)


def covisible_neighbors(W, kf, min_weight: int, max_n: int):
    """Top-max_n covisible keyframes of `kf` with weight >= min_weight, ties
    to the lower slot: (slots [max_n], weights [max_n], valid [max_n])."""
    row = W[kf].clone()
    row[kf] = 0
    vals, idx = stable_topk(row, max_n)
    return idx, vals, vals >= min_weight


def spanning_parent(W, kf_valid, kf_order):
    """Parent of each keyframe: its best covisible among the earlier ones
    (the reference's spanning tree, KeyFrame.cc:441-475), by the insertion
    order kf_order [K]. [K] parent slot, -1 for roots."""
    earlier = (kf_order[None, :] < kf_order[:, None]) & kf_valid[None, :]
    Wm = torch.where(earlier, W, -1)
    best, parent = torch.max(Wm, dim=1)
    return torch.where((best > 0) & kf_valid, parent, -1)
