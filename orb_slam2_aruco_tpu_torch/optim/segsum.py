"""Segment sums.

Port of orb_slam2_aruco_tpu/optim/segsum.py. The JAX package sorts the
segment ids and takes differences of a float32 cumsum, because XLA lowers
a scatter-add on the TPU to a serialized loop; the card adds with
`index_add_`. Same result up to float32 summation order.

Precision note: JAX's per-segment sums are differences of a running f32
cumsum, so their error grows with the global sum's magnitude rather than
the segment's; `index_add_` sums each segment on its own and lands closer
to the exact sum (ROADMAP.md C2, optim/ba.py).
"""

from __future__ import annotations

import math

import torch


def segment_sum_sorted(vals, seg_ids, num_segments: int):
    """jax.ops.segment_sum(vals, seg_ids, num_segments), accumulated in
    float32 and returned in vals' dtype; seg_ids outside [0, num_segments)
    contribute nothing. vals: [E, ...]; seg_ids: [E] integer. Returns
    [num_segments, ...]."""
    E = seg_ids.shape[0]
    tail = vals.shape[1:]
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    ids = torch.where(ok, seg_ids, num_segments).long()
    out = torch.zeros((num_segments + 1, math.prod(tail)),
                      dtype=torch.float32, device=vals.device)
    out.index_add_(0, ids, vals.reshape(E, -1).float())
    return out[:num_segments].reshape((num_segments,) + tail).to(vals.dtype)
