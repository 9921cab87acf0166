"""The world map as one fixed-capacity tuple of tensors.

Port of orb_slam2_aruco_tpu/worldmap/state.py (reference src/Map.cc,
MapPoint.cc, KeyFrame.cc, MapAruco.cc as arrays + validity masks). The
field list and shapes are the JAX package's; `state_from_numpy` carries a
map the JAX package built (its arrays as numpy) onto a device.

Shapes: K = max_keyframes, N = features/frame, L = max_points,
M = max_markers, A = markers per keyframe, E = loop edges, W = BoW words.
Packed descriptors are int32 with the uint32 bits; integer indices are
int64 (torch's index type).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MapState(NamedTuple):
    kf_Rcw: torch.Tensor        # [K, 3, 3] world->camera
    kf_tcw: torch.Tensor        # [K, 3]
    kf_valid: torch.Tensor      # [K] bool
    kf_frame_id: torch.Tensor   # [K]
    kf_ts: torch.Tensor         # [K] float32
    kf_seq: torch.Tensor        # [K] insertion sequence (-1 = empty)
    kf_kp_uv: torch.Tensor      # [K, N, 2]
    kf_kp_octave: torch.Tensor  # [K, N]
    kf_kp_angle: torch.Tensor   # [K, N]
    kf_desc: torch.Tensor       # [K, N, 8] int32 (uint32 bits)
    kf_kp_valid: torch.Tensor   # [K, N] bool
    kf_obs_point: torch.Tensor  # [K, N] map-point slot per feature (-1)
    pt_xyz: torch.Tensor        # [L, 3]
    pt_valid: torch.Tensor      # [L] bool
    pt_desc: torch.Tensor       # [L, 8] int32 (uint32 bits)
    pt_normal: torch.Tensor     # [L, 3]
    pt_min_dist: torch.Tensor   # [L]
    pt_max_dist: torch.Tensor   # [L]
    pt_ref_kf: torch.Tensor     # [L]
    pt_found: torch.Tensor      # [L] float32
    pt_visible: torch.Tensor    # [L] float32
    pt_first_kf: torch.Tensor   # [L]
    pt_aruco: torch.Tensor      # [L]
    pt_obs_kf: torch.Tensor     # [L, K] bool point<->keyframe incidence
    mk_Rwm: torch.Tensor        # [M, 3, 3] marker->world
    mk_twm: torch.Tensor        # [M, 3]
    mk_id: torch.Tensor         # [M] ArUco id (-1 = free slot)
    mk_valid: torch.Tensor      # [M] bool
    mk_side: torch.Tensor       # [M] float32
    mk_well: torch.Tensor       # [M] bool
    mk_nbad: torch.Tensor       # [M]
    mk_mean_len: torch.Tensor   # [M] float32
    mk_len_cnt: torch.Tensor    # [M] float32
    kf_mk_slot: torch.Tensor    # [K, A] marker slot (-1)
    kf_mk_uv: torch.Tensor      # [K, A, 4, 2]
    kf_mk_valid: torch.Tensor   # [K, A] bool
    kf_mk_old: torch.Tensor     # [K, A] bool
    loop_i: torch.Tensor        # [E]
    loop_j: torch.Tensor        # [E]
    loop_valid: torch.Tensor    # [E] bool
    kf_bow: torch.Tensor        # [K, W] float32
    scale_done: torch.Tensor    # [] bool
    big_change_idx: torch.Tensor  # []
    next_seq: torch.Tensor      # []

    @property
    def K(self):
        return self.kf_valid.shape[0]

    @property
    def L(self):
        return self.pt_valid.shape[0]


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy -> tensor on `device`: uint32 keeps its bits as int32, other
    integer types become int64 (index type), bool and float stay."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.as_tensor(a.view(np.int32)).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64)).to(device)
    return torch.as_tensor(a).to(device)


def state_from_numpy(arrays: dict, device="cpu") -> MapState:
    """The JAX package's MapState arrays (as numpy, keyed by field name) ->
    the port's MapState on `device`."""
    missing = [f for f in MapState._fields if f not in arrays]
    if missing:
        raise KeyError(f"map arrays lack fields {missing}")
    return MapState(**{f: to_torch(arrays[f], device)
                       for f in MapState._fields})
