"""The world map as one fixed-capacity tuple of tensors.

Port of orb_slam2_aruco_tpu/worldmap/state.py (reference src/Map.cc,
MapPoint.cc, KeyFrame.cc, MapAruco.cc as arrays + validity masks). The
field list and shapes are the JAX package's; `state_from_numpy` carries a
map the JAX package built (its arrays as numpy) onto a device, and
`state_to_numpy` gives a map back in the JAX package's dtypes. `empty_map`
is the SLAM-mode starting map.

Shapes: K = max_keyframes, N = features/frame, L = max_points,
M = max_markers, A = markers per keyframe, E = loop edges, W = BoW words.
Packed descriptors are int32 with the uint32 bits; integer indices are
int64 (torch's index type).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.config import SlamConfig


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

    @property
    def M(self):
        return self.mk_valid.shape[0]

    def num_keyframes(self):
        return self.kf_valid.sum()

    def num_points(self):
        return self.pt_valid.sum()

    def num_markers(self):
        return self.mk_valid.sum()


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


# the JAX package's dtypes of the fields that are not float32 or bool
_UINT32_FIELDS = ("kf_desc", "pt_desc")


def state_to_numpy(state: MapState) -> dict:
    """The port's MapState -> numpy arrays keyed by field name, in the JAX
    package's dtypes (int32 indices, uint32 descriptor bits): the inverse
    of `state_from_numpy`."""
    out = {}
    for f in MapState._fields:
        a = getattr(state, f).detach().cpu().numpy()
        if f in _UINT32_FIELDS:
            a = a.astype(np.int32).view(np.uint32)
        elif np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int32)
        out[f] = a
    return out


def empty_map(cfg: SlamConfig, device="cpu", num_words: int = None
              ) -> MapState:
    """An empty map at the configured capacities on `device`."""
    K = cfg.map.max_keyframes
    N = cfg.orb.num_features
    L = cfg.map.max_points
    M = cfg.map.max_markers
    A = cfg.aruco.max_markers_per_frame
    E = cfg.map.max_loop_edges
    W = num_words if num_words is not None else cfg.retrieval.num_words
    f32, i64 = torch.float32, torch.int64

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    def eye(n):
        return torch.eye(3, dtype=f32, device=device).repeat(n, 1, 1)

    return MapState(
        kf_Rcw=eye(K), kf_tcw=full((K, 3), 0.0, f32),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i64), kf_ts=full((K,), 0.0, f32),
        kf_seq=full((K,), -1, i64), kf_kp_uv=full((K, N, 2), 0.0, f32),
        kf_kp_octave=full((K, N), 0, i64),
        kf_kp_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, torch.int32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_obs_point=full((K, N), -1, i64),
        pt_xyz=full((L, 3), 0.0, f32), pt_valid=full((L,), False, torch.bool),
        pt_desc=full((L, 8), 0, torch.int32),
        pt_normal=full((L, 3), 0.0, f32), pt_min_dist=full((L,), 0.0, f32),
        pt_max_dist=full((L,), 1e9, f32), pt_ref_kf=full((L,), -1, i64),
        pt_found=full((L,), 1.0, f32), pt_visible=full((L,), 1.0, f32),
        pt_first_kf=full((L,), -1, i64), pt_aruco=full((L,), -1, i64),
        pt_obs_kf=full((L, K), False, torch.bool),
        mk_Rwm=eye(M), mk_twm=full((M, 3), 0.0, f32),
        mk_id=full((M,), -1, i64), mk_valid=full((M,), False, torch.bool),
        mk_side=full((M,), cfg.aruco.marker_size, f32),
        mk_well=full((M,), False, torch.bool), mk_nbad=full((M,), 0, i64),
        mk_mean_len=full((M,), 0.0, f32), mk_len_cnt=full((M,), 0.0, f32),
        kf_mk_slot=full((K, A), -1, i64),
        kf_mk_uv=full((K, A, 4, 2), 0.0, f32),
        kf_mk_valid=full((K, A), False, torch.bool),
        kf_mk_old=full((K, A), False, torch.bool),
        loop_i=full((E,), -1, i64), loop_j=full((E,), -1, i64),
        loop_valid=full((E,), False, torch.bool),
        kf_bow=full((K, W), 0.0, f32),
        scale_done=full((), False, torch.bool),
        big_change_idx=full((), 0, i64), next_seq=full((), 0, i64),
    )


def first_free_slot(valid):
    """Index of the first invalid slot (a full pool gives 0, as argmax of
    all-False)."""
    return torch.argmax((~valid).to(torch.int32))


def free_slots(valid, count: int):
    """First `count` free slot indices (then the valid slots in order, as a
    stable argsort of the validity flags)."""
    order = torch.sort(valid.to(torch.int32), stable=True).indices
    return order[:count]


def marker_slot_for_id(state: MapState, aruco_id):
    """Slot holding a given ArUco id, or -1."""
    hit = (state.mk_id == aruco_id) & state.mk_valid
    slot = torch.argmax(hit.to(torch.int32))
    return torch.where(hit.any(), slot, -1)
