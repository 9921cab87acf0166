"""Map checkpoints (numpy npz, format versions 1-4).

Port of orb_slam2_aruco_tpu/io/checkpoint.py (reference Map::Save / Load,
src/Map.cc:219-531): `save_map` writes format 4 with the JAX package's
keys and dtypes (int32 indices, uint32 descriptor bits, the float64
`kf_ts64` extra), so either package loads the other's maps; `load_map`
reads every format, with the migrations of older ones (checkpoint.py:56-96
of the JAX package):

  1  no kf_seq / next_seq; pt_first_kf holds keyframe SLOT indices; may
     predate pt_obs_kf
  2  adds kf_seq / next_seq and the optional float64 `kf_ts64`
  3  adds pt_aruco
  4  adds the loop-edge table loop_i / loop_j / loop_valid

The arrays are migrated in numpy, then carried onto the device by
`worldmap.state.state_from_numpy`; a saved map comes off the device through
`worldmap.state.state_to_numpy`.
"""

from __future__ import annotations

import numpy as np

from orb_slam2_aruco_tpu_torch import require_device
from orb_slam2_aruco_tpu_torch.config import MapConfig
from orb_slam2_aruco_tpu_torch.worldmap.state import (
    MapState,
    state_from_numpy,
    state_to_numpy,
)

_FORMAT_VERSION = 4
_EXTRA_KEYS = ("kf_ts64",)


def save_map(path: str, state: MapState, kf_ts64=None) -> None:
    """Write `state` (and the float64 keyframe timestamps) as a format-4
    checkpoint."""
    arrays = state_to_numpy(state)
    if kf_ts64 is not None:
        arrays["kf_ts64"] = np.asarray(kf_ts64, np.float64)
    np.savez_compressed(path, __version__=_FORMAT_VERSION, **arrays)


def load_extras(path: str) -> dict:
    """Non-MapState side arrays stored in the checkpoint."""
    with np.load(path) as data:
        return {k: data[k] for k in _EXTRA_KEYS if k in data}


def load_map_arrays(path: str) -> dict:
    """The checkpoint's MapState fields as numpy, migrated to format 4."""
    with np.load(path) as data:
        version = int(data["__version__"])
        if version not in (1, 2, 3, 4):
            raise ValueError(f"unsupported map checkpoint version {version}")
        arrays = {f: data[f] for f in MapState._fields if f in data}
    if "loop_valid" not in arrays:
        E = MapConfig().max_loop_edges
        arrays["loop_i"] = np.full((E,), -1, np.int32)
        arrays["loop_j"] = np.full((E,), -1, np.int32)
        arrays["loop_valid"] = np.zeros((E,), bool)
    if "pt_aruco" not in arrays:
        arrays["pt_aruco"] = np.full((arrays["pt_valid"].shape[0],), -1,
                                     np.int32)
    if "pt_obs_kf" not in arrays:
        obs = arrays["kf_obs_point"]
        valid = arrays["kf_kp_valid"]
        inc = np.zeros((arrays["pt_valid"].shape[0], obs.shape[0]), bool)
        for k in range(obs.shape[0]):
            inc[obs[k][valid[k] & (obs[k] >= 0)], k] = True
        arrays["pt_obs_kf"] = inc
    if "kf_seq" not in arrays:
        fid = arrays["kf_frame_id"]
        kf_valid = arrays["kf_valid"]
        K = kf_valid.shape[0]
        seq = np.full(K, -1, np.int32)
        order = np.argsort(fid[kf_valid], kind="stable")
        seq[np.flatnonzero(kf_valid)[order]] = np.arange(
            int(kf_valid.sum()), dtype=np.int32)
        arrays["kf_seq"] = seq
        arrays["next_seq"] = np.asarray(int(kf_valid.sum()), np.int32)
        first = arrays["pt_first_kf"]
        arrays["pt_first_kf"] = np.where(
            first >= 0, seq[np.clip(first, 0, K - 1)], -1).astype(np.int32)
    return arrays


def load_map(path: str, device="cuda") -> MapState:
    """The checkpoint's map on `device` (the card unless told otherwise)."""
    return state_from_numpy(load_map_arrays(path), require_device(device))
