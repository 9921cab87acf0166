"""Map checkpoint loading (numpy npz, format versions 1-4).

Port of orb_slam2_aruco_tpu/io/checkpoint.py `load_map`/`load_extras`
(reference Map::Load, src/Map.cc:219-531), including the migrations of
older formats (checkpoint.py:56-96 of the JAX package):

  1  no kf_seq / next_seq; pt_first_kf holds keyframe SLOT indices; may
     predate pt_obs_kf
  2  adds kf_seq / next_seq and the optional float64 `kf_ts64`
  3  adds pt_aruco
  4  adds the loop-edge table loop_i / loop_j / loop_valid

The arrays are migrated in numpy, then carried onto the device by
`worldmap.state.state_from_numpy`. Saving maps stays with the JAX package
for now (slice 4 of ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from orb_slam2_aruco_tpu_torch import require_device
from orb_slam2_aruco_tpu_torch.config import MapConfig
from orb_slam2_aruco_tpu_torch.worldmap.state import MapState, state_from_numpy

_EXTRA_KEYS = ("kf_ts64",)


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
