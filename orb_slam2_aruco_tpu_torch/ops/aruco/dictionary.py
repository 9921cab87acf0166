"""ArUco dictionaries: bit-code tables + batched decode.

Port of orb_slam2_aruco_tpu/ops/aruco/dictionary.py (reference
Thirdparty/aruco/dictionary.h:53-140). The published tables are read from
the JAX package's data files (orb_slam2_aruco_tpu/ops/aruco/data/*.npz) by
path, so every table is bit-identical to the JAX package's. The generated
test dictionaries (TPU_16h5, TPU_36h12) are not ported.
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.utils.consts import const

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "orb_slam2_aruco_tpu", "ops", "aruco", "data",
)


@dataclasses.dataclass(frozen=True)
class Dictionary:
    name: str
    grid: int
    codes: np.ndarray         # [K, grid*grid] uint8
    max_correction: int

    @property
    def nbits(self) -> int:
        return self.grid * self.grid

    @property
    def num_ids(self) -> int:
        return self.codes.shape[0]

    def bit_matrix(self, marker_id: int) -> np.ndarray:
        return self.codes[marker_id].reshape(self.grid, self.grid)


def _rotate_code(code: np.ndarray, grid: int, k: int) -> np.ndarray:
    return np.rot90(code.reshape(grid, grid), -k).reshape(-1)


@lru_cache(maxsize=8)
def rotated_code_table(name: str):
    """All codes x 4 rotations as {-1,+1} float32 [K*4, nbits] plus the
    (id, rot) lookup arrays."""
    d = get_dictionary(name)
    rows, ids, rots = [], [], []
    for i in range(d.num_ids):
        for r in range(4):
            rows.append(_rotate_code(d.codes[i], d.grid, r))
            ids.append(i)
            rots.append(r)
    table = np.asarray(rows, dtype=np.float32) * 2.0 - 1.0
    return table, np.asarray(ids, np.int32), np.asarray(rots, np.int32)


def decode_bits(bits, name: str):
    """bits [Q, nbits] float in [0,1] -> (ids [Q], rots [Q], dist [Q])."""
    table, ids, rots = const(("code_table", name), bits.device,
                             lambda: rotated_code_table(name))
    agree = (bits.float() * 2.0 - 1.0) @ table.T
    dist = (table.shape[1] - agree) * 0.5
    best = torch.argmin(dist, dim=-1)
    return (ids[best].long(), rots[best].long(),
            torch.gather(dist, 1, best[:, None])[:, 0])


def _aruco_classic() -> Dictionary:
    words = np.asarray([[1, 0, 0, 0, 0], [1, 0, 1, 1, 1],
                        [0, 1, 0, 0, 1], [0, 1, 1, 1, 0]], dtype=np.uint8)
    codes = np.zeros((1024, 25), dtype=np.uint8)
    for marker_id in range(1024):
        for row in range(5):
            two = (marker_id >> (2 * (4 - row))) & 0b11
            codes[marker_id, row * 5:row * 5 + 5] = words[two]
    return Dictionary("ARUCO", 5, codes, max_correction=0)


def _load_packed(name: str, fname: str) -> Dictionary:
    z = np.load(os.path.join(_DATA_DIR, fname))
    grid = int(z["grid"])
    n = int(z["num_ids"])
    codes = np.unpackbits(z["packed"], axis=1)[:, :grid * grid]
    return Dictionary(name, grid, codes[:n].astype(np.uint8),
                      max_correction=int(z["max_correction"]))


_REGISTRY: Dict[str, Dictionary] = {}


def get_dictionary(name: str) -> Dictionary:
    if name not in _REGISTRY:
        if name == "ARUCO":
            _REGISTRY[name] = _aruco_classic()
        elif name == "ARUCO_MIP_36h12":
            _REGISTRY[name] = _load_packed(name, "aruco_mip_36h12.npz")
        elif name in ("TPU_25h7", "ARUCO_MIP_25h7"):
            _REGISTRY[name] = _load_packed("ARUCO_MIP_25h7",
                                           "aruco_mip_25h7.npz")
        else:
            raise ValueError(f"ArUco dictionary {name!r} is not ported (the "
                             "port has ARUCO, ARUCO_MIP_25h7 and "
                             "ARUCO_MIP_36h12)")
    return _REGISTRY[name]
