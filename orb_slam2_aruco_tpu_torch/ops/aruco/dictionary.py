"""ArUco dictionaries: bit-code tables + batched decode.

Port of orb_slam2_aruco_tpu/ops/aruco/dictionary.py (reference
Thirdparty/aruco/dictionary.h:53-140). The published tables ship with this
package (data/aruco_mip_25h7.npz, data/aruco_mip_36h12.npz: byte copies of
the JAX package's files). The generated dictionaries (TPU_16h5, alias
ARUCO_MIP_16h3, and TPU_36h12; the 25h7 regeneration when its data file is
missing) come from the JAX package's generators with the same random draws
in the same order, so every table is bit-identical to the JAX package's.
Only the distance test differs: JAX loops in Python over every accepted
rotation for each try; here a candidate meets them in array operations
(_generate_dictionary tests a batch of tries at once on codes packed into
64-bit words), which takes the 200 000 tries of TPU_16h5 from minutes to
under a second.
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.utils.consts import const

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


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

    @staticmethod
    def from_codes(name: str, grid: int, codes: np.ndarray,
                   max_correction: int):
        return Dictionary(name=name, grid=grid, codes=codes.astype(np.uint8),
                          max_correction=max_correction)

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


def _min_rot_distance(code: np.ndarray, grid: int, accepted) -> int:
    """Min Hamming distance between `code` (any rotation) and every accepted
    code rotation (`accepted`: a list or [A, nbits] array), and to its own
    rotations (self-distance)."""
    rots = np.stack([_rotate_code(code, grid, r) for r in range(4)])
    best = int(np.min(np.sum(rots[0] != rots[1:], axis=1)))
    acc = np.asarray(accepted)
    if len(acc):
        best = min(best, int(np.min(np.sum(
            rots[:, None, :] != acc[None, :, :], axis=2))))
    return best


def _popcount_swar(x: np.ndarray) -> np.ndarray:
    """Set bits of each uint64 (SWAR bit count)."""
    m1, m2, m4 = (np.uint64(0x5555555555555555), np.uint64(0x3333333333333333),
                  np.uint64(0x0F0F0F0F0F0F0F0F))
    x = x - ((x >> np.uint64(1)) & m1)
    x = (x & m2) + ((x >> np.uint64(2)) & m2)
    x = (x + (x >> np.uint64(4))) & m4
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(
        np.int64)


def _popcount(x: np.ndarray) -> np.ndarray:
    """Set bits of each uint64: numpy's bitwise_count where it has one
    (numpy >= 2), else the SWAR bit count."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).astype(np.int64)
    return _popcount_swar(x)


def _packed_rotations(codes: np.ndarray, grid: int) -> np.ndarray:
    """[N, nbits] bit codes -> [N, 4] uint64: each of the four rotations
    (_rotate_code) packed into one word (nbits <= 64)."""
    perms = np.stack([_rotate_code(np.arange(grid * grid), grid, r)
                      for r in range(4)])
    weights = np.uint64(1) << np.arange(grid * grid, dtype=np.uint64)
    return np.sum(codes[:, perms].astype(np.uint64) * weights, axis=-1,
                  dtype=np.uint64)


def _min_distance_to(rots: np.ndarray, acc: np.ndarray, below: int,
                     chunk: int = 64) -> np.ndarray:
    """min over r, a of popcount(rots[n, r] ^ acc[a]) for each n, or any
    value < below once it is known to be < below. Tested a chunk of `acc`
    at a time; a candidate leaves as soon as it is below."""
    out = np.full(rots.shape[0], 1 << 30, np.int64)
    live = np.arange(rots.shape[0])
    for a0 in range(0, acc.shape[0], chunk):
        d = _popcount(rots[live][:, :, None]
                      ^ acc[None, None, a0:a0 + chunk]).min(axis=(1, 2))
        out[live] = np.minimum(out[live], d)
        live = live[out[live] >= below]
        if not live.size:
            break
    return out


# tries drawn per batch: one rng.integers(0, 2, size=(B, nbits)) call gives
# the same stream as B calls of size nbits (the reference's one draw per
# try; tests/test_torch_api.py holds the two equal)
_DRAW_BATCH = 2048


def _generate_dictionary(name: str, grid: int, num_ids: int, min_dist: int,
                         seed: int) -> Dictionary:
    """Random codes accepted in draw order when their rotation distance to
    every accepted code and to themselves is >= min_dist; at most 200 000
    tries. A batch of tries is tested against the codes accepted before it
    at once; after each acceptance the rest of the batch is tested against
    the new code only."""
    rng = np.random.default_rng(seed)
    nbits = grid * grid
    accepted: list = []
    acc_rots = np.zeros(0, np.uint64)
    tries = 0
    while len(accepted) < num_ids and tries < 200000:
        n = min(_DRAW_BATCH, 200000 - tries)
        tries += n
        codes = rng.integers(0, 2, size=(n, nbits)).astype(np.uint8)
        ones = codes.sum(axis=1)
        # avoid near-uniform codes (poor border contrast statistics)
        fair = (ones >= grid) & (ones <= nbits - grid)
        codes = codes[fair]
        rots = _packed_rotations(codes, grid)
        self_d = _popcount(rots[:, :1] ^ rots[:, 1:]).min(axis=1)
        keep = np.flatnonzero(self_d >= min_dist)
        codes, rots = codes[keep], rots[keep]
        dmin = _min_distance_to(rots, acc_rots, min_dist)
        pos = 0
        while len(accepted) < num_ids:
            hits = np.flatnonzero(dmin[pos:] >= min_dist)
            if not hits.size:
                break
            j = pos + int(hits[0])
            accepted.append(codes[j])
            acc_rots = np.concatenate([acc_rots, rots[j]])
            pos = j + 1
            dmin[pos:] = np.minimum(dmin[pos:], _min_distance_to(
                rots[pos:], rots[j], min_dist))
    codes = np.stack(accepted)
    return Dictionary(name, grid, codes, max_correction=(min_dist - 1) // 2)


def _word_transitions(w: int, nbits: int) -> int:
    """Number of bit transitions in an nbits-wide row word."""
    bits = [(w >> (nbits - 1 - i)) & 1 for i in range(nbits)]
    return sum(bits[i] != bits[i + 1] for i in range(nbits - 1))


def _generate_mip_style(name: str, grid: int, num_ids: int, tau: int,
                        seed: int) -> Dictionary:
    """Row-word proposals weighted by bit transitions and non-occurrence in
    the accepted set, accepted at rotation distance >= tau (Garrido-Jurado
    et al. 2014; the JAX module states the criteria)."""
    rng = np.random.default_rng(seed)
    nwords = 1 << grid
    trans = np.asarray(
        [_word_transitions(w, grid) for w in range(nwords)], np.float64
    ) / max(grid - 1, 1)
    occur = np.zeros(nwords, np.float64)
    word_bits = np.asarray(
        [[(w >> (grid - 1 - i)) & 1 for i in range(grid)]
         for w in range(nwords)],
        np.uint8,
    )
    accepted: list = []
    accepted_all_rots: list = []
    tries = 0
    while len(accepted) < num_ids:
        tries += 1
        if tries > 500000:
            raise RuntimeError(f"{name}: dictionary generation stalled")
        p = 0.5 * trans + 0.5 * (1.0 - occur / max(occur.max(), 1.0))
        p = p / p.sum()
        rows = rng.choice(nwords, size=grid, p=p)
        code = word_bits[rows].reshape(-1)
        if _min_rot_distance(code, grid, accepted_all_rots) >= tau:
            accepted.append(code)
            accepted_all_rots.extend(
                _rotate_code(code, grid, r) for r in range(4))
            for w in rows:
                occur[w] += 1.0
    codes = np.stack(accepted)
    return Dictionary(name, grid, codes, max_correction=(tau - 1) // 2)


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
        elif name in ("TPU_16h5", "ARUCO_MIP_16h3"):
            _REGISTRY[name] = _generate_dictionary("TPU_16h5", 4, 64, 5,
                                                   seed=11)
        elif name in ("TPU_25h7", "ARUCO_MIP_25h7"):
            # the published table; the regeneration only without its file
            if os.path.exists(os.path.join(_DATA_DIR, "aruco_mip_25h7.npz")):
                _REGISTRY[name] = _load_packed("ARUCO_MIP_25h7",
                                               "aruco_mip_25h7.npz")
            else:
                _REGISTRY[name] = _generate_mip_style(
                    "ARUCO_MIP_25h7", 5, 100, 7, seed=25)
        elif name == "TPU_36h12":
            _REGISTRY[name] = _generate_dictionary("TPU_36h12", 6, 250, 12,
                                                   seed=13)
        else:
            raise ValueError(f"unknown ArUco dictionary: {name}")
    return _REGISTRY[name]
