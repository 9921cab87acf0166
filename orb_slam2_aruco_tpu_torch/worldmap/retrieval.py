"""Place recognition signatures: the frame's bag-of-words vector.

Port of orb_slam2_aruco_tpu/worldmap/retrieval.py (`prototype_table`,
`bow_vector`; reference DBoW2 / src/KeyFrameDatabase.cc). Descriptors are
assigned to seeded random binary prototypes by one bf16 matmul, as in the
reference (every entry is +-1, so the bf16 sums are exact integers).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.ops.orb import unpack_pm1
from orb_slam2_aruco_tpu_torch.utils.consts import const


@lru_cache(maxsize=4)
def prototype_table(num_words: int, seed: int) -> np.ndarray:
    """[W, 256] {-1,+1} float32 random binary prototypes."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(num_words, 256)).astype(np.float32) * 2 - 1


def _protos_on(num_words, seed, device):
    return const(("bow_prototypes", num_words, seed), device,
                 lambda: torch.as_tensor(prototype_table(num_words, seed))
                 .to(torch.bfloat16))


def bow_vector(packed_desc, kp_valid, num_words: int, seed: int = 7):
    """[N, 8] packed descriptors -> [W] L2-normalized word histogram."""
    A = unpack_pm1(packed_desc).to(torch.bfloat16)
    P = _protos_on(num_words, seed, packed_desc.device)
    sim = (A @ P.T).float()                             # [N, W], exact
    word = torch.argmax(sim, dim=-1)
    hist = torch.zeros(num_words, dtype=torch.float32,
                       device=packed_desc.device)
    hist.index_add_(0, word, kp_valid.to(torch.float32))
    return hist / torch.clamp(torch.linalg.norm(hist), min=1e-6)
