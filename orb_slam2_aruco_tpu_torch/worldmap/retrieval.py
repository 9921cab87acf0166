"""Place recognition: bag-of-words signatures and candidate selection.

Port of orb_slam2_aruco_tpu/worldmap/retrieval.py (reference DBoW2 and
src/KeyFrameDatabase.cc). Descriptors are assigned to seeded random binary
prototypes by one bf16 matmul, as in the JAX package (every entry is +-1,
so the bf16 sums are exact integers); the signature is the L2-normalized
word histogram and similarity a float32 dot product, as there. The
candidate gates of KeyFrameDatabase::DetectLoopCandidates /
DetectRelocalizationCandidates (:76-197) are selections on the dense
score vector.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.ops.orb import unpack_pm1
from orb_slam2_aruco_tpu_torch.ops.topk import stable_topk
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


def score_against_keyframes(bow, kf_bow, kf_valid):
    """Similarity of a query signature with every keyframe's: [K], -1 for
    empty slots."""
    return torch.where(kf_valid, kf_bow @ bow, -1.0)


def detect_candidates(bow, kf_bow, kf_valid, exclude_mask, min_score,
                      max_candidates: int = 8):
    """The top keyframes by score outside `exclude_mask`, kept at or above
    min_score and 0.75 of the best: (idx, vals, keep)."""
    s = torch.where(exclude_mask, -1.0,
                    score_against_keyframes(bow, kf_bow, kf_valid))
    vals, idx = stable_topk(s, max_candidates)
    keep = (vals >= min_score) & (vals >= 0.75 * vals[0]) & (vals > 0)
    return idx, vals, keep


def detect_candidates_grouped(bow, kf_bow, kf_valid, covis_w, exclude_mask,
                              min_score, max_candidates: int = 8,
                              group_size: int = 10,
                              shared_word_frac: float = 0.8,
                              acc_frac: float = 0.75):
    """The reference's candidate selection: keyframes sharing at least
    shared_word_frac of the most words any keyframe shares with the query
    and scoring at least min_score; their scores summed over each one's
    top-`group_size` covisible group; groups at or above acc_frac of the
    best kept. Returns (idx [C], acc_vals [C], keep [C])."""
    K = kf_valid.shape[0]
    s = score_against_keyframes(bow, kf_bow, kf_valid)
    ok = kf_valid & ~exclude_mask
    shared = (kf_bow > 0).to(torch.float32) @ (bow > 0).to(torch.float32)
    max_shared = torch.where(ok, shared, 0.0).max()
    cand = ok & (shared >= shared_word_frac * max_shared) & (s >= min_score)
    s_c = torch.where(cand, s, 0.0)
    w_top, top_idx = stable_topk(covis_w, min(group_size, K))    # [K, gs]
    group = torch.zeros((K, K), dtype=torch.bool, device=s.device)
    group.scatter_(1, top_idx, w_top > 0)
    group |= torch.eye(K, dtype=torch.bool, device=s.device)
    acc = torch.where(cand, group.to(torch.float32) @ s_c, -1.0)
    keep_k = cand & (acc >= acc_frac * acc.max()) & (acc > 0)
    vals, idx = stable_topk(torch.where(keep_k, s, -1.0), max_candidates)
    return idx, torch.maximum(acc[idx], vals), vals > 0
