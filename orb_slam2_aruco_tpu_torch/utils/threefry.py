"""The draws the SLAM slice takes from `jax.random`, bit for bit.

The JAX package draws random numbers in two places of the SLAM path:
`jax.random.categorical` picks the 5-point plane hypotheses of
`pipeline/mapping.py:1008-1017`, and `jax.random.choice(..., replace=True,
p=...)` picks the 8-point sets of the classic initializer
(`pipeline/initializer.py:118-121`). The port must draw the same numbers,
or the plane RANSAC and the H / F RANSAC pick other hypotheses. The card's
machine has no jax, so this module computes them: Threefry-2x32 (20
rounds, Salmon et al. 2011) with JAX's key layout, `fold_in`, and the
partitionable bit layout (`jax_threefry_partitionable=True`, the default
since JAX 0.5), where element i of a draw hashes the 64-bit counter i.

One hash serves both sides: on Python ints it derives the keys on the host
(two 32-bit words), on int64 tensors it computes the draw on their device
(uint32 values in int64 arithmetic masked to 32 bits), so the draws need no
host copy of device data.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash of counter pairs (x1, x2) under key (k1, k2),
    for Python ints or int64 tensors holding uint32 values."""
    ks = (int(k1), int(k2), int(k1) ^ int(k2) ^ _PARITY)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) & _M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def PRNGKey(seed: int) -> tuple[int, int]:
    """jax.random.PRNGKey(seed) for a seed that fits int32: (0, seed)."""
    return 0, seed & _M32


def fold_in(key, data: int) -> tuple[int, int]:
    """jax.random.fold_in(key, data): the hash of the pair (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def uniform(key, shape, device, minval=0.0, maxval=1.0):
    """jax.random.uniform(key, shape, float32, minval, maxval) on `device`:
    element i takes 23 mantissa bits of hi ^ lo of the hash of the 64-bit
    counter i as a float in [1, 2), minus 1, scaled."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    bits = ((a ^ b) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    out = f * float(hi - lo) + float(lo)
    return torch.clamp(out, min=float(lo)).reshape(shape)
def categorical_masked_argmax(key, mask, shape):
    """jax.random.categorical(key, logits, axis=-1, shape=shape) where every
    logit is 0 or -inf, drawn on the mask's device: `mask` (a logits-shaped
    bool tensor, True where 0) broadcasts against shape + (n,) as JAX
    broadcasts the logits. With such logits the Gumbel-max draw is the
    argmax of the Gumbel noise over the unmasked entries, and the noise
    -log(-log(u)) is increasing in its uniform u, so the argmax of u is the
    same index (the first on ties, as jnp.argmax) without a log. Returns
    int64 indices of `shape`."""
    full = tuple(shape) + (mask.shape[-1],)
    u = uniform(key, full, mask.device, float(np.finfo(np.float32).tiny),
                1.0)
    return torch.argmax(torch.where(mask.expand(full), u, -1.0), dim=-1)


def xla_cumsum(x, base: int = 16):
    """float32 running sum of the 1-D tensor x in XLA's CPU order: rows of
    `base` summed in sequence, each row then offset by the running sum of
    the row totals (XLA's reduce-window rewrite of a cumulative sum,
    applied again to the totals). The sums in sequence are `base`
    elementwise adds over the rows, so every rounding is the reference's
    on any device."""
    n = x.shape[0]
    if n <= base:
        return torch.stack(list(itertools.accumulate(x.unbind(0))))
    rows = -(-n // base)
    q = torch.zeros(rows * base, dtype=torch.float32, device=x.device)
    q[:n] = x
    inner = torch.stack(list(itertools.accumulate(
        q.reshape(rows, base).unbind(1))), dim=1)
    carry = torch.cat([q.new_zeros(1), xla_cumsum(inner[:, -1], base)[:-1]])
    return (inner + carry[:, None]).reshape(-1)[:n]


def choice_p(key, shape, p):
    """jax.random.choice(key, len(p), shape, replace=True, p=p) for a
    float32 tensor p, drawn on its device: a left search of
    (1 - u) * sum(p) in the running sum of p, summed in the order the JAX
    package's CPU run sums it (`xla_cumsum`). Returns int64 indices."""
    c = xla_cumsum(p)
    u = uniform(key, tuple(shape), p.device)
    r = c[-1] * (1.0 - u)
    return torch.searchsorted(c, r.reshape(-1), side="left").reshape(shape)
