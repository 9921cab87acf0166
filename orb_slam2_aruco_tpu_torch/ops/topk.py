"""Top-k with `jax.lax.top_k`'s tie rule.

`jax.lax.top_k` returns equal values in index order (lower index first);
`torch.topk` promises no order among ties. The slice ranks many ties (FAST
scores that are mostly zero, 0/1 validity flags, the quad ranking), so every
top-k of the port goes through `stable_topk`: a stable descending sort.
"""

from __future__ import annotations

import torch


def stable_topk(x, k: int, dim: int = -1):
    """(values, indices) of the k largest entries along `dim`, ties broken
    by lower index. Booleans rank as 0/1."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)
