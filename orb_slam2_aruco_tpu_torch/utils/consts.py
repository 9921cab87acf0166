"""Constant tensors made once per device.

Copying a host array to a CUDA device (`torch.tensor(list, device=...)`,
`torch.as_tensor(array, device=...)`) is a synchronizing call: it waits for
every kernel already queued. Inside the per-frame path that would stall the
host once per constant per call, so every such constant is made here once
per (key, device) and reused. Callers must not write into a cached tensor.
"""

from __future__ import annotations

import numpy as np
import torch

_CACHE = {}


def _on(v, device) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v))).to(device)


def const(key, device, make):
    """`make()` (a numpy array or tensor, or a tuple of them) as tensors on
    `device`, made on the first call for (key, device) and reused after."""
    k = (key, str(torch.device(device)))
    t = _CACHE.get(k)
    if t is None:
        v = make()
        t = (tuple(_on(x, device) for x in v) if isinstance(v, tuple)
             else _on(v, device))
        _CACHE[k] = t
    return t
