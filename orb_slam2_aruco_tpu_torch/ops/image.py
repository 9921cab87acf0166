"""Image-level primitives: pyramid, separable Gaussian blur, box filter.

Port of orb_slam2_aruco_tpu/ops/image.py (reference ORBextractor::
ComputePyramid, src/ORBextractor.cc:1107-1132). The pyramid reproduces
`jax.image.resize(method="linear", antialias=True)`: the resampling weight
matrices are built in numpy with JAX's triangle-kernel formula
(jax._src.image.scale.compute_weight_mat) and applied as two float32
matmuls, because `F.interpolate(antialias=True)` weights the edges
differently.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.utils.consts import const


def pyramid_shapes(h: int, w: int, num_levels: int,
                   scale: float) -> List[Tuple[int, int]]:
    return [
        (max(8, int(round(h / scale**l))), max(8, int(round(w / scale**l))))
        for l in range(num_levels)
    ]


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 antialiased linear resampling weights, as
    jax.image.resize computes them (scale = n_out / n_in, translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5)).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _weights_on(n_in, n_out, device):
    return const(("resize_weights", n_in, n_out), device,
                 lambda: resize_weights(n_in, n_out))


def build_pyramid(img, num_levels: int, scale: float):
    """img [H, W] float32 in [0, 255] -> list of levels; every level is
    resampled from level 0."""
    h, w = img.shape
    levels = [img]
    for hl, wl in pyramid_shapes(h, w, num_levels, scale)[1:]:
        Wh = _weights_on(h, hl, img.device)      # [h, hl]
        Ww = _weights_on(w, wl, img.device)      # [w, wl]
        levels.append(Wh.T @ img @ Ww)
    return levels


def _sep_filter_shift(img, k1):
    """Separable same-size filter with zero padding, as explicit
    shift-multiply-adds in tap order (the JAX package's order)."""
    k = np.asarray(k1, dtype=np.float32)
    r = len(k) // 2
    h, w = img.shape
    for axis in (1, 0):
        pad = (r, r, 0, 0) if axis == 1 else (0, 0, r, r)
        p = torch.nn.functional.pad(img, pad)
        acc = None
        for i, ki in enumerate(k):
            sl = (p[:, i:i + w] if axis == 1 else p[i:i + h, :]) * float(ki)
            acc = sl if acc is None else acc + sl
        img = acc
    return img


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur (reference ORBextractor.cc:1044-1105)."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return _sep_filter_shift(img, k / k.sum())


def _band_np(n: int, r: int) -> np.ndarray:
    i = np.arange(n)
    return (np.abs(i[:, None] - i[None, :]) <= r).astype(np.float32)


def box_filter(img, ksize: int):
    """Local mean over a ksize x ksize window (edges normalized by the
    in-bounds window area), as two banded float32 matmuls like the JAX
    package: for integer-valued images every sum is exact, whatever the
    summation order."""
    if ksize % 2 != 1:
        raise ValueError(f"box_filter needs an odd ksize; got {ksize}")
    h, w = img.shape
    r = ksize // 2
    f = img.to(torch.float32)
    s = const(("band", h, r), img.device, lambda: _band_np(h, r)) @ f
    s = s @ const(("band", w, r), img.device, lambda: _band_np(w, r))

    def extent(n):
        i = torch.arange(n, dtype=torch.float32, device=img.device)
        return (torch.clamp(i + r, max=n - 1) - torch.clamp(i - r, min=0)) + 1.0

    return s / (extent(h)[:, None] * extent(w)[None, :])
