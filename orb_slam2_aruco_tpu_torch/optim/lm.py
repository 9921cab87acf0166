"""Damped normal-equation solve shared by the Levenberg–Marquardt loops.

Port of orb_slam2_aruco_tpu/optim/lm.py (g2o OptimizationAlgorithmLevenberg,
Thirdparty/g2o/g2o/core/optimization_algorithm_levenberg.cpp). The JAX
package unrolls a Cholesky for small systems to keep XLA from emitting a
custom call; here one batched `torch.linalg.solve_ex` (no host sync) does
the 6x6 solve.
"""

from __future__ import annotations

import torch


def diag_embed(d):
    """[..., n] -> [..., n, n] diagonal matrices."""
    return d[..., None] * torch.eye(d.shape[-1], dtype=d.dtype,
                                    device=d.device)


def solve_damped(H, b, lam):
    """Solve (H + lam*diag(H) + 1e-10*I) dx = b, batched; non-finite
    solutions (empty problems) become zero steps."""
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-10)
    Hd = H + lam[..., None, None] * (d[..., None] * eye) + 1e-10 * eye
    dx = torch.linalg.solve_ex(Hd, b[..., None])[0][..., 0]
    return torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
