"""Damped normal-equation solve shared by the Levenberg–Marquardt loops.

Port of orb_slam2_aruco_tpu/optim/lm.py (g2o OptimizationAlgorithmLevenberg,
Thirdparty/g2o/g2o/core/optimization_algorithm_levenberg.cpp). The JAX
package unrolls a Cholesky for small systems to keep XLA from emitting a
custom call; here one batched `torch.linalg.solve_ex` (no host sync) does
the 6x6 solve.
"""

from __future__ import annotations

import torch
from torch.func import jvp, vmap


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


def jacobian_fwd(f, x):
    """Forward-mode Jacobian [..., m, n] of f at x [..., n] for an f that
    maps the rows of x's leading dims independently (or an x [1, n] to
    any [..., m]): one `torch.func.jvp` per input column, batched over the
    columns by `torch.func.vmap` (the JAX package's `jax.jacfwd`). x keeps
    a leading axis so no dual operand of f is 0-d: torch.func promotes a
    0-d operand of torch.where to float64 tangents."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device).reshape(
        (n,) + (1,) * (x.dim() - 1) + (n,)).expand((n,) + x.shape)
    return vmap(lambda v: jvp(f, (x,), (v,))[1])(basis).movedim(0, -1)
