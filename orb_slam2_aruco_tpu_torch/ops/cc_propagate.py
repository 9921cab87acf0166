"""Tile-local K-step min-label propagation, kernel K4.

Replaces the TPU kernel orb_slam2_aruco_tpu/ops/pallas_cc.py::
cc_propagate_pallas, the label propagation of the ArUco quad proposal's K4
route (ops/aruco/detector.py quad_candidates, use_pallas_cc=True). Labels
are [H, W] int32 with background = the sentinel H*W. The image is padded to
tile multiples plus a k_steps-pixel ring of the sentinel; each sweep runs,
for every tile, `k_steps` Jacobi 8-neighbour min steps on the tile plus its
halo (the buffer's outer ring fixed) and keeps the tile's interior:

  * `cc_propagate_cuda` launches the hand-written kernel
    (kernels/csrc/cc_propagate.cu) on a CUDA tensor, one launch per sweep;
  * `cc_propagate_torch` is the plain PyTorch version (all tiles of a sweep
    as one batch), used for CPU tensors.

Every tile of a sweep reads the sweep's input: the Pallas kernel's
interpret-mode semantics, which both versions equal bit for bit. On the TPU
the in-order grid over an aliased buffer lets a tile read earlier tiles'
updates within a sweep; the two agree once labels converge (ROADMAP.md §3,
C2).
"""

from __future__ import annotations

import torch

from orb_slam2_aruco_tpu_torch import kernels


def _pad(labels, tile: int, halo: int):
    """[H, W] -> the sentinel-padded [Hp + 2 halo, Wp + 2 halo] buffer."""
    H, W = labels.shape
    Hp, Wp = -(-H // tile) * tile, -(-W // tile) * tile
    padded = torch.full((Hp + 2 * halo, Wp + 2 * halo), H * W,
                        dtype=torch.int32, device=labels.device)
    padded[halo:halo + H, halo:halo + W] = labels
    return padded


def _sweep_torch(padded, tile: int, halo: int, k_steps: int, sentinel: int):
    hb = tile + 2 * halo
    ty, tx = (padded.shape[0] - 2 * halo) // tile, (
        padded.shape[1] - 2 * halo) // tile
    buf = padded.unfold(0, hb, tile).unfold(1, hb, tile)   # [ty, tx, hb, hb]
    buf = buf.reshape(ty * tx, hb, hb).clone()
    for _ in range(k_steps):
        c = buf[:, 1:-1, 1:-1]
        best = c
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dy == 1 and dx == 1:
                    continue
                best = torch.minimum(best, buf[:, dy:dy + hb - 2,
                                               dx:dx + hb - 2])
        buf[:, 1:-1, 1:-1] = torch.where(c < sentinel, best, c)
    out = padded.clone()
    inner = buf[:, halo:halo + tile, halo:halo + tile].reshape(
        ty, tx, tile, tile).permute(0, 2, 1, 3).reshape(ty * tile, tx * tile)
    out[halo:halo + ty * tile, halo:halo + tx * tile] = inner
    return out


def cc_propagate_torch(labels, passes: int = 12, k_steps: int = 16,
                       tile: int = 256):
    """Plain version of K4: `passes` sweeps. labels [H, W] int32 (background
    = H*W) -> [H, W] int32."""
    H, W = labels.shape
    halo = k_steps
    padded = _pad(labels.to(torch.int32), tile, halo)
    for _ in range(passes):
        padded = _sweep_torch(padded, tile, halo, k_steps, H * W)
    return padded[halo:halo + H, halo:halo + W]


def cc_propagate_cuda(labels, passes: int = 12, k_steps: int = 16,
                      tile: int = 256):
    """Launch kernel K4 (kernels/csrc/cc_propagate.cu) once per sweep on a
    CUDA int32 [H, W]."""
    if not (labels.is_cuda and labels.dtype == torch.int32
            and labels.dim() == 2):
        raise ValueError("cc_propagate_cuda takes a CUDA int32 [H, W]")
    halo = k_steps
    hb = tile + 2 * halo
    if 2 * hb * hb * 4 > kernels.SMEM_LIMIT:
        raise ValueError(f"tile {tile} + halo {halo}: two {hb}x{hb} int32 "
                         f"buffers exceed a block's shared memory")
    H, W = labels.shape
    src = _pad(labels, tile, halo)
    dst = src.clone()          # its halo ring is the sentinel for good
    stream = torch.cuda.current_stream(labels.device).cuda_stream
    launch = kernels.build.launcher("cc_propagate")
    for _ in range(passes):
        err = launch(src.data_ptr(), dst.data_ptr(), src.shape[0],
                     src.shape[1], int(tile), int(halo), int(k_steps),
                     H * W, stream)
        kernels.check_launch("cc_propagate", err)
        src, dst = dst, src
    return src[halo:halo + H, halo:halo + W]


def cc_propagate(labels, passes: int = 12, k_steps: int = 16,
                 tile: int = 256):
    """K4 on a CUDA tensor, its plain version on a CPU tensor."""
    if labels.is_cuda:
        return cc_propagate_cuda(labels, passes, k_steps, tile)
    return cc_propagate_torch(labels, passes, k_steps, tile)
