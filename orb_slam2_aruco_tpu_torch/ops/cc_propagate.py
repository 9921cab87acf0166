"""Tile-local K-step min-label propagation, kernel K4.

Replaces the TPU kernel orb_slam2_aruco_tpu/ops/pallas_cc.py::
cc_propagate_pallas, the label propagation of the ArUco quad proposal's K4
route (ops/aruco/detector.py quad_candidates, use_pallas_cc=True). Labels
are [H, W] int32 with background = the sentinel H*W. The image is padded to
tile multiples plus a k_steps-pixel ring of the sentinel; each sweep runs,
for every tile, `k_steps` Jacobi 8-neighbour min steps on the tile plus its
halo (the buffer's outer ring fixed) and keeps the tile's interior:

  * `cc_propagate_cuda` launches the hand-written kernel
    (kernels/csrc/cc_propagate.cu) on a CUDA tensor, one launch per sweep
    (a cluster of CTAs per tile); the kernel reads the unpadded labels and
    takes every pixel outside them as the sentinel, so a sweep is that one
    launch and nothing else;
  * `cc_propagate_torch` is the plain PyTorch version (all tiles of a sweep
    as one batch, on the padded copy), used for CPU tensors.

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


# CTAs per tile, rows per thread and step, and threads per CTA
# (kCluster, kMaxRows, the launch bounds in kernels/csrc/cc_propagate.cu)
_CLUSTER = 8
_MAX_ROWS = 12
_MAX_THREADS = 1024
# steps between two trades of ghost rows among a tile's CTAs: the fastest
# of 1, 2, 4, 8 and 16 at tile 128, k 16 (tools/torch_k4_variants.py)
EXCHANGE = 8


def exchange_rows(tile: int, k_steps: int):
    """The ghost rows g one K4 launch trades every g steps (1 <= g <= the
    band of 1/8 of the buffer's rows); raises where the kernel cannot take
    the tile."""
    hb = tile + 2 * k_steps
    band = -(-hb // _CLUSTER)
    g = max(1, min(EXCHANGE, k_steps, band))
    threads_x = -(-hb // 32) * 32
    rows = max(1, band + 2 * g - 2)
    groups = min(_MAX_THREADS // threads_x, rows)
    if groups < 1 or -(-rows // groups) > _MAX_ROWS or (
            (2 * (band + 2 * g) + 4 * g) * hb * 4 > kernels.SMEM_LIMIT):
        raise ValueError(f"tile {tile} + halo {k_steps}: a {hb}-wide buffer "
                         f"exceeds a CTA's threads or shared memory")
    return g


def cc_propagate_cuda(labels, passes: int = 12, k_steps: int = 16,
                      tile: int = 256):
    """Launch kernel K4 (kernels/csrc/cc_propagate.cu) once per sweep on a
    CUDA int32 [H, W]."""
    if not (labels.is_cuda and labels.dtype == torch.int32
            and labels.dim() == 2 and labels.numel() > 0):
        raise ValueError("cc_propagate_cuda takes a CUDA int32 [H, W]")
    g = exchange_rows(tile, k_steps)
    H, W = labels.shape
    src = labels.contiguous()
    if passes == 0:
        return src.clone()
    stream = torch.cuda.current_stream(labels.device).cuda_stream
    launch = kernels.build.launcher("cc_propagate")
    bufs = [torch.empty_like(src)] + ([torch.empty_like(src)]
                                      if passes > 1 else [])
    for p in range(passes):
        dst = bufs[p % len(bufs)]
        err = launch(src.data_ptr(), dst.data_ptr(), H, W, int(tile),
                     int(k_steps), int(k_steps), g, stream)
        kernels.check_launch("cc_propagate", err)
        src = dst
    return src


def cc_propagate(labels, passes: int = 12, k_steps: int = 16,
                 tile: int = 256):
    """K4 on a CUDA tensor, its plain version on a CPU tensor."""
    if labels.is_cuda:
        return cc_propagate_cuda(labels, passes, k_steps, tile)
    return cc_propagate_torch(labels, passes, k_steps, tile)
