"""Connected components + per-pixel blob bounding boxes, kernel K3.

Replaces the TPU kernel orb_slam2_aruco_tpu/ops/pallas_cc_fused.py::cc_fused
(the ArUco quad-proposal stage, SURVEY.md §2.2). It is the same fixed-round
approximate algorithm — `rounds` x [`prop_steps` Jacobi 8-neighbour min/max
steps + segmented scans along rows and columns] over four int32 fields on
the padded grid — so its output equals the TPU kernel's bit for bit, on
blobs that converge and on those that do not:

  * `cc_fused_cuda` launches the hand-written kernel
    (kernels/csrc/cc_fused.cu: one cooperative launch per call, its phases
    separated by grid-wide syncs) on a CUDA tensor;
  * `cc_fused_torch` is the plain PyTorch version (the TPU kernel's
    doubling scans, written on tensors), used for CPU tensors.

Labels are padded flat indices y*Wp + x (background Hp*Wp); callers decode
coordinates with the returned Wp.
"""

from __future__ import annotations

import torch

from orb_slam2_aruco_tpu_torch import kernels


def padded_shape(H: int, W: int):
    return -(-H // 8) * 8, -(-W // 128) * 128


def _seg_scan(vals, fg, axis: int, reverse: bool):
    """Exact inclusive segmented min (fields 0, 1) / max (fields 2, 3) scan
    of vals [4, Hp, Wp] along `axis` (1 = rows, 2 = columns), by the TPU
    kernel's doubling steps. A segment starts at background pixels and at
    foreground pixels whose predecessor in scan order is background or off
    the grid."""
    if reverse:
        vals, fg = vals.flip(axis), fg.flip(axis - 1)
    nfg = ~fg
    prev = torch.ones_like(nfg)
    n = fg.shape[axis - 1]
    if axis == 2:
        prev[:, 1:] = nfg[:, :-1]
    else:
        prev[1:, :] = nfg[:-1, :]
    f = nfg | prev
    d = 1
    while d < n:
        cur_v = vals.narrow(axis, d, n - d)
        prev_v = vals.narrow(axis, 0, n - d)
        start = f.narrow(axis - 1, d, n - d)
        comb = torch.cat([torch.minimum(cur_v[:2], prev_v[:2]),
                          torch.maximum(cur_v[2:], prev_v[2:])])
        new = torch.where(start, cur_v, comb)
        vals = torch.cat([vals.narrow(axis, 0, d), new], dim=axis)
        f = torch.cat([f.narrow(axis - 1, 0, d),
                       start | f.narrow(axis - 1, 0, n - d)], dim=axis - 1)
        d *= 2
    if reverse:
        vals = vals.flip(axis)
    return vals


def _prop8(vals, fg, big: int):
    """One Jacobi 8-neighbour step: min for fields 0, 1, max for 2, 3;
    background keeps its value."""
    Hp, Wp = fg.shape
    pmin = torch.nn.functional.pad(vals[:2], (1, 1, 1, 1), value=big)
    pmax = torch.nn.functional.pad(vals[2:], (1, 1, 1, 1), value=-1)
    lo, hi = vals[:2], vals[2:]
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            lo = torch.minimum(lo, pmin[:, dy:dy + Hp, dx:dx + Wp])
            hi = torch.maximum(hi, pmax[:, dy:dy + Hp, dx:dx + Wp])
    return torch.where(fg, torch.cat([lo, hi]), vals)


def cc_fused_torch(binary, rounds: int = 3, prop_steps: int = 2):
    """Plain version of K3. binary [H, W] bool -> (labels [H, W] int32,
    bbox_w [H, W] int32, bbox_h [H, W] int32, Wp)."""
    H, W = binary.shape
    Hp, Wp = padded_shape(H, W)
    dev = binary.device
    fg = torch.zeros((Hp, Wp), dtype=torch.bool, device=dev)
    fg[:H, :W] = binary
    y = torch.arange(Hp, dtype=torch.int32, device=dev)[:, None]
    x = torch.arange(Wp, dtype=torch.int32, device=dev)[None, :]
    big = Hp * Wp
    yx = (y * Wp + x).expand(Hp, Wp)
    xy = (x * Hp + y).expand(Hp, Wp)
    vals = torch.stack([
        torch.where(fg, yx, big), torch.where(fg, xy, big),
        torch.where(fg, yx, -1), torch.where(fg, xy, -1),
    ]).to(torch.int32)
    for _ in range(rounds):
        for _ in range(prop_steps):
            vals = _prop8(vals, fg, big)
        vals = _seg_scan(vals, fg, 2, False)
        vals = _seg_scan(vals, fg, 2, True)
        vals = _seg_scan(vals, fg, 1, False)
        vals = _seg_scan(vals, fg, 1, True)
    lab, lab2, labm, labm2 = vals
    bw = torch.where(fg, labm2 // Hp - lab2 // Hp + 1, 0)
    bh = torch.where(fg, labm // Wp - lab // Wp + 1, 0)
    lab = torch.where(fg, lab, big)
    return (lab[:H, :W].to(torch.int32), bw[:H, :W].to(torch.int32),
            bh[:H, :W].to(torch.int32), Wp)


def _jacobi_smem_bytes(prop_steps: int) -> int:
    """Shared memory of K3's Jacobi phase: two int4 buffers of a 32x32 tile
    plus a prop_steps-pixel halo (kernels/csrc/cc_fused.cu)."""
    return 2 * (32 + 2 * prop_steps) ** 2 * 16


def cc_fused_cuda(binary, rounds: int = 3, prop_steps: int = 2):
    """Launch kernel K3 (kernels/csrc/cc_fused.cu, one cooperative launch)
    on a CUDA bool [H, W]."""
    if not (binary.is_cuda and binary.dtype == torch.bool
            and binary.dim() == 2):
        raise ValueError("cc_fused_cuda takes a CUDA bool [H, W]")
    if rounds < 1 or prop_steps < 0:
        raise ValueError(f"cc_fused_cuda takes rounds >= 1 and prop_steps "
                         f">= 0, not {rounds}, {prop_steps}")
    if _jacobi_smem_bytes(prop_steps) > kernels.SMEM_LIMIT:
        raise ValueError(f"prop_steps={prop_steps}: the Jacobi tile and its "
                         f"halo need {_jacobi_smem_bytes(prop_steps)} bytes "
                         f"of shared memory, above {kernels.SMEM_LIMIT}")
    H, W = binary.shape
    Hp, Wp = padded_shape(H, W)
    dev = binary.device
    # one allocation: the two int4 field buffers (scratch), then lab, bw, bh
    n_fields = 2 * Hp * Wp * 4
    buf = torch.empty(n_fields + 3 * H * W, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    out = base + 4 * n_fields
    err = kernels.build.launcher("cc_fused")(
        binary.contiguous().data_ptr(), H, W, Hp, Wp, base, out,
        out + 4 * H * W, out + 8 * H * W, int(rounds), int(prop_steps),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch("cc_fused", err)
    lab, bw, bh = buf[n_fields:].view(3, H, W)
    return lab, bw, bh, Wp


def cc_fused(binary, rounds: int = 3, prop_steps: int = 2):
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if binary.is_cuda:
        return cc_fused_cuda(binary, rounds, prop_steps)
    return cc_fused_torch(binary, rounds, prop_steps)
