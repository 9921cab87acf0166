"""Oriented BRIEF (ORB): IC angle + steered 256-bit descriptors, plus K2.

Port of orb_slam2_aruco_tpu/ops/orb.py (reference ORBextractor IC_Angle,
src/ORBextractor.cc:77-104, and computeOrbDescriptor, :108-147). The seeded
sampling pattern and the separable steering tables are generated with the
same numpy calls, so they are bit-identical to the JAX package's.

Patch extraction replaces the TPU kernel
ops/pallas_patches.py::extract_patches_pallas. `extract_patches_levels`
takes every pyramid level of a frame and its keypoints: on CUDA tensors it
is one launch of the hand-written kernel (kernels/csrc/patches.cu), on CPU
tensors the plain per-level gathers (`extract_patches_torch`).
`extract_patches_cuda` is the same kernel on one level at given corners.

Packed descriptors are carried as int32 holding the uint32 bits of the JAX
package (torch lacks most bitwise ops on uint32); right shifts are masked.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.utils.consts import const

PATCH_RADIUS = 15
NUM_BITS = 256
_PATTERN_SEED = 20260817
ANGLE_BINS = 32
_PATCH = 32
_PATCH_C = 16.0


@lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256, 4] float32 (x1, y1, x2, y2) offsets, norm <= 13."""
    rng = np.random.default_rng(_PATTERN_SEED)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(NUM_BITS, 4)).astype(np.float32)
    for cols in ((0, 1), (2, 3)):
        v = pts[:, cols]
        n = np.linalg.norm(v, axis=1, keepdims=True)
        scale = np.minimum(1.0, (PATCH_RADIUS - 2.0) / np.maximum(n, 1e-6))
        pts[:, cols] = v * scale
    return np.round(pts).astype(np.float32)


@lru_cache(maxsize=1)
def _moment_kernels():
    """31x31 IC-angle moment kernels (x and y times the radius-15 disc)."""
    r = PATCH_RADIUS
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    circ = (x * x + y * y <= r * r).astype(np.float32)
    return (np.asarray(x * circ, dtype=np.float32),
            np.asarray(y * circ, dtype=np.float32))


def orientation_map(img):
    """Per-pixel IC angle atan2(m01, m10) of the circular 31x31 patch,
    [H, W] float32 radians. The moments are two zero-padded "same"
    cross-correlations (F.conv2d applies the kernel unflipped, as
    lax.conv_general_dilated does); TF32 is off package-wide."""
    kx, ky = _moment_kernels()
    k = torch.as_tensor(np.stack([kx, ky])[:, None], device=img.device)
    m = torch.nn.functional.conv2d(img.to(torch.float32)[None, None], k,
                                   padding=PATCH_RADIUS)[0]
    return torch.atan2(m[1], m[0])


@lru_cache(maxsize=1)
def _moment_kernels_patch32():
    """IC-angle moment weights over a flattened 32x32 patch (keypoint at
    (16, 16), circular radius 15)."""
    y, x = np.mgrid[0:32, 0:32]
    dx = (x - 16).astype(np.float32)
    dy = (y - 16).astype(np.float32)
    circ = (dx * dx + dy * dy <= 15 * 15).astype(np.float32)
    return ((dx * circ).reshape(-1).astype(np.float32),
            (dy * circ).reshape(-1).astype(np.float32))


@lru_cache(maxsize=1)
def _steered_sep_tables():
    """([B, 512, 32], [B, 512, 32]) row/column bilinear tap tables per angle
    bin (see the JAX module for the derivation)."""
    pat = brief_pattern()
    pts = np.concatenate([pat[:, :2], pat[:, 2:]], axis=0)
    Wy = np.zeros((ANGLE_BINS, 512, _PATCH), np.float32)
    Wx = np.zeros((ANGLE_BINS, 512, _PATCH), np.float32)
    for b in range(ANGLE_BINS):
        th = 2.0 * np.pi * b / ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        rx = pts[:, 0] * c - pts[:, 1] * s + _PATCH_C
        ry = pts[:, 0] * s + pts[:, 1] * c + _PATCH_C
        x0 = np.clip(np.floor(rx).astype(int), 0, _PATCH - 2)
        y0 = np.clip(np.floor(ry).astype(int), 0, _PATCH - 2)
        fx = np.clip(rx - x0, 0.0, 1.0)
        fy = np.clip(ry - y0, 0.0, 1.0)
        k = np.arange(512)
        Wx[b, k, x0] = 1.0 - fx
        Wx[b, k, x0 + 1] = fx
        Wy[b, k, y0] = 1.0 - fy
        Wy[b, k, y0 + 1] = fy
    return Wy, Wx


def _tables_on(device):
    """The steering tables rounded to bf16 (as the reference feeds them to
    the MXU), held in float32 on `device`; the moment kernels."""
    def make():
        Wy, Wx = _steered_sep_tables()
        kx, ky = _moment_kernels_patch32()
        as_bf16 = lambda a: torch.as_tensor(a).to(torch.bfloat16).float()  # noqa
        return as_bf16(Wy), as_bf16(Wx), kx, ky

    return const("orb_tables", device, make)


def extract_patches_torch(img, y0, x0, patch: int = _PATCH):
    """[N, patch, patch] windows of img [H, W] at top-left corners (y0, x0)
    [N] int32, clamped into the image as dynamic_slice clamps them."""
    H, W = img.shape
    y0 = torch.clamp(y0.long(), 0, H - patch)
    x0 = torch.clamp(x0.long(), 0, W - patch)
    r = torch.arange(patch, device=img.device)
    rows = (y0[:, None, None] + r[None, :, None])
    cols = (x0[:, None, None] + r[None, None, :])
    return img[rows, cols]


# levels one K2 launch takes (kMaxLevels in kernels/csrc/patches.cu)
_MAX_LEVELS = 16


def _launch_patches(rows, device):
    """One K2 launch over the levels `rows`: (img, xy, y0, x0, n), xy or
    y0/x0 None. Returns the [sum n, 32, 32] patches in level order."""
    total = sum(r[4] for r in rows)
    out = torch.empty((total, _PATCH, _PATCH), dtype=torch.float32,
                      device=device)
    if total == 0:
        return out
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    table = np.array([(img.data_ptr(), ptr(xy), ptr(y0), ptr(x0),
                       img.shape[0], img.shape[1], n)
                      for img, xy, y0, x0, n in rows], dtype=np.int64)
    err = kernels.build.launcher("patches")(
        table.ctypes.data, len(rows), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    kernels.check_launch("patches", err)
    return out


def _check_level(img, patch):
    if not (img.is_cuda and img.dtype == torch.float32 and img.dim() == 2):
        raise ValueError("K2 takes CUDA float32 [H, W] images")
    if patch != _PATCH:
        raise ValueError(f"K2 extracts {_PATCH}px patches, not {patch}px")
    H, W = img.shape
    if H < patch or W < patch:
        raise ValueError(f"image {H}x{W} smaller than the {patch}px patch")
    return img.contiguous()


def extract_patches_cuda(img, y0, x0, patch: int = _PATCH):
    """Launch kernel K2 (kernels/csrc/patches.cu) on one CUDA image at
    top-left corners (y0, x0) [N]."""
    img = _check_level(img, patch)
    if not (y0.is_cuda and x0.is_cuda) or y0.shape != x0.shape:
        raise ValueError("extract_patches_cuda takes CUDA y0, x0 of one "
                         "shape [N]")
    y0 = y0.to(torch.int32).contiguous()
    x0 = x0.to(torch.int32).contiguous()
    return _launch_patches([(img, None, y0, x0, y0.shape[0])], img.device)


def extract_patches_levels_cuda(levels, xys, patch: int = _PATCH):
    """Launch kernel K2 once for all levels: levels [H_l, W_l] float32 and
    keypoints xys [N_l, 2] float32 on the card -> [sum N_l, 32, 32]."""
    if not 1 <= len(levels) <= _MAX_LEVELS or len(levels) != len(xys):
        raise ValueError(f"extract_patches_levels_cuda takes 1 to "
                         f"{_MAX_LEVELS} levels, each with its keypoints")
    rows = []
    for img, xy in zip(levels, xys):
        img = _check_level(img, patch)
        if not (xy.is_cuda and xy.dtype == torch.float32 and xy.dim() == 2
                and xy.shape[1] == 2):
            raise ValueError("extract_patches_levels_cuda takes CUDA "
                             "float32 keypoints [N, 2]")
        xy = xy.contiguous()
        rows.append((img, xy, None, None, xy.shape[0]))
    return _launch_patches(rows, levels[0].device)


def extract_patches_levels_torch(levels, xys, patch: int = _PATCH):
    """Plain version of extract_patches_levels_cuda: the per-level gathers,
    concatenated."""
    return torch.cat([
        extract_patches_torch(img, *patch_corners(img.shape, xy, patch), patch)
        for img, xy in zip(levels, xys)])


def extract_patches_levels(levels, xys, patch: int = _PATCH):
    """[sum N_l, patch, patch] patches centred at the keypoints of every
    level, in level order: one K2 launch on CUDA tensors, the plain version
    on CPU tensors."""
    if levels[0].is_cuda:
        return extract_patches_levels_cuda(levels, xys, patch)
    return extract_patches_levels_torch(levels, xys, patch)


def patch_corners(img_shape, xy, patch: int = _PATCH):
    """Top-left corners (y0, x0) of the patches centred at keypoints xy."""
    h, w = img_shape
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int32) - patch // 2,
                     0, w - patch)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int32) - patch // 2,
                     0, h - patch)
    return y0, x0


def extract_patches(img, xy, patch: int = _PATCH):
    """[N, patch, patch] patches with top-left at kp - patch/2: K2 on a CUDA
    tensor, its plain version on a CPU tensor."""
    return extract_patches_levels([img], [xy], patch)


def keypoint_angles(img, xy):
    """IC angles at keypoints xy [N, 2] (reference IC_Angle,
    ORBextractor.cc:77-104): the patches by extract_patches (K2 on a CUDA
    tensor), then angles_from_patches."""
    return angles_from_patches(extract_patches(img, xy))


def describe(img_blurred, xy, angles):
    """256-bit steered BRIEF at keypoints xy [N, 2] with angles [N] ->
    packed [N, 8] int32: the patches by extract_patches (K2 on a CUDA
    tensor), then describe_patches."""
    return describe_patches(extract_patches(img_blurred, xy), angles)


def angles_from_patches(patches):
    """IC angle from [N, 32, 32] patches (two float32 matvecs)."""
    _, _, kx, ky = _tables_on(patches.device)
    flat = patches.reshape(patches.shape[0], -1)
    return torch.atan2(flat @ ky, flat @ kx)


def describe_patches(patches, angles):
    """Steered BRIEF from [N, 32, 32] patches -> packed [N, 8] int32.

    The reference contracts bf16 patches with bf16 tap tables into float32
    sums. Every product of two bf16 values is exact in float32 and each row
    holds two non-zero taps, so float32 matmuls on the bf16-rounded operands
    give the reference's sums."""
    Wy_all, Wx_all, _, _ = _tables_on(patches.device)
    bins = torch.remainder(
        torch.round(angles * (ANGLE_BINS / (2.0 * np.pi))).to(torch.int32),
        ANGLE_BINS).long()
    Wy = Wy_all[bins]                                  # [N, 512, 32]
    Wx = Wx_all[bins]
    pb = patches.to(torch.bfloat16).float()
    tmp = torch.bmm(Wy, pb)                            # [N, 512, 32]
    sel = torch.sum(tmp * Wx, dim=-1)                  # [N, 512]
    bits = (sel[:, :256] < sel[:, 256:]).to(torch.int32)
    return pack_bits(bits)


def _shifts_on(device):
    """The bit positions 0..31 as int64 on `device`, made there once."""
    return const("bit_shifts", device, lambda: np.arange(32, dtype=np.int64))


def pack_bits(bits):
    """[N, 256] {0,1} -> [N, 8] int32 (the uint32 bit pattern)."""
    n = bits.shape[0]
    b = bits.reshape(n, 8, 32).to(torch.int64)
    w = torch.sum(b << _shifts_on(bits.device), dim=-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)     # wrap into int32


def unpack_bits(packed):
    """[N, 8] int32 -> [N, 256] float32 in {0, 1}."""
    n = packed.shape[0]
    p = packed.to(torch.int64) & 0xFFFFFFFF
    b = (p[:, :, None] >> _shifts_on(packed.device)) & 1
    return b.reshape(n, 256).to(torch.float32)


def unpack_pm1(packed, dtype=torch.float32):
    """[N, 8] int32 -> [N, 256] in {-1, +1}. The JAX package defaults to
    bf16 for its MXU matmul; the port's callers take float32."""
    return (unpack_bits(packed) * 2.0 - 1.0).to(dtype)


_M1, _M2, _M4 = 0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F


def _popcount32(x):
    """Set bits of each int64 holding a 32-bit pattern (SWAR bit count)."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (x * 0x01010101) >> 24 & 0xFF


def hamming_popcount(a, b):
    """Exact Hamming distances by XOR + popcount: a [N, 8], b [M, 8] packed
    int32 -> [N, M] int32 (reference ORBmatcher::DescriptorDistance,
    src/ORBmatcher.cc:1646-1666)."""
    x = (a.to(torch.int64)[:, None, :] ^ b.to(torch.int64)[None, :, :])
    return torch.sum(_popcount32(x & 0xFFFFFFFF), dim=-1).to(torch.int32)
