"""ArUco marker detector.

Port of orb_slam2_aruco_tpu/ops/aruco/detector.py (reference
aruco::MarkerDetector, SURVEY.md §2.2): adaptive threshold -> majority-vote
downsample -> quad proposal -> fronto-parallel warp -> bit decode ->
dictionary lookup -> border / duplicate filters, and the CORNER_LINES
subpixel refinement.

The quad proposal has the JAX package's routes, chosen by `use_pallas_cc`
in `detect_markers`:

  * True: `quad_candidates_fused`, connected components + blob bboxes in
    one pass (kernel K3, ops/cc_fused.py), blobs ranked by bbox area;
  * False: `quad_candidates`, labels from `connected_components` (plain
    PyTorch, as the JAX package leaves it to XLA), blobs ranked by their
    subsampled pixel area. `quad_candidates(use_pallas_cc=True)` labels by
    K4 sweeps (ops/cc_propagate.py) and pointer jumps instead.

`sample_batched_mxu` keeps the reference's outputs, not its banded-matmul
mechanism: the mip-level choice, the pooled pixel-centre convention and the
clip into a zero-padded [crop, crop] window are the same; each sample is a
direct 4-tap bilinear gather from that window.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.geometry.ippe import homography_4pt
from orb_slam2_aruco_tpu_torch.ops.aruco.dictionary import (
    decode_bits,
    get_dictionary,
)
from orb_slam2_aruco_tpu_torch.ops.cc_fused import cc_fused
from orb_slam2_aruco_tpu_torch.ops.cc_propagate import cc_propagate
from orb_slam2_aruco_tpu_torch.ops.image import box_filter
from orb_slam2_aruco_tpu_torch.ops.topk import stable_topk
from orb_slam2_aruco_tpu_torch.utils.consts import const


class DetectedMarkers(NamedTuple):
    corners: torch.Tensor      # [K, 4, 2] float32 pixels, canonical order
    ids: torch.Tensor          # [K] int64 (-1 invalid)
    valid: torch.Tensor        # [K] bool
    decode_dist: torch.Tensor  # [K] float32


def adaptive_threshold(img, win: int = 15, c: float = 7.0):
    """Dark-region binarization: pixel < local mean - c."""
    return img < (box_filter(img, win) - c)


def downsample_majority(binary, ds: int):
    """A low-res pixel is foreground if at least half its ds x ds block
    is."""
    h0, w0 = binary.shape
    hq, wq = (h0 // ds) * ds, (w0 // ds) * ds
    blocks = binary[:hq, :wq].reshape(h0 // ds, ds, w0 // ds, ds)
    return blocks.sum(dim=(1, 3), dtype=torch.int32) * 2 >= ds * ds


def _corners_from_membership(labels, root_label, h: int, w: int):
    """Extremal-point corners of each selected blob. labels [P] per-pixel
    blob label, root_label [Q] -> quads [Q, 4, 2] (c1, c3, c2, c4)."""
    P = h * w
    dev = labels.device
    flat_idx = torch.arange(P, dtype=torch.int64, device=dev)
    xs = (flat_idx % w).to(torch.float32)
    ys = (flat_idx // w).to(torch.float32)
    M = labels[None, :] == root_label[:, None]                 # [Q, P]
    coords = torch.stack([torch.ones_like(xs), xs, ys], dim=-1)
    # integer sums below 2^24: exact in float32 whatever the order
    stats = M.to(torch.float32) @ coords
    cnt = torch.clamp(stats[:, 0], min=1.0)
    cx = stats[:, 1] / cnt
    cy = stats[:, 2] / cnt
    NEG = -1e18
    BIG = 2**30

    def masked_argmax(metric):
        mx = torch.max(torch.where(M, metric, NEG), dim=1).values
        hit = M & (metric >= mx[:, None] - 1e-3)
        idx = torch.min(torch.where(hit, flat_idx[None, :], BIG), dim=1).values
        idx = torch.clamp(idx, 0, P - 1)
        return xs[idx], ys[idx]

    d2c = (xs[None, :] - cx[:, None]) ** 2 + (ys[None, :] - cy[:, None]) ** 2
    x1, y1 = masked_argmax(d2c)
    d2c1 = (xs[None, :] - x1[:, None]) ** 2 + (ys[None, :] - y1[:, None]) ** 2
    x2, y2 = masked_argmax(d2c1)
    crossv = ((xs[None, :] - x1[:, None]) * (y2 - y1)[:, None]
              - (ys[None, :] - y1[:, None]) * (x2 - x1)[:, None])
    x3, y3 = masked_argmax(crossv)
    x4, y4 = masked_argmax(-crossv)
    return torch.stack([
        torch.stack([x1, y1], dim=-1), torch.stack([x3, y3], dim=-1),
        torch.stack([x2, y2], dim=-1), torch.stack([x4, y4], dim=-1),
    ], dim=-2)


def quad_candidates_fused(binary, max_quads: int, min_area: float = 64.0,
                          max_area_frac: float = 0.25, rounds: int = 3):
    """Quad proposal from the fused CC + bbox pass (K3): blob roots ranked
    by bbox area. Returns (quads [Q, 4, 2], score [Q], valid [Q])."""
    h, w = binary.shape
    P = h * w
    dev = binary.device
    lab2d, bb_w, bb_h, Wp = cc_fused(binary, rounds=rounds)
    own_pad = (torch.arange(h, dtype=torch.int32, device=dev)[:, None] * Wp
               + torch.arange(w, dtype=torch.int32, device=dev)[None, :])
    root = (lab2d == own_pad) & binary
    area_bb = (bb_w * bb_h).to(torch.float32)
    ok = (root & (area_bb >= min_area) & (area_bb <= max_area_frac * P)
          & (torch.minimum(bb_w, bb_h) >= 3))
    score = torch.where(ok, area_bb, 0.0).reshape(-1)
    vals, pos = stable_topk(score, max_quads)
    valid = vals > 0
    lab_flat = lab2d.reshape(-1)
    root_label = torch.where(valid, lab_flat[pos], -1)
    quads = _corners_from_membership(lab_flat, root_label, h, w)
    return quads, vals, valid


def _cummax(x, dim: int, reverse: bool):
    if reverse:
        return x.flip(dim).cummax(dim).values.flip(dim)
    return x.cummax(dim).values


def _seg_cummin_axis(lab, fg, sentinel: int, axis: int):
    """Segmented cumulative min of `lab` within foreground runs along
    `axis`, forward then backward, by a cummax over the packed key
    run_id * (sentinel + 1) + (sentinel - lab) (int64 where int32 would
    overflow)."""
    n = lab.shape[axis]
    offset = sentinel + 1
    dt = torch.int64 if (n - 1) * offset + sentinel > 2**31 - 1 else torch.int32
    shape = [1, 1]
    shape[axis] = n
    iota = torch.arange(n, dtype=dt, device=lab.device).reshape(shape)
    iota = iota.expand(lab.shape)
    reset = ~fg
    out = lab
    for reverse in (False, True):
        pos = (n - 1) - iota if reverse else iota
        s = _cummax(torch.where(reset, pos, -1), axis, reverse)
        packed = s * offset + (sentinel - out.to(dt))
        y = _cummax(packed, axis, reverse)
        seg = sentinel - (y - s * offset)
        out = torch.where(fg, seg.to(lab.dtype), out)
    return out


def pointer_jump(lab, sentinel: int):
    """lab <- lab[lab] on the flat image (background stays sentinel)."""
    lf = lab.reshape(-1)
    tgt = lf[torch.clamp(lf, max=sentinel - 1).to(torch.int64)]
    return torch.where(lf == sentinel, sentinel, tgt).reshape(lab.shape)


def initial_labels(binary):
    """Starting labels [H, W] int32: the flat index on foreground, the
    sentinel H*W on background."""
    h, w = binary.shape
    flat = torch.arange(h * w, dtype=torch.int32,
                        device=binary.device).reshape(h, w)
    return torch.where(binary, flat, h * w)


def connected_components(binary, iters: int, rounds: int | None = None):
    """Min-label connected components on [H, W] bool -> [H, W] int32 labels
    (background H*W). Each round: one 8-neighbour min step, segmented
    row and column cumulative mins, one pointer jump; ceil(log2(iters)) + 1
    rounds unless `rounds` is given."""
    h, w = binary.shape
    sentinel = h * w
    labels = initial_labels(binary)
    if rounds is None:
        rounds = max(2, math.ceil(math.log2(max(2, iters))) + 1)
    for _ in range(rounds):
        p = torch.nn.functional.pad(labels[None], (1, 1, 1, 1),
                                    value=sentinel)[0]
        best = labels
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dy == 1 and dx == 1:
                    continue
                best = torch.minimum(best, p[dy:dy + h, dx:dx + w])
        labels = torch.where(binary, best, sentinel)
        labels = _seg_cummin_axis(labels, binary, sentinel, axis=1)
        labels = _seg_cummin_axis(labels, binary, sentinel, axis=0)
        labels = pointer_jump(labels, sentinel)
    return labels


def quad_candidates(binary, max_quads: int, min_area: float = 64.0,
                    max_area_frac: float = 0.25, cc_iters: int = 0,
                    use_pallas_cc: bool = False):
    """Quad proposal from min-label connected components, blobs ranked by
    pixel area (counted on a stride-s subsample above 40000 pixels). The
    labels come from K4 sweeps + pointer jumps (use_pallas_cc=True) or from
    `connected_components`. Returns (quads [Q, 4, 2], score [Q],
    valid [Q])."""
    h, w = binary.shape
    P = h * w
    dev = binary.device
    cc_rounds = None
    if cc_iters <= 0:
        cc_rounds = 4
        cc_iters = h + w
    if use_pallas_cc:
        k_steps = 16
        labels2d = initial_labels(binary)
        rounds = max(2, math.ceil(math.log2(max(2.0, cc_iters / k_steps))) + 1)
        for _ in range(rounds):
            labels2d = cc_propagate(labels2d, passes=1, k_steps=k_steps,
                                    tile=128)
            labels2d = pointer_jump(labels2d, P)
    else:
        labels2d = connected_components(binary, iters=cc_iters,
                                        rounds=cc_rounds)
    labels = labels2d.reshape(-1)
    astride = max(1, int(round(math.sqrt(P / 32768.0)))) if P > 40000 else 1
    sub = labels2d[::astride, ::astride].reshape(-1)
    Ps = sub.shape[0]
    ss = torch.sort(sub).values
    left = torch.searchsorted(ss, ss, side="left")
    right = torch.searchsorted(ss, ss, side="right")
    area_run = (right - left).to(torch.float32) * float(astride * astride)
    run_start = left == torch.arange(Ps, dtype=left.dtype, device=dev)
    fg_run = ss < P
    area_ok = (area_run >= min_area) & (area_run <= max_area_frac * P)
    score = torch.where(run_start & fg_run & area_ok, area_run, 0.0)
    vals, pos = stable_topk(score, max_quads)
    valid = vals > 0
    root_label = torch.where(valid, ss[pos], -1)
    quads = _corners_from_membership(labels, root_label, h, w)
    return quads, vals, valid


def _quad_sample_points(quads, grid_cells: int, cell_px: int):
    """[K, S*S] x / y full-res coordinates of the warp grid over each
    quad (S = grid_cells * cell_px)."""
    K = quads.shape[0]
    S = grid_cells * cell_px
    dev = quads.device
    src = const("unit_square", dev, lambda: np.asarray(
        [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]],
        np.float32)).expand(K, 4, 2)
    H = homography_4pt(src, quads)
    u = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    grid = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1).reshape(-1, 3)
    pts = grid @ H.transpose(-1, -2)                   # [K, S*S, 3]
    z = pts[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return pts[..., 0] / zs, pts[..., 1] / zs


def _pool2(img):
    h, w = img.shape
    return img[:(h // 2) * 2, :(w // 2) * 2].reshape(
        h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def sample_batched_mxu(img, px, py, crop: int = 128):
    """Bilinear samples of per-element localized point sets. img [H, W];
    px, py [K, P] full-res coords -> [K, P].

    Per element, the mip level (full / pooled by 2^l) is chosen from the
    points' extent, the [crop, crop] window origin is clipped into that
    level (zero beyond a level smaller than the crop), and each sample is
    the 4-tap bilinear read at the clipped local coordinate."""
    K, Pn = px.shape
    dev = img.device
    need = float(max(img.shape)) + 8.0
    n_levels = 1
    while (crop - 4.0) * (2.0 ** (n_levels - 1)) < need:
        n_levels += 1
    levels = [img]
    for _ in range(n_levels - 1):
        levels.append(_pool2(levels[-1]))
    mn_x, mx_x = px.min(dim=1).values, px.max(dim=1).values
    mn_y, mx_y = py.min(dim=1).values, py.max(dim=1).values
    ext = torch.maximum(mx_x - mn_x, mx_y - mn_y) + 8.0
    # degenerate (unused) quads give NaN coordinates: level 0, NaN samples
    lvl = torch.clamp(torch.nan_to_num(torch.ceil(torch.log2(torch.clamp(
        ext / (crop - 4.0), min=1e-6))), nan=0.0),
        0, n_levels - 1).to(torch.int64)                             # [K]
    scale = torch.exp2(lvl.to(torch.float32))
    ox = torch.floor((mn_x - 4.0) / scale)
    oy = torch.floor((mn_y - 4.0) / scale)
    # all levels in one flat buffer; per element: base offset and shape
    flat = torch.cat([lv.reshape(-1) for lv in levels])
    shapes = tuple(tuple(lv.shape) for lv in levels)
    table = const(("level_table", shapes), dev, lambda: np.asarray(
        [[h for h, _ in shapes], [w for _, w in shapes],
         np.cumsum([0] + [h * w for h, w in shapes[:-1]])], np.int64))
    hs, ws, bases = table[0], table[1], table[2]
    hl, wl, base = hs[lvl], ws[lvl], bases[lvl]                     # [K]
    oxi = torch.minimum(torch.clamp(ox.to(torch.int64), min=0),
                        torch.clamp(wl - crop, min=0))
    oyi = torch.minimum(torch.clamp(oy.to(torch.int64), min=0),
                        torch.clamp(hl - crop, min=0))
    lx = torch.clamp((px + 0.5) / scale[:, None] - 0.5 - oxi[:, None],
                     0.0, crop - 1.0)
    ly = torch.clamp((py + 0.5) / scale[:, None] - 0.5 - oyi[:, None],
                     0.0, crop - 1.0)
    x0 = torch.floor(lx).to(torch.int64)
    y0 = torch.floor(ly).to(torch.int64)

    def tap(l, c):
        return torch.clamp(1.0 - torch.abs(l - c.to(torch.float32)), min=0.0)

    def read(r, c):
        # window[r, c]: level pixel (oyi + r, oxi + c), 0 outside the level
        inside = ((r >= 0) & (c >= 0) & (r < hl[:, None]) & (c < wl[:, None])
                  & (r < crop) & (c < crop))
        idx = (base[:, None] + (oyi[:, None] + r) * wl[:, None]
               + oxi[:, None] + c)
        idx = torch.where(inside, idx, 0)
        return torch.where(inside, flat[idx], 0.0)

    y1, x1 = y0 + 1, x0 + 1
    wy0, wy1 = tap(ly, y0), tap(ly, y1)
    wx0, wx1 = tap(lx, x0), tap(lx, x1)
    row0 = wy0 * read(y0, x0) + wy1 * read(y1, x0)
    row1 = wy0 * read(y0, x1) + wy1 * read(y1, x1)
    return row0 * wx0 + row1 * wx1


def warp_quads(img, quads, grid_cells: int, cell_px: int):
    K = quads.shape[0]
    S = grid_cells * cell_px
    px, py = _quad_sample_points(quads, grid_cells, cell_px)
    return sample_batched_mxu(img, px, py).reshape(K, S, S)


def decode_quads(img, quads, qvalid, dict_name: str, border_cells: int = 1,
                 cell_px: int = 8) -> DetectedMarkers:
    """Warp + bit extraction + dictionary lookup + corner
    canonicalization."""
    d = get_dictionary(dict_name)
    G = d.grid + 2 * border_cells
    K = quads.shape[0]
    warped = warp_quads(img, quads, G, cell_px)
    cells = warped.reshape(K, G, cell_px, G, cell_px).mean(dim=(2, 4))
    lo = cells.amin(dim=(1, 2), keepdim=True)
    hi = cells.amax(dim=(1, 2), keepdim=True)
    bits_grid = (cells - lo) / torch.clamp(hi - lo, min=1e-6)
    border_mask = torch.zeros((G, G), dtype=torch.bool, device=img.device)
    border_mask[:border_cells, :] = True
    border_mask[-border_cells:, :] = True
    border_mask[:, :border_cells] = True
    border_mask[:, -border_cells:] = True
    border_score = (torch.where(border_mask[None], bits_grid, 0.0)
                    .sum(dim=(1, 2)) / border_mask.sum())
    border_ok = border_score < 0.35
    inner = bits_grid[:, border_cells:-border_cells, border_cells:-border_cells]
    inner_hard = (inner > 0.5).to(torch.float32).reshape(K, d.nbits)
    ids, rots, dist = decode_bits(inner_hard, dict_name)
    ok = qvalid & border_ok & (dist <= d.max_correction)
    idx = (torch.arange(4, device=img.device)[None, :] + rots[:, None]) % 4
    corners = torch.gather(quads, 1, idx[..., None].expand(K, 4, 2))
    return DetectedMarkers(corners=corners, ids=torch.where(ok, ids, -1),
                           valid=ok, decode_dist=dist)


def detect_markers(img, dict_name: str, max_quads: int = 64,
                   adaptive_win: int = 15, adaptive_c: float = 7.0,
                   min_area: float = 100.0, max_area_frac: float = 0.25,
                   cell_px: int = 8, cc_iters: int = 0, downsample: int = 1,
                   refine: bool = True,
                   use_pallas_cc: bool = False) -> DetectedMarkers:
    """Full detection on a grayscale [H, W] float32 image (0..255), with the
    quad proposal at 1/downsample resolution (decode and refinement sample
    the full-resolution image): `quad_candidates_fused` (K3) when
    use_pallas_cc, else `quad_candidates` on `connected_components`."""
    binary = adaptive_threshold(img, adaptive_win, adaptive_c)
    ds = downsample
    if ds > 1:
        binary = downsample_majority(binary, ds)
    if use_pallas_cc:
        quads, _, qvalid = quad_candidates_fused(
            binary, max_quads, min_area=min_area / (ds * ds),
            max_area_frac=max_area_frac)
    else:
        quads, _, qvalid = quad_candidates(
            binary, max_quads, min_area=min_area / (ds * ds),
            max_area_frac=max_area_frac, cc_iters=cc_iters)
    if ds > 1:
        quads = quads * float(ds) + (ds - 1) / 2.0
    h, w = img.shape
    margin = 3.0
    inside = ((quads[..., 0] >= margin) & (quads[..., 0] <= w - 1 - margin)
              & (quads[..., 1] >= margin)
              & (quads[..., 1] <= h - 1 - margin)).all(dim=-1)
    det = decode_quads(img, quads, qvalid & inside, dict_name,
                       cell_px=cell_px)
    if refine:
        R = min(16, det.corners.shape[0])
        _, ridx = stable_topk(det.valid, R)
        refined_sub = refine_corners_lines(img, det.corners[ridx])
        keep = det.valid[ridx]
        corners = det.corners.clone()
        corners[ridx] = torch.where(keep[:, None, None], refined_sub,
                                    det.corners[ridx])
        det = det._replace(corners=corners)
    ids = det.ids
    K = ids.shape[0]
    same = (ids[:, None] == ids[None, :]) & (ids[:, None] >= 0)
    earlier = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                    device=img.device), -1)
    dup = (same & earlier).any(dim=1)
    ok = det.valid & ~dup
    return det._replace(valid=ok, ids=torch.where(ok, ids, -1))


def _principal_direction(cxx, cxy, cyy):
    """Unit eigenvector of the larger eigenvalue of [[cxx, cxy], [cxy,
    cyy]] (closed form; the sign is arbitrary, as eigh's is)."""
    half = 0.5 * (cxx - cyy)
    lam = 0.5 * (cxx + cyy) + torch.sqrt(half * half + cxy * cxy)
    # two algebraically equal candidates; take the better conditioned one
    v1 = torch.stack([cxy, lam - cxx], dim=-1)
    v2 = torch.stack([lam - cyy, cxy], dim=-1)
    n1 = torch.linalg.norm(v1, dim=-1, keepdim=True)
    n2 = torch.linalg.norm(v2, dim=-1, keepdim=True)
    v = torch.where(n1 >= n2, v1, v2)
    n = torch.maximum(n1, n2)
    unit = const("unit_axes", cxx.device,
                 lambda: np.eye(2, dtype=np.float32))
    axis = torch.where((cxx >= cyy)[..., None], unit[0], unit[1])
    return torch.where(n > 1e-12, v / torch.clamp(n, min=1e-30), axis)


def refine_corners_lines(img, corners, n_samples: int = 16,
                         search_r: float = 2.5, n_search: int = 11):
    """CORNER_LINES subpixel refinement: per side, edge points at the
    subpixel gradient peak along the normal, a total-least-squares line,
    and the intersection of adjacent lines. corners [K, 4, 2]."""
    K = corners.shape[0]
    dev = img.device
    p0 = corners
    p1 = torch.roll(corners, -1, dims=1)
    fr = (torch.arange(n_samples, dtype=torch.float32, device=dev) + 1.0) / (
        n_samples + 1.0)
    pts = p0[:, :, None, :] + fr[None, None, :, None] * (p1 - p0)[:, :, None, :]
    d = p1 - p0
    length = torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)
    tang = d / length
    normal = torch.stack([-tang[..., 1], tang[..., 0]], dim=-1)
    offs = torch.linspace(-search_r, search_r, n_search, device=dev)
    samp_xy = (pts[:, :, :, None, :]
               + offs[None, None, None, :, None] * normal[:, :, None, None, :])
    flatxy = samp_xy.reshape(K, -1, 2)
    vals = sample_batched_mxu(img, flatxy[..., 0], flatxy[..., 1]).reshape(
        K, 4, n_samples, n_search)
    g = torch.abs(vals[..., 2:] - vals[..., :-2])
    gi = torch.argmax(g, dim=-1)
    gim = torch.clamp(gi, 1, n_search - 4)
    gm1 = torch.gather(g, -1, (gim - 1)[..., None])[..., 0]
    g0 = torch.gather(g, -1, gim[..., None])[..., 0]
    gp1 = torch.gather(g, -1, (gim + 1)[..., None])[..., 0]
    denom = gm1 - 2 * g0 + gp1
    ok_den = torch.abs(denom) > 1e-6
    delta = torch.where(ok_den, 0.5 * (gm1 - gp1)
                        / torch.where(ok_den, denom, 1.0), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    step = offs[1] - offs[0]
    off_best = offs[0] + (gim.to(torch.float32) + 1.0 + delta) * step
    edge_pts = pts + off_best[..., None] * normal[:, :, None, :]
    mu = edge_pts.mean(dim=2, keepdim=True)
    dc = edge_pts - mu
    cxx = (dc[..., 0] * dc[..., 0]).sum(-1)
    cxy = (dc[..., 0] * dc[..., 1]).sum(-1)
    cyy = (dc[..., 1] * dc[..., 1]).sum(-1)
    dirv = _principal_direction(cxx, cxy, cyy)          # [K, 4, 2]
    mu = mu[:, :, 0, :]
    p_a = torch.roll(mu, 1, dims=1)
    d_a = torch.roll(dirv, 1, dims=1)
    p_b, d_b = mu, dirv
    cross = d_a[..., 0] * d_b[..., 1] - d_a[..., 1] * d_b[..., 0]
    diff = p_b - p_a
    t = (diff[..., 0] * d_b[..., 1] - diff[..., 1] * d_b[..., 0]) / torch.where(
        torch.abs(cross) < 1e-9, torch.full_like(cross, 1e-9), cross)
    refined = p_a + t[..., None] * d_a
    ok = torch.linalg.norm(refined - corners, dim=-1) < 3.0
    return torch.where(ok[..., None], refined, corners)
