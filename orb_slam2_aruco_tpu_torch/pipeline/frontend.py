"""Per-frame perception: ORB pyramid extraction + ArUco detection + IPPE.

Port of orb_slam2_aruco_tpu/pipeline/frontend.py (reference Frame::Frame,
src/Frame.cc:74-181). `make_frame` runs eagerly on the image's device; on a
CUDA tensor its three kernels are K1 (FAST, 1 call for all 8 levels), K2
(patches, 1 call for all 8 levels) and K3 (connected components, 1 call; with
aruco.use_pallas_cc=False the quad proposal runs plain connected components
instead). Its two halves are the spans frontend.orb (pyramid, FAST, patches,
angles, BRIEF, BoW) and frontend.aruco (detector, corner refinement,
undistortion, IPPE).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch.config import SlamConfig
from orb_slam2_aruco_tpu_torch.geometry import camera as cam_mod
from orb_slam2_aruco_tpu_torch.geometry.camera import Camera
from orb_slam2_aruco_tpu_torch.geometry.ippe import ippe_square
from orb_slam2_aruco_tpu_torch.ops import fast, image, orb
from orb_slam2_aruco_tpu_torch.ops.aruco import detector
from orb_slam2_aruco_tpu_torch.ops.topk import stable_topk
from orb_slam2_aruco_tpu_torch.utils.consts import const
from orb_slam2_aruco_tpu_torch.utils.telemetry import annotate
from orb_slam2_aruco_tpu_torch.worldmap.retrieval import bow_vector


class Frame(NamedTuple):
    """Fixed-shape per-frame data. N keypoints, A marker slots."""

    kp_uv: torch.Tensor       # [N, 2] undistorted pixels (level 0)
    kp_octave: torch.Tensor   # [N] int64 pyramid level
    kp_angle: torch.Tensor    # [N] float32
    desc: torch.Tensor        # [N, 8] int32 (uint32 bits)
    kp_valid: torch.Tensor    # [N] bool
    bow: torch.Tensor         # [W] float32
    mk_ids: torch.Tensor      # [A] int64 (-1 = empty)
    mk_corners: torch.Tensor  # [A, 4, 2] undistorted corner pixels
    mk_valid: torch.Tensor    # [A] bool
    mk_good: torch.Tensor     # [A] bool — IPPE ambiguity gate passed
    mk_Rcm: torch.Tensor      # [A, 3, 3] best IPPE pose (camera <- marker)
    mk_tcm: torch.Tensor      # [A, 3]
    mk_ippe_ratio: torch.Tensor  # [A]
    ctrl: torch.Tensor        # [2] float32 [n_valid_keypoints, n_good_markers]


_INT_FIELDS = ("kp_octave", "mk_ids")


def frame_from_numpy(arrays: dict, device="cpu") -> Frame:
    """A Frame from the JAX Frame's fields as numpy arrays (uint32
    descriptors are carried as int32 with the same bits)."""
    out = {}
    for f in Frame._fields:
        a = np.array(arrays[f])            # a writable copy
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.as_tensor(a)
        if f in _INT_FIELDS:
            t = t.to(torch.int64)
        out[f] = t.to(device)
    return Frame(**out)


def level_quotas(n_features: int, num_levels: int, scale: float):
    """Geometric per-level feature quotas (ORBextractor.cc:435-446)."""
    inv = 1.0 / scale
    raw = [inv**l for l in range(num_levels)]
    s = sum(raw)
    q = [max(8, int(round(n_features * r / s))) for r in raw]
    q[0] += n_features - sum(q)
    return q


def scale_sigma2(num_levels: int, scale: float, device="cpu"):
    """Per-octave inverse variances (Frame::mvInvLevelSigma2)."""
    return const(("scale_sigma2", num_levels, scale), device,
                 lambda: np.asarray([1.0 / (scale ** (2 * l))
                                     for l in range(num_levels)], np.float32))


def make_frame(img, cam: Camera, cfg: SlamConfig) -> Frame:
    """img: [H, W] grayscale 0..255 tensor (uint8 or float) on the device
    the frame is built on."""
    ocfg = cfg.orb
    dev = img.device
    with annotate("frontend.orb"):
        gray = img.to(torch.float32)
        levels = image.build_pyramid(gray, ocfg.num_levels,
                                     ocfg.scale_factor)
        quotas = level_quotas(ocfg.num_features, ocfg.num_levels,
                              ocfg.scale_factor)
        # one K1 launch for every level; per-level top-k on views of its
        # output
        scores = fast.fast_score_nms_levels(levels, ocfg.fast_threshold,
                                            ocfg.fast_min_threshold)
        kps = [fast.detect_level(
            lvl_img, ocfg.fast_threshold, ocfg.fast_min_threshold,
            cell_size=ocfg.cell_size, per_cell_k=8, max_kps=quota,
            edge_margin=ocfg.patch_radius + 1, score=score,
        ) for lvl_img, score, quota in zip(levels, scores, quotas)]
        blurred = [image.gaussian_blur(lvl_img, ocfg.blur_ksize,
                                       ocfg.blur_sigma) for lvl_img in levels]
        # one K2 launch for every level; angles and descriptors per level,
        # on views of its output
        all_patches = orb.extract_patches_levels(blurred,
                                                 [kp.xy for kp in kps])
        xs, octs, angs, descs, valids = [], [], [], [], []
        start = 0
        for l, (kp, quota) in enumerate(zip(kps, quotas)):
            patches = all_patches[start:start + quota]
            start += quota
            ang = orb.angles_from_patches(patches)
            xs.append(kp.xy * ocfg.scale_factor**l)
            octs.append(torch.full((quota,), l, dtype=torch.int64,
                                   device=dev))
            angs.append(ang)
            descs.append(orb.describe_patches(patches, ang))
            valids.append(kp.valid)
        kp_valid = torch.cat(valids)
        desc = torch.cat(descs)
        kp_uv = cam_mod.undistort_pixels(cam, torch.cat(xs))
        bow = bow_vector(desc, kp_valid, cfg.retrieval.num_words,
                         cfg.retrieval.proto_seed)

    with annotate("frontend.aruco"):
        acfg = cfg.aruco
        det = detector.detect_markers(
            gray, acfg.dictionary, max_quads=acfg.max_quad_candidates,
            adaptive_win=acfg.adaptive_thresh_win,
            adaptive_c=acfg.adaptive_thresh_c,
            min_area=acfg.min_quad_side_px**2, cell_px=acfg.warp_cell_px,
            cc_iters=acfg.cc_iters, downsample=acfg.detect_downsample,
            refine=False, use_pallas_cc=acfg.use_pallas_cc,
        )
        A = acfg.max_markers_per_frame
        _, order = stable_topk(det.valid, A)
        ids = det.ids[order]
        corners = detector.refine_corners_lines(
            gray, det.corners[order], n_samples=acfg.refine_samples,
            search_r=acfg.refine_radius, n_search=acfg.refine_search,
        )
        valid = det.valid[order]
        corners_un = cam_mod.undistort_pixels(cam, corners)
        xn = cam_mod.pixels_to_normalized(cam, corners_un)
        ippe_res = ippe_square(acfg.marker_size, xn)
        good = valid & (ippe_res.ratio < acfg.ippe_ambiguity_ratio)
        ctrl = torch.stack([kp_valid.sum().to(torch.float32),
                            good.sum().to(torch.float32)])
    return Frame(
        kp_uv=kp_uv, kp_octave=torch.cat(octs), kp_angle=torch.cat(angs),
        desc=desc, kp_valid=kp_valid, bow=bow,
        mk_ids=torch.where(valid, ids, -1), mk_corners=corners_un,
        mk_valid=valid, mk_good=good, mk_Rcm=ippe_res.R[:, 0],
        mk_tcm=ippe_res.t[:, 0], mk_ippe_ratio=ippe_res.ratio, ctrl=ctrl,
    )
