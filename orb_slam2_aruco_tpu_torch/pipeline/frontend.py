"""Per-frame perception: ORB pyramid extraction + ArUco detection + IPPE.

Port of orb_slam2_aruco_tpu/pipeline/frontend.py (reference Frame::Frame,
src/Frame.cc:74-181). On a CUDA tensor the frame's three kernels are K1
(FAST, 1 call for all 8 levels), K2 (patches, 1 call for all 8 levels) and K3
(connected components, 1 call; with aruco.use_pallas_cc=False the quad
proposal runs plain connected components instead). Its two halves are the
spans frontend.orb (pyramid, FAST, patches, angles, BRIEF, BoW) and
frontend.aruco (detector, corner refinement, undistortion, IPPE).

A frame is some 2300 small ops of fixed shapes that read nothing on the
host. On the CPU `make_frame` issues them one by one. On the card each half
is captured once as a CUDA graph per `graph_key` (device, image shape and
dtype, settings, camera) and replayed after that, so a frame costs the host
two graph launches and the copies in and out. `GRAPH` counts the calls by
route.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_aruco_tpu_torch import kernels
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


def _orb_half(img, cam: Camera, cfg: SlamConfig):
    """The frame's ORB half: (gray, (kp_uv, kp_octave, kp_angle, desc,
    kp_valid, bow))."""
    ocfg = cfg.orb
    dev = img.device
    gray = img.to(torch.float32)
    levels = image.build_pyramid(gray, ocfg.num_levels, ocfg.scale_factor)
    quotas = level_quotas(ocfg.num_features, ocfg.num_levels,
                          ocfg.scale_factor)
    # one K1 launch for every level; per-level top-k on views of its output
    scores = fast.fast_score_nms_levels(levels, ocfg.fast_threshold,
                                        ocfg.fast_min_threshold)
    kps = [fast.detect_level(
        lvl_img, ocfg.fast_threshold, ocfg.fast_min_threshold,
        cell_size=ocfg.cell_size, per_cell_k=8, max_kps=quota,
        edge_margin=ocfg.patch_radius + 1, score=score,
    ) for lvl_img, score, quota in zip(levels, scores, quotas)]
    blurred = [image.gaussian_blur(lvl_img, ocfg.blur_ksize, ocfg.blur_sigma)
               for lvl_img in levels]
    # one K2 launch for every level; angles and descriptors per level, on
    # views of its output
    all_patches = orb.extract_patches_levels(blurred, [kp.xy for kp in kps])
    xs, octs, angs, descs, valids = [], [], [], [], []
    start = 0
    for l, (kp, quota) in enumerate(zip(kps, quotas)):
        patches = all_patches[start:start + quota]
        start += quota
        ang = orb.angles_from_patches(patches)
        xs.append(kp.xy * ocfg.scale_factor**l)
        octs.append(torch.full((quota,), l, dtype=torch.int64, device=dev))
        angs.append(ang)
        descs.append(orb.describe_patches(patches, ang))
        valids.append(kp.valid)
    kp_valid = torch.cat(valids)
    desc = torch.cat(descs)
    kp_uv = cam_mod.undistort_pixels(cam, torch.cat(xs))
    bow = bow_vector(desc, kp_valid, cfg.retrieval.num_words,
                     cfg.retrieval.proto_seed)
    return gray, (kp_uv, torch.cat(octs), torch.cat(angs), desc, kp_valid,
                  bow)


def _aruco_half(gray, kp_valid, cam: Camera, cfg: SlamConfig):
    """The frame's ArUco half on the ORB half's gray image: (mk_ids,
    mk_corners, mk_valid, mk_good, mk_Rcm, mk_tcm, mk_ippe_ratio, ctrl)."""
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
    return (torch.where(valid, ids, -1), corners_un, valid, good,
            ippe_res.R[:, 0], ippe_res.t[:, 0], ippe_res.ratio, ctrl)


def _make_frame_eager(img, cam: Camera, cfg: SlamConfig) -> Frame:
    """make_frame with its ops issued one by one: the CPU route, and the
    first call of a key on the card."""
    with annotate("frontend.orb"):
        gray, orb_fields = _orb_half(img, cam, cfg)
    with annotate("frontend.aruco"):
        marker_fields = _aruco_half(gray, orb_fields[4], cam, cfg)
    return Frame(*orb_fields, *marker_fields)


# make_frame's calls by route: "capture" (a key's first call on the card:
# one eager call, then its graphs captured), "replay" (the card after that),
# "eager" (CPU tensors)
GRAPH = {"capture": 0, "replay": 0, "eager": 0}

# graph_key -> _FrameGraphs, kept for the life of the process
_GRAPHS = {}


def graph_key(img, cam: Camera, cfg: SlamConfig):
    """What a captured frame depends on besides the image's pixels: the
    device, the image's shape and dtype, the settings make_frame reads and
    the camera, whose tensors the graphs read by address."""
    return (img.device, tuple(img.shape), img.dtype, cfg.orb, cfg.aruco,
            cfg.retrieval, cam.width, cam.height,
            tuple(t.data_ptr() for t in (cam.fx, cam.fy, cam.cx, cam.cy,
                                         cam.dist)))


@contextlib.contextmanager
def _capturing(graph, pool):
    """Capture what the body enqueues on the current stream into `graph`
    (torch.cuda.graph would also synchronize the device and empty the
    allocator's cache). An error in the body ends the capture and is raised
    as it was."""
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        yield
    except BaseException:
        # the capture is broken already; the body's error says why
        with contextlib.suppress(RuntimeError):
            graph.capture_end()
        raise
    graph.capture_end()


class _FrameGraphs:
    """make_frame on one key as two CUDA graphs captured into one memory
    pool: the ORB half, then the ArUco half, which reads the ORB half's gray
    image and keypoint mask. Capture on a side stream after an eager call
    there (which makes every constant and library handle the graphs use)."""

    def __init__(self, img, cam: Camera, cfg: SlamConfig):
        self.cam = cam      # its tensors are read by address: kept alive
        self.img = torch.empty(img.shape, dtype=img.dtype, device=img.device)
        self.orb, self.aruco = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        before = dict(kernels.launch_counts)
        with _capturing(self.orb, pool):
            # gray and kp_valid, static outputs the ArUco graph reads
            self.gray, self.orb_out = _orb_half(self.img, cam, cfg)
        with _capturing(self.aruco, pool):
            self.aruco_out = _aruco_half(self.gray, self.orb_out[4], cam, cfg)
        # the wrappers counted launches that only the replays run
        self.launches = {k: kernels.launch_counts[k] - n
                         for k, n in before.items()}
        kernels.launch_counts.update(before)

    def replay(self, img) -> Frame:
        """The frame of img: both graphs replayed on the current stream,
        then their outputs cloned, so that no later replay writes into a
        Frame returned."""
        with annotate("frontend.orb"):
            self.img.copy_(img)
            self.orb.replay()
            orb_fields = [t.clone() for t in self.orb_out]
        with annotate("frontend.aruco"):
            self.aruco.replay()
            marker_fields = [t.clone() for t in self.aruco_out]
        for k, n in self.launches.items():
            kernels.launch_counts[k] += n
        return Frame(*orb_fields, *marker_fields)


def _capture(img, cam: Camera, cfg: SlamConfig):
    """A key's first call on the card: (the eager frame, the graphs), both
    made on a side stream that waits for the current one and that it then
    waits for."""
    main = torch.cuda.current_stream(img.device)
    side = torch.cuda.Stream(img.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        frame = _make_frame_eager(img, cam, cfg)
        graphs = _FrameGraphs(img, cam, cfg)
    main.wait_stream(side)
    for t in frame:
        t.record_stream(main)
    return frame, graphs


def make_frame(img, cam: Camera, cfg: SlamConfig) -> Frame:
    """img: [H, W] grayscale 0..255 tensor (uint8 or float) on the device
    the frame is built on. A CPU tensor runs eagerly. On the card the first
    call of a graph_key runs eagerly and captures the frame as two CUDA
    graphs; later calls replay them and return fresh tensors."""
    if not img.is_cuda:
        GRAPH["eager"] += 1
        return _make_frame_eager(img, cam, cfg)
    key = graph_key(img, cam, cfg)
    graphs = _GRAPHS.get(key)
    if graphs is not None:
        GRAPH["replay"] += 1
        return graphs.replay(img)
    frame, _GRAPHS[key] = _capture(img, cam, cfg)
    GRAPH["capture"] += 1
    return frame
