"""Single typed configuration for the whole engine.

Field-for-field copy of orb_slam2_aruco_tpu/config.py (the defaults are held
equal to the JAX package's by tests/test_torch_frontend.py). Comments on each
field's meaning live in the JAX module; this one adds `from_dict`/`to_dict`
so a configuration travels between the two packages as a plain dictionary
(`dataclasses.asdict` of the JAX `SlamConfig`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 480.0
    cy: float = 270.0
    dist: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    width: int = 960
    height: int = 540
    fps: float = 30.0


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    num_features: int = 1000
    scale_factor: float = 1.2
    num_levels: int = 8
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    cell_size: int = 32
    patch_radius: int = 15
    blur_ksize: int = 7
    blur_sigma: float = 2.0


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    th_high: int = 100
    th_low: int = 50
    nn_ratio_tracking: float = 0.9
    nn_ratio_init: float = 0.9
    histo_length: int = 30
    check_orientation: bool = True
    search_radius_motion: float = 15.0
    search_radius_map: float = 5.0


@dataclasses.dataclass(frozen=True)
class ArucoConfig:
    dictionary: str = "ARUCO"
    marker_size: float = 0.165
    max_markers_per_frame: int = 16
    max_quad_candidates: int = 64
    ippe_ambiguity_ratio: float = 0.7
    warp_bits_margin: int = 1
    warp_cell_px: int = 3
    adaptive_thresh_win: int = 15
    adaptive_thresh_c: float = 7.0
    cc_iters: int = 0
    detect_downsample: int = 1
    use_pallas_cc: bool = True        # quad proposal: True = fused CC +
                                      # bbox (ops/cc_fused.py, kernel K3),
                                      # False = connected_components; the
                                      # name is the JAX config's
    min_quad_side_px: float = 10.0
    refine_samples: int = 16
    refine_search: int = 11
    refine_radius: float = 2.5
    edge_weight: float = 25.0
    corner_huber_delta: float = 2.4477
    well_tracked_reproj_err: float = 2.0
    well_tracked_max_t: float = 0.3
    plane_fit_min_points: int = 5
    plane_angle_good_deg: float = 15.0
    plane_angle_bad_lo_deg: float = 40.0
    plane_angle_bad_hi_deg: float = 140.0
    max_bad_computed: int = 3
    scale_corr_max_len_diff: float = 0.015
    scale_corr_min_markers: int = 3


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    min_init_features: int = 100
    min_init_matches: int = 100
    init_min_marker_baseline: float = 0.1
    init_marker_reproj_err: float = 2.0
    init_min_good_frac: float = 0.7
    min_matches_motion: int = 20
    min_matches_refkf: int = 15
    min_inliers_track: int = 10
    min_matches_local_map: int = 30
    max_local_keyframes: int = 80
    max_frames_between_kf: int = 30
    min_frames_between_kf: int = 0
    kf_ref_ratio: float = 0.75
    reloc_min_inliers: int = 50
    reset_if_lost_with_kfs_leq: int = 5
    pipeline_depth: int = 0
    loc_two_stage: bool = True
    loc_seed_mode: str = "scan"
    loc_extrap_radius_scale: float = 2.5
    loc_extrap_passes: int = 2
    loc_seed_marker_err: float = 10.0
    local_map_candidates: int = 4096
    seed_rounds: int = 2
    seed_iters: int = 6


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    pose_rounds: int = 4
    pose_iters_per_round: int = 10
    chi2_mono: float = 5.991
    huber_delta: float = 2.4477
    local_ba_iters_first: int = 5
    local_ba_iters_second: int = 10
    global_ba_iters: int = 20
    post_loop_gba_iters: int = 20
    gba_slice_iters: int = 2
    local_ba_slices: int = 2
    distributed_gba: bool = False
    sim3_iters: int = 5
    essential_graph_iters: int = 20
    essential_graph_min_covis: int = 100
    lm_lambda_init: float = 1e-4
    lm_lambda_essential: float = 1e-16
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.1


@dataclasses.dataclass(frozen=True)
class MapConfig:
    max_keyframes: int = 256
    max_points: int = 20000
    max_markers: int = 64
    max_obs_per_point: int = 24
    triangulation_neighbors: int = 20
    local_ba_window: int = 8
    local_ba_fixed_ring: int = 8
    covis_edge_min: int = 15
    max_loop_edges: int = 16
    cull_found_ratio: float = 0.25
    kf_cull_redundancy: float = 0.9
    kf_cull_marker_min_obs: int = 5


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    min_kfs_between_loops: int = 10
    consistency_threshold: int = 3
    sim3_min_inliers: int = 15
    sim3_min_inliers_classic: int = 20
    proj_min_matches: int = 30
    proj_min_matches_classic: int = 40
    fix_scale: bool = True


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    num_words: int = 4096
    proto_seed: int = 7
    min_shared_word_frac: float = 0.8
    min_acc_score_frac: float = 0.75


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    kf_axis: str = "kf"
    num_devices: int = 1


_SECTIONS = {
    "camera": CameraConfig,
    "orb": OrbConfig,
    "matcher": MatcherConfig,
    "aruco": ArucoConfig,
    "tracking": TrackingConfig,
    "optim": OptimConfig,
    "map": MapConfig,
    "loop": LoopConfig,
    "retrieval": RetrievalConfig,
    "mesh": MeshConfig,
}


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    aruco: ArucoConfig = dataclasses.field(default_factory=ArucoConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    retrieval: RetrievalConfig = dataclasses.field(default_factory=RetrievalConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SlamConfig":
        """Inverse of `to_dict`; missing sections and fields keep their
        defaults, unknown ones raise."""
        kw = {}
        for name, sub in d.items():
            cls = _SECTIONS[name]
            fields = dict(sub)
            if "dist" in fields:
                fields["dist"] = tuple(fields["dist"])
            kw[name] = cls(**fields)
        return SlamConfig(**kw)
