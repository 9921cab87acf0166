"""The port's frontend against the JAX package: configuration, seeded tables,
geometry, image ops, ORB, BoW, ArUco detection, make_frame, the synthetic
renderer, and the port's independence from jax.

Inputs are made from seeds with numpy and handed to both packages; every
test states its tolerance and why.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu import config as jconfig
from orb_slam2_aruco_tpu.geometry import camera as jcam
from orb_slam2_aruco_tpu.geometry import ippe as jippe
from orb_slam2_aruco_tpu.geometry import lie as jlie
from orb_slam2_aruco_tpu.io import synthetic as jsyn
from orb_slam2_aruco_tpu.ops import fast as jfast
from orb_slam2_aruco_tpu.ops import image as jimage
from orb_slam2_aruco_tpu.ops import orb as jorb
from orb_slam2_aruco_tpu.ops.aruco import detector as jdet
from orb_slam2_aruco_tpu.ops.aruco import dictionary as jdict
from orb_slam2_aruco_tpu.pipeline import frontend as jfrontend
from orb_slam2_aruco_tpu.worldmap import retrieval as jretrieval
from orb_slam2_aruco_tpu_torch import config as tconfig
from orb_slam2_aruco_tpu_torch.geometry import camera as tcam
from orb_slam2_aruco_tpu_torch.geometry import ippe as tippe
from orb_slam2_aruco_tpu_torch.geometry import lie as tlie
from orb_slam2_aruco_tpu_torch.io import synthetic as tsyn
from orb_slam2_aruco_tpu_torch.ops import fast as tfast
from orb_slam2_aruco_tpu_torch.ops import image as timage
from orb_slam2_aruco_tpu_torch.ops import orb as torb
from orb_slam2_aruco_tpu_torch.ops.aruco import detector as tdet
from orb_slam2_aruco_tpu_torch.ops.aruco import dictionary as tdict
from orb_slam2_aruco_tpu_torch.pipeline import frontend as tfrontend
from orb_slam2_aruco_tpu_torch.worldmap import retrieval as tretrieval

from test_torch_slice import SETUPS, render_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# configuration and seeded tables
# ---------------------------------------------------------------------------


def test_config_defaults_and_dict_roundtrip():
    jd = dataclasses.asdict(jconfig.SlamConfig())
    assert tconfig.SlamConfig().to_dict() == jd
    jcfg, _, _, _ = SETUPS["full"]()
    tcfg = tconfig.SlamConfig.from_dict(dataclasses.asdict(jcfg))
    assert tcfg.to_dict() == dataclasses.asdict(jcfg)
    assert tcfg.aruco.detect_downsample == 2


@pytest.mark.parametrize("table", ["brief_pattern", "steered_sep_tables",
                                   "prototype_table", "ARUCO",
                                   "ARUCO_MIP_25h7", "ARUCO_MIP_36h12"])
def test_seeded_tables_are_bit_identical(table):
    if table == "brief_pattern":
        pairs = [(torb.brief_pattern(), jorb.brief_pattern())]
    elif table == "steered_sep_tables":
        pairs = list(zip(torb._steered_sep_tables(),
                         jorb._steered_sep_tables()))
    elif table == "prototype_table":
        pairs = [(tretrieval.prototype_table(4096, 7),
                  jretrieval.prototype_table(4096, 7))]
    else:
        pairs = list(zip(tdict.rotated_code_table(table),
                         jdict.rotated_code_table(table)))
        assert (tdict.get_dictionary(table).max_correction
                == jdict.get_dictionary(table).max_correction)
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# geometry (float32; tolerances are a few ulp of the values involved)
# ---------------------------------------------------------------------------


def test_lie_matches_jax():
    rng = np.random.default_rng(10)
    w = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    w[0] = 0.0                                    # identity
    w[1] = [np.pi - 1e-3, 0, 0]                   # near pi
    w[2] = [1e-5, -2e-5, 1e-5]                    # tiny
    xi = np.concatenate([rng.normal(0, 1, (64, 3)).astype(np.float32), w], 1)
    R_t = tlie.so3_exp(_t(w))
    R_j = jlie.so3_exp(jnp.asarray(w))
    np.testing.assert_allclose(_n(R_t), np.asarray(R_j), atol=2e-6)
    np.testing.assert_allclose(_n(tlie.so3_log(R_t)),
                               np.asarray(jlie.so3_log(R_j)), atol=5e-4)
    Rt, tt = tlie.se3_exp(_t(xi))
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(_n(Rt), np.asarray(Rj), atol=2e-6)
    np.testing.assert_allclose(_n(tt), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(_n(tlie.rot_to_quat(Rt)),
                               np.asarray(jlie.rot_to_quat(Rj)), atol=2e-6)
    np.testing.assert_allclose(_n(tlie.orthonormalize(Rt)),
                               np.asarray(jlie.orthonormalize(Rj)), atol=2e-6)


def test_se3_log_and_matrix_match_jax():
    rng = np.random.default_rng(12)
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    for scale in (1.0, 0.3):        # |omega| > pi wraps; 0.3: xi round-trips
        Rj, tj = jlie.se3_exp(jnp.asarray(xi * scale))
        Rt, tt = _t(np.asarray(Rj)), _t(np.asarray(tj))
        got = tlie.se3_log(Rt, tt)
        want = np.asarray(jlie.se3_log(Rj, tj))
        np.testing.assert_allclose(_n(got), want, atol=5e-4)
        R2, t2 = tlie.se3_exp(got)
        np.testing.assert_allclose(_n(R2), np.asarray(Rj), atol=1e-4)
        np.testing.assert_allclose(_n(t2), np.asarray(tj), atol=1e-3)
        if scale < 1:
            np.testing.assert_allclose(_n(got), xi * scale, atol=1e-4)
        np.testing.assert_array_equal(_n(tlie.se3_matrix(Rt, tt)),
                                      np.asarray(jlie.se3_matrix(Rj, tj)))
    assert tlie.se3_matrix(Rt[:2].reshape(2, 1, 3, 3),
                           tt[:2].reshape(2, 1, 3)).shape == (2, 1, 4, 4)


def test_distortion_matches_jax():
    rng = np.random.default_rng(13)
    cc = jconfig.CameraConfig(dist=(-0.1, 0.02, 0.001, -0.002, 0.003))
    jc = jcam.camera_from_config(cc)
    tc = tcam.camera_from_config(tconfig.CameraConfig(**dataclasses.asdict(cc)))
    xn = rng.uniform(-0.4, 0.4, (256, 2)).astype(np.float32)
    xd = tcam.distort_normalized(tc, _t(xn))
    np.testing.assert_allclose(_n(xd), np.asarray(jcam.distort_normalized(
        jc, jnp.asarray(xn))), atol=1e-6)
    np.testing.assert_allclose(_n(tcam.undistort_normalized(tc, xd)), xn,
                               atol=1e-5)
    xyz = rng.uniform([-1, -1, 1], [1, 1, 4], (50, 3)).astype(np.float32)
    got = tcam.project(tc, _t(xyz), distort=True)
    np.testing.assert_allclose(_n(got), np.asarray(jcam.project(
        jc, jnp.asarray(xyz), distort=True)), atol=1e-3)
    # undistorting the distorted projection gives the pinhole projection
    np.testing.assert_allclose(_n(tcam.undistort_pixels(tc, got)),
                               _n(tcam.project(tc, _t(xyz))), atol=1e-2)


def test_camera_and_ippe_match_jax():
    rng = np.random.default_rng(11)
    cc = jconfig.CameraConfig(dist=(-0.1, 0.02, 0.001, -0.002, 0.0))
    jc = jcam.camera_from_config(cc)
    tc = tcam.camera_from_config(tconfig.CameraConfig(**dataclasses.asdict(cc)))
    uv = rng.uniform([0, 0], [960, 540], (50, 2)).astype(np.float32)
    np.testing.assert_allclose(_n(tcam.undistort_pixels(tc, _t(uv))),
                               np.asarray(jcam.undistort_pixels(
                                   jc, jnp.asarray(uv))), atol=1e-3)
    xyz = rng.uniform([-1, -1, 1], [1, 1, 4], (50, 3)).astype(np.float32)
    np.testing.assert_allclose(_n(tcam.project(tc, _t(xyz))),
                               np.asarray(jcam.project(jc, jnp.asarray(xyz))),
                               atol=1e-3)
    # square markers seen from random poses: both IPPE solutions
    Rcm = np.asarray(jlie.so3_exp(jnp.asarray(
        rng.normal(0, 0.3, (20, 3)).astype(np.float32))))
    tcm = rng.uniform([-0.3, -0.3, 1.0], [0.3, 0.3, 3.0], (20, 3))
    obj = np.asarray(jippe.square_object_points(0.165))
    xc = np.einsum("kij,nj->kni", Rcm, obj) + tcm[:, None]
    xn = (xc[..., :2] / xc[..., 2:]).astype(np.float32)
    xn += rng.normal(0, 1e-3, xn.shape).astype(np.float32)
    rt = tippe.ippe_square(0.165, _t(xn))
    rj = jippe.ippe_square(0.165, jnp.asarray(xn))
    np.testing.assert_allclose(_n(rt.R[:, 0]), np.asarray(rj.R[:, 0]),
                               atol=2e-3)
    np.testing.assert_allclose(_n(rt.t[:, 0]), np.asarray(rj.t[:, 0]),
                               atol=2e-3)
    np.testing.assert_allclose(_n(rt.ratio), np.asarray(rj.ratio),
                               rtol=1e-2, atol=1e-4)


# ---------------------------------------------------------------------------
# image ops, FAST levels, ORB, BoW
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_frames():
    """Two uint8 frames of the ref_small world, their JAX config and the
    port's."""
    cfg, world, _, loc = SETUPS["small"]()
    imgs, _ = render_frames(jsyn, world, cfg.camera, loc[:2])
    return cfg, tconfig.SlamConfig.from_dict(dataclasses.asdict(cfg)), imgs


def test_pyramid_and_filters_match_jax(small_frames):
    cfg, _, imgs = small_frames
    img = imgs[0].astype(np.float32)
    lt = timage.build_pyramid(_t(img), 8, 1.2)
    lj = jimage.build_pyramid(jnp.asarray(img), 8, 1.2)
    for a, b in zip(lt, lj):
        assert a.shape == b.shape
        # stated tolerance: 1e-3 grey levels (float32 resampling sums)
        np.testing.assert_allclose(_n(a), np.asarray(b), atol=1e-3)
    np.testing.assert_allclose(_n(timage.gaussian_blur(lt[2])),
                               np.asarray(jimage.gaussian_blur(lj[2])),
                               atol=1e-3)
    # integer-valued input: every box sum is exact, the means are equal
    np.testing.assert_array_equal(_n(timage.box_filter(_t(img), 15)),
                                  np.asarray(jimage.box_filter(
                                      jnp.asarray(img), 15)))


def test_detect_level_matches_jax(small_frames):
    _, _, imgs = small_frames
    img = imgs[0].astype(np.float32)
    kt = tfast.detect_level(_t(img), 20.0, 7.0, 32, 8, 120, 16)
    kj = jfast.detect_level(jnp.asarray(img), 20.0, 7.0, 32, 8, 120, 16,
                            use_pallas=False)
    # same scores, same tie order (lower index first): identical lists
    np.testing.assert_array_equal(_n(kt.valid), np.asarray(kj.valid))
    np.testing.assert_array_equal(_n(kt.xy), np.asarray(kj.xy))
    np.testing.assert_array_equal(_n(kt.score), np.asarray(kj.score))


def test_orb_descriptors_and_bow_match_jax(small_frames):
    _, _, imgs = small_frames
    img = jimage.gaussian_blur(jnp.asarray(imgs[1].astype(np.float32)))
    rng = np.random.default_rng(12)
    xy = rng.uniform(16, [300, 220], (200, 2)).astype(np.float32)
    pj = jorb.extract_patches(img, jnp.asarray(xy))
    pt = torb.extract_patches(_t(np.asarray(img)), _t(xy))
    np.testing.assert_array_equal(_n(pt), np.asarray(pj))
    aj = jorb.angles_from_patches(pj)
    at = torb.angles_from_patches(pt)
    np.testing.assert_allclose(_n(at), np.asarray(aj), atol=1e-4)
    # same patches and angles in: bits from bf16-rounded operands
    dj = np.asarray(jorb.describe_patches(pj, aj)).view(np.int32)
    dt = _n(torb.describe_patches(pt, _t(np.asarray(aj))))
    assert (dj == dt).all(axis=1).mean() >= 0.99
    # packing round trip on the uint32 bit pattern
    bits = rng.integers(0, 2, (20, 256))
    np.testing.assert_array_equal(
        _n(torb.pack_bits(_t(bits))),
        np.asarray(jorb.pack_bits(jnp.asarray(bits))).view(np.int32))
    np.testing.assert_array_equal(_n(torb.unpack_bits(_t(dj))),
                                  np.asarray(jorb.unpack_bits(
                                      jnp.asarray(dj.view(np.uint32)))))
    valid = rng.uniform(size=200) < 0.9
    bj = np.asarray(jretrieval.bow_vector(jnp.asarray(dj.view(np.uint32)),
                                          jnp.asarray(valid), 4096, 7))
    bt = _n(tretrieval.bow_vector(_t(dj), _t(valid), 4096, 7))
    # +-1 sums are exact in both: the word histograms are equal
    np.testing.assert_allclose(bt, bj, atol=1e-6)


# ---------------------------------------------------------------------------
# ArUco detection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ds", [1, 2])
def test_quad_proposal_and_decode_match_jax(small_frames, ds):
    _, _, imgs = small_frames
    img = imgs[0].astype(np.float32)
    bj = jdet.adaptive_threshold(jnp.asarray(img))
    bt = tdet.adaptive_threshold(_t(img))
    np.testing.assert_array_equal(_n(bt), np.asarray(bj))
    if ds > 1:
        h0, w0 = bj.shape
        bj = (bj.reshape(h0 // ds, ds, w0 // ds, ds).sum(axis=(1, 3)) * 2
              >= ds * ds)
        bt = tdet.downsample_majority(bt, ds)
        np.testing.assert_array_equal(_n(bt), np.asarray(bj))
    qj, sj, vj = jdet.quad_candidates_fused(bj, 64, min_area=100.0 / ds**2,
                                            interpret=True)
    qt, st, vt = tdet.quad_candidates_fused(bt, 64, min_area=100.0 / ds**2)
    np.testing.assert_array_equal(_n(vt), np.asarray(vj))
    np.testing.assert_array_equal(_n(st), np.asarray(sj))
    v = np.asarray(vj)
    assert v.sum() >= 4
    np.testing.assert_array_equal(_n(qt)[v], np.asarray(qj)[v])
    det_j = jdet.detect_markers(jnp.asarray(img), "ARUCO", cell_px=3,
                                downsample=ds, refine=True,
                                use_pallas_cc=True)
    det_t = tdet.detect_markers(_t(img), "ARUCO", cell_px=3, downsample=ds,
                                refine=True, use_pallas_cc=True)
    np.testing.assert_array_equal(_n(det_t.ids), np.asarray(det_j.ids))
    ok = np.asarray(det_j.valid)
    assert sorted(np.asarray(det_j.ids)[ok]) == [3, 17, 42, 99]
    # refined corners: 0.05 px (float32 line fits, closed-form 2x2 eigh)
    np.testing.assert_allclose(_n(det_t.corners)[ok],
                               np.asarray(det_j.corners)[ok], atol=0.05)


# ---------------------------------------------------------------------------
# the whole frontend
# ---------------------------------------------------------------------------


def _kp_map(uv, octave, valid):
    return {(round(float(u), 3), round(float(v), 3), int(o)): i
            for i, ((u, v), o, ok) in enumerate(zip(uv, octave, valid)) if ok}


def _frames_match_jax(cfg, tcfg, imgs, min_markers):
    """make_frame of both packages on each image: marker ids and IPPE gates
    equal, corners within 0.05 px; >= 95 % of JAX's keypoints at identical
    (x, y, octave), >= 95 % of their descriptors identical (median Hamming
    0); BoW cosine >= 0.99."""
    jc = jcam.camera_from_config(cfg.camera)
    tc = tcam.camera_from_config(tcfg.camera)
    for img in imgs:
        fj = jfrontend.make_frame(jnp.asarray(img), jc, cfg)
        ft = tfrontend.make_frame(_t(img), tc, tcfg)
        # markers: ids equal, corners within 0.05 px
        np.testing.assert_array_equal(_n(ft.mk_ids), np.asarray(fj.mk_ids))
        np.testing.assert_array_equal(_n(ft.mk_good), np.asarray(fj.mk_good))
        ok = np.asarray(fj.mk_valid)
        assert ok.sum() >= min_markers
        np.testing.assert_allclose(_n(ft.mk_corners)[ok],
                                   np.asarray(fj.mk_corners)[ok], atol=0.05)
        # keypoints: >= 95 % of JAX's at identical (x, y, octave)
        mj = _kp_map(np.asarray(fj.kp_uv), np.asarray(fj.kp_octave),
                     np.asarray(fj.kp_valid))
        mt = _kp_map(_n(ft.kp_uv), _n(ft.kp_octave), _n(ft.kp_valid))
        common = sorted(set(mj) & set(mt))
        assert len(common) >= 0.95 * len(mj)
        # descriptors on those: >= 95 % identical, median Hamming 0
        dj = np.asarray(fj.desc).view(np.int32)
        dt = _n(ft.desc)
        pairs = [(dj[mj[k]], dt[mt[k]]) for k in common]
        same = np.mean([np.array_equal(a, b) for a, b in pairs])
        ham = [np.unpackbits((a ^ b).view(np.uint8)).sum() for a, b in pairs]
        assert same >= 0.95 and np.median(ham) == 0
        bj, bt = np.asarray(fj.bow), _n(ft.bow)
        assert bj @ bt / (np.linalg.norm(bj) * np.linalg.norm(bt)) >= 0.99


def test_make_frame_matches_jax(small_frames):
    cfg, tcfg, imgs = small_frames
    _frames_match_jax(cfg, tcfg, imgs, min_markers=3)


def test_make_frame_matches_jax_at_the_kitti_camera():
    """The benchmark's KITTI 00-02 configuration at its full size
    (slambench/configs/kitti00-1241x376.json: 1241x376, an odd width,
    rectified, 2000 features) on two frames of a row of 16 markers 1.4 m
    apart seen from 2.3 m, as its drive sees them; the rules of
    test_make_frame_matches_jax. JAX compiles the frame once (~25 s on the
    CPU), then ~1 s a frame."""
    with open(os.path.join(REPO, "slambench", "configs",
                           "kitti00-1241x376.json")) as f:
        slam = json.load(f)["slam"]
    base = jconfig.SlamConfig()
    cfg = base.replace(
        camera=dataclasses.replace(base.camera, **{
            **slam["camera"], "dist": tuple(slam["camera"]["dist"])}),
        orb=dataclasses.replace(base.orb, **slam["orb"]),
        aruco=dataclasses.replace(base.aruco, **slam["aruco"]))
    tcfg = tconfig.SlamConfig.from_dict(dataclasses.asdict(cfg))
    assert tcfg.to_dict() == tconfig.SlamConfig.from_dict(slam).to_dict()
    assert cfg.camera.width % 2 == 1 and not any(cfg.camera.dist)
    ids = [int(i) for i in np.random.default_rng(21).choice(
        np.arange(1, 1000), 16, replace=False)]
    world = jsyn.build_world(ids, marker_size=0.187, grid_cols=16,
                             spacing=1.4, px_per_m=500.0, extent_margin=1.0)
    poses = [jsyn.look_at_plane_pose((x, 0.0), 2.3, yaw=yaw)
             for x, yaw in ((5.6, 0.1), (12.7, -0.12))]
    imgs = [np.clip(jsyn.render_view(world, cfg.camera, R, t), 0,
                    255).astype(np.uint8) for R, t in poses]
    assert imgs[0].shape == (376, 1241)
    _frames_match_jax(cfg, tcfg, imgs, min_markers=2)


def test_make_frame_unfused_quads_match_jax(small_frames):
    """aruco.use_pallas_cc=False: both packages propose quads from plain
    connected components ranked by pixel area (not K3's bbox area), so the
    marker slots agree: ids, validity and IPPE gate exactly, corners within
    0.05 px."""
    cfg, tcfg, imgs = small_frames
    cfg = cfg.replace(aruco=dataclasses.replace(cfg.aruco,
                                                use_pallas_cc=False))
    tcfg = tcfg.replace(aruco=dataclasses.replace(tcfg.aruco,
                                                  use_pallas_cc=False))
    jc = jcam.camera_from_config(cfg.camera)
    tc = tcam.camera_from_config(tcfg.camera)
    for img in imgs:
        fj = jfrontend.make_frame(jnp.asarray(img), jc, cfg)
        ft = tfrontend.make_frame(_t(img), tc, tcfg)
        for f in ("mk_ids", "mk_valid", "mk_good"):
            np.testing.assert_array_equal(_n(getattr(ft, f)),
                                          np.asarray(getattr(fj, f)))
        ok = np.asarray(fj.mk_valid)
        assert ok.sum() >= 3
        np.testing.assert_allclose(_n(ft.mk_corners)[ok],
                                   np.asarray(fj.mk_corners)[ok], atol=0.05)


def test_render_view_is_bit_identical():
    cfg, world, _, loc = SETUPS["small"]()
    ij, gj = render_frames(jsyn, world, cfg.camera, loc[:3])
    it, gt = render_frames(tsyn, world, cfg.camera, loc[:3])
    for a, b in zip(ij, it):
        np.testing.assert_array_equal(a, b)
    wj = jsyn.build_world([3, 17, 42, 99, 7, 23, 55, 88], px_per_m=500.0,
                          spacing=0.6)
    wt = tsyn.build_world([3, 17, 42, 99, 7, 23, 55, 88], px_per_m=500.0,
                          spacing=0.6)
    np.testing.assert_array_equal(wt.texture, wj.texture)
    R, t = jsyn.look_at_plane_pose((0.9, 0.3), 2.0, yaw=0.07, pitch=0.04)
    camc = jconfig.CameraConfig()
    np.testing.assert_array_equal(tsyn.render_view(wt, camc, R, t),
                                  jsyn.render_view(wj, camc, R, t))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import orb_slam2_aruco_tpu_torch\n"
        "from orb_slam2_aruco_tpu_torch.pipeline import system, frontend, "
        "tracking\n"
        "from orb_slam2_aruco_tpu_torch.io import checkpoint, ingest, "
        "synthetic, trajectory\n"
        "from orb_slam2_aruco_tpu_torch.kernels import build\n"
        "from orb_slam2_aruco_tpu_torch.ops import fast, orb, cc_fused, "
        "cc_propagate\n"
        "from orb_slam2_aruco_tpu_torch.ops.aruco import detector\n"
        "from orb_slam2_aruco_tpu_torch.pipeline import initializer, "
        "loop_closing, mapping\n"
        "from orb_slam2_aruco_tpu_torch.geometry import horn, triangulate, "
        "twoview\n"
        "from orb_slam2_aruco_tpu_torch.optim import ba, pnp, pose_graph, "
        "sim3_opt\n"
        "from orb_slam2_aruco_tpu_torch.utils import consts, threefry\n"
        "from orb_slam2_aruco_tpu_torch.worldmap import covisibility, "
        "retrieval, state\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('orb_slam2_aruco_tpu.')"
        " or m == 'orb_slam2_aruco_tpu']\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_per_call_constants_are_made_once_per_device(small_frames):
    """Every constant the per-frame path uploads (resize weights, box-filter
    bands, octave variances, the detector's unit square, level table and
    axes, the IPPE square and flip, the ORB tables and bit shifts, the
    marker code table, the BoW prototypes) is made once per device and
    reused:
    a second make_frame adds no entry and replaces none (an upload to a
    CUDA device is a synchronizing call)."""
    from orb_slam2_aruco_tpu_torch.utils import consts

    _, cfg, imgs = small_frames
    cam = tcam.camera_from_config(cfg.camera)
    img = torch.as_tensor(imgs[0])
    tfrontend.make_frame(img, cam, cfg)
    first = dict(consts._CACHE)
    kinds = {k[0] if isinstance(k, tuple) else k for k, _ in first}
    assert {"resize_weights", "band", "unit_square", "level_table",
            "unit_axes", "square", "flip_yz", "orb_tables", "bit_shifts",
            "code_table", "bow_prototypes"} <= kinds, kinds
    tfrontend.make_frame(img, cam, cfg)
    assert consts._CACHE.keys() == first.keys()
    assert all(consts._CACHE[k] is v for k, v in first.items())
    # the tracking's octave variances
    assert (tfrontend.scale_sigma2(8, 1.2, "cpu")
            is tfrontend.scale_sigma2(8, 1.2, "cpu"))
