"""The port's last public functions against the JAX package: the generated
ArUco dictionaries, the per-frame functions the fused paths fold away
(orientation_map, keypoint_angles, describe, hamming_popcount, to_gray,
gaussian_kernel1d, fast_score_map, nms3x3, detect_level's use_pallas), the
geometry, optimizer and synthetic helpers, default_config, the subpackage
exports and the native library's build at first use; and a name-by-name
comparison of every JAX module with its port module.

Inputs are made from seeds with numpy and handed to both packages. The
generated dictionaries and their worlds are held to
orb_slam2_aruco_tpu_torch/data/ref_dicts.npz (`python
tests/test_torch_slice.py --dicts`), since JAX's generator takes minutes.
Stated tolerances: bit-equal for the tables, hamming_popcount,
depth_in_cam, Camera.K, gaussian_kernel1d, orbit_trajectory,
marker_pose_world and default_config; the XLA FAST route (fast_score_map,
nms3x3, detect_level(use_pallas=False)) with the same nonzero pattern and
values within 1e-5 relative; detect_level(use_pallas=True) equal to JAX's
interpret-mode Pallas route; describe as the describe_patches test holds
it (99 % of the descriptors equal); angles within 1e-4 rad wherever the
moment vector's length is above 1e-3 of its maximum; to_gray 1e-6;
small_spd_solve 1e-5 relative; ba_solve(use_huber=False) within
test_torch_slam's ba_solve limits; decoded ids equal and corners within
0.05 px.
"""

import ast
import dataclasses
import filecmp
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu import config as jconfig
from orb_slam2_aruco_tpu.geometry import camera as jcam
from orb_slam2_aruco_tpu.geometry import triangulate as jtri
from orb_slam2_aruco_tpu.io import synthetic as jsyn
from orb_slam2_aruco_tpu.ops import fast as jfast
from orb_slam2_aruco_tpu.ops import image as jimage
from orb_slam2_aruco_tpu.ops import orb as jorb
from orb_slam2_aruco_tpu.ops.aruco import dictionary as jdict
from orb_slam2_aruco_tpu.ops.aruco import native as jnative
from orb_slam2_aruco_tpu.optim import ba as jba
from orb_slam2_aruco_tpu.optim import lm as jlm
from orb_slam2_aruco_tpu_torch import config as tconfig
from orb_slam2_aruco_tpu_torch.geometry import camera as tcam
from orb_slam2_aruco_tpu_torch.geometry import triangulate as ttri
from orb_slam2_aruco_tpu_torch.io import synthetic as tsyn
from orb_slam2_aruco_tpu_torch.ops import fast as tfast
from orb_slam2_aruco_tpu_torch.ops import image as timage
from orb_slam2_aruco_tpu_torch.ops import matching as tmatching
from orb_slam2_aruco_tpu_torch.ops import orb as torb
from orb_slam2_aruco_tpu_torch.ops.aruco import detector as tdet
from orb_slam2_aruco_tpu_torch.ops.aruco import dictionary as tdict
from orb_slam2_aruco_tpu_torch.ops.aruco import native as tnative
from orb_slam2_aruco_tpu_torch.optim import ba as tba
from orb_slam2_aruco_tpu_torch.optim import lm as tlm
from orb_slam2_aruco_tpu_torch.pipeline import frontend as tfrontend

from test_torch_slam import _ba_problem, _close
from test_torch_slice import (
    DICT_POSE,
    DICT_SCENES,
    DICT_TABLES,
    DICTS_PATH,
    REPO,
    SETUPS,
    _full_setup,
    render_frames,
)

JAX_PKG = os.path.join(REPO, "orb_slam2_aruco_tpu")
PORT_PKG = os.path.join(REPO, "orb_slam2_aruco_tpu_torch")

# corners of the decoded markers against the JAX recording (px)
CORNER_TOL_PX = 0.05


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def rec():
    with np.load(DICTS_PATH) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def small_img():
    """One uint8 frame of the ref_small world as float32."""
    cfg, world, _, loc = SETUPS["small"]()
    (img,), _ = render_frames(jsyn, world, cfg.camera, loc[:1])
    return img.astype(np.float32)


# ---------------------------------------------------------------------------
# the port's own dictionary data and the generated dictionaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fname", ["aruco_mip_25h7.npz",
                                   "aruco_mip_36h12.npz"])
def test_dictionary_data_are_byte_copies_inside_the_port(fname):
    ours = os.path.join(tdict._DATA_DIR, fname)
    assert os.path.commonpath([os.path.abspath(ours), PORT_PKG]) == PORT_PKG
    assert filecmp.cmp(ours, os.path.join(JAX_PKG, "ops", "aruco", "data",
                                          fname), shallow=False)


def _recorded_table(rec, table):
    grid = int(rec[f"{table}_grid"])
    codes = np.unpackbits(rec[f"{table}_packed"], axis=1)[:, :grid * grid]
    return codes, grid, int(rec[f"{table}_max_correction"])


@pytest.mark.parametrize("name", ["ARUCO", "ARUCO_MIP_36h12",
                                  "ARUCO_MIP_25h7", "TPU_25h7", "TPU_16h5",
                                  "ARUCO_MIP_16h3", "TPU_36h12"])
def test_every_dictionary_name_is_bit_equal_to_jax(name, rec):
    """The published tables against JAX's registry, the generated ones
    against JAX's recorded generator output; the name each table carries
    is JAX's (TPU_16h5 for its alias, ARUCO_MIP_25h7 for TPU_25h7)."""
    d = tdict.get_dictionary(name)
    generated = {"TPU_16h5": "TPU_16h5", "ARUCO_MIP_16h3": "TPU_16h5",
                 "TPU_36h12": "TPU_36h12"}
    if name in generated:
        codes, grid, mc = _recorded_table(rec, generated[name])
        assert d.name == generated[name]
        assert int(rec[f"{generated[name]}_num_ids"]) == d.num_ids
    else:
        j = jdict.get_dictionary(name)
        codes, grid, mc = j.codes, j.grid, j.max_correction
        assert d.name == j.name
        for a, b in zip(tdict.rotated_code_table(name),
                        jdict.rotated_code_table(name)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert d.codes.dtype == np.uint8 and np.array_equal(d.codes, codes)
    assert (d.grid, d.max_correction) == (grid, mc)


def test_mip_style_regeneration_when_the_25h7_file_is_missing(
        rec, monkeypatch, tmp_path):
    codes, grid, mc = _recorded_table(rec, "MIP_25h7")
    _, args, kw = DICT_TABLES["MIP_25h7"]
    d = tdict._generate_mip_style(*args, **kw)
    assert np.array_equal(d.codes, codes) and d.max_correction == mc
    # the registry's branch: the published table only while its file is
    # there
    monkeypatch.setattr(tdict, "_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(tdict, "_REGISTRY", {})
    d = tdict.get_dictionary("ARUCO_MIP_25h7")
    assert np.array_equal(d.codes, codes) and d.name == "ARUCO_MIP_25h7"


@pytest.mark.parametrize("seed,nbits", [(11, 16), (13, 36)])
def test_batched_draws_equal_one_draw_per_try(seed, nbits):
    """The port's generator draws _DRAW_BATCH tries at once; JAX draws one
    rng.integers(0, 2, size=nbits) per try. The two streams are equal over
    the 200 000 tries of the try cap."""
    one = np.random.default_rng(seed)
    per_try = np.stack([one.integers(0, 2, size=nbits)
                        for _ in range(200000)])
    batched = np.random.default_rng(seed)
    got = np.concatenate([
        batched.integers(0, 2, size=(min(tdict._DRAW_BATCH, 200000 - k),
                                     nbits))
        for k in range(0, 200000, tdict._DRAW_BATCH)])
    assert np.array_equal(got, per_try)


def test_generator_helpers_match_jax():
    rng = np.random.default_rng(5)
    for grid in (4, 5, 6):
        accepted = list(rng.integers(0, 2, (12, grid * grid)).astype(
            np.uint8))
        for code in rng.integers(0, 2, (20, grid * grid)).astype(np.uint8):
            for acc in (accepted, []):
                assert (tdict._min_rot_distance(code, grid, acc)
                        == jdict._min_rot_distance(code, grid, acc))
        # the packed-word distances of the batched generator
        codes = rng.integers(0, 2, (30, grid * grid)).astype(np.uint8)
        rots = tdict._packed_rotations(codes, grid)
        acc_rots = tdict._packed_rotations(np.stack(accepted), grid)
        all_rots = [tdict._rotate_code(a, grid, r) for a in accepted
                    for r in range(4)]
        want = [jdict._min_rot_distance(c, grid, all_rots) for c in codes]
        self_d = tdict._popcount(rots[:, :1] ^ rots[:, 1:]).min(axis=1)
        got = np.minimum(self_d, tdict._min_distance_to(
            rots, acc_rots.reshape(-1), below=0))
        assert got.tolist() == want
    for w in range(64):
        assert (tdict._word_transitions(w, 6)
                == jdict._word_transitions(w, 6))
    words = rng.integers(0, 2**63, 1000, dtype=np.uint64) * np.uint64(3)
    want = np.asarray([bin(int(x)).count("1") for x in words])
    assert np.array_equal(tdict._popcount(words), want)
    assert np.array_equal(tdict._popcount_swar(words), want)
    codes = rng.integers(0, 2, (7, 16))
    a = tdict.Dictionary.from_codes("X", 4, codes, 1)
    b = jdict.Dictionary.from_codes("X", 4, codes, 1)
    assert a.codes.dtype == b.codes.dtype and np.array_equal(a.codes,
                                                             b.codes)
    assert (a.name, a.grid, a.max_correction) == (b.name, b.grid,
                                                  b.max_correction)


def _dict_cfg(dict_name):
    jcfg, _, _, _ = _full_setup()
    cfg = tconfig.SlamConfig.from_dict(dataclasses.asdict(jcfg))
    return cfg.replace(aruco=dataclasses.replace(cfg.aruco,
                                                 dictionary=dict_name))


def _decoded(ids, corners, valid):
    return {int(i): np.asarray(c, np.float64)
            for i, c, v in zip(ids, corners, valid) if v}


@pytest.mark.parametrize("dict_name", sorted(DICT_SCENES))
def test_generated_dictionary_worlds_decode_as_in_jax(dict_name, rec):
    """The port renders the recorded frame bit for bit, and its
    detect_markers and make_frame at the bench settings decode JAX's ids,
    corners within CORNER_TOL_PX."""
    _, world_kw, _, _ = _full_setup()
    cfg = _dict_cfg(dict_name)
    (img,), _ = render_frames(tsyn, dict(world_kw,
                                         marker_ids=DICT_SCENES[dict_name]),
                              cfg.camera, [DICT_POSE], dict_name)
    assert np.array_equal(img, rec[f"{dict_name}_frame"])
    want = _decoded(rec[f"{dict_name}_ids"], rec[f"{dict_name}_corners"],
                    rec[f"{dict_name}_valid"])
    assert set(DICT_SCENES[dict_name]) <= set(want)
    acfg = cfg.aruco
    det = tdet.detect_markers(
        _t(img.astype(np.float32)), dict_name,
        max_quads=acfg.max_quad_candidates,
        adaptive_win=acfg.adaptive_thresh_win,
        adaptive_c=acfg.adaptive_thresh_c,
        min_area=acfg.min_quad_side_px**2, cell_px=acfg.warp_cell_px,
        cc_iters=acfg.cc_iters, downsample=acfg.detect_downsample,
        refine=True, use_pallas_cc=acfg.use_pallas_cc)
    np.testing.assert_array_equal(_n(det.ids), rec[f"{dict_name}_ids"])
    got = _decoded(_n(det.ids), _n(det.corners), _n(det.valid))
    frame = tfrontend.make_frame(_t(img), tcam.camera_from_config(
        cfg.camera), cfg)
    via_frame = _decoded(_n(frame.mk_ids), _n(frame.mk_corners),
                         _n(frame.mk_valid))
    for found in (got, via_frame):
        assert found.keys() == want.keys()
        for i, c in want.items():
            assert np.abs(found[i] - c).max() <= CORNER_TOL_PX, i


def test_the_port_needs_nothing_of_the_jax_package():
    """In a process where `jax` and `orb_slam2_aruco_tpu` cannot be
    imported: all seven dictionaries load from the port's own files and
    generators, and make_frame decodes the recorded 16h3 frame."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["orb_slam2_aruco_tpu"] = None
import os, dataclasses, json
import numpy as np
import torch
from orb_slam2_aruco_tpu_torch.config import SlamConfig
from orb_slam2_aruco_tpu_torch.geometry.camera import camera_from_config
from orb_slam2_aruco_tpu_torch.ops.aruco import dictionary
from orb_slam2_aruco_tpu_torch.pipeline.frontend import make_frame
pkg = os.path.dirname(os.path.abspath(
    sys.modules["orb_slam2_aruco_tpu_torch"].__file__))
assert os.path.commonpath([dictionary._DATA_DIR, pkg]) == pkg
for name in ("ARUCO", "ARUCO_MIP_36h12", "ARUCO_MIP_25h7", "TPU_25h7",
             "TPU_16h5", "ARUCO_MIP_16h3", "TPU_36h12"):
    assert dictionary.get_dictionary(name).num_ids > 0
with np.load(os.path.join(pkg, "data", "ref_full.npz")) as z:
    cfg = SlamConfig.from_dict(json.loads(str(z["ref_cfg"])))
with np.load(os.path.join(pkg, "data", "ref_dicts.npz")) as z:
    img, ids, valid = (z["ARUCO_MIP_16h3_" + k]
                       for k in ("frame", "ids", "valid"))
cfg = cfg.replace(aruco=dataclasses.replace(cfg.aruco,
                                            dictionary="ARUCO_MIP_16h3"))
torch.set_num_threads(1)
f = make_frame(torch.as_tensor(img), camera_from_config(cfg.camera), cfg)
got = sorted(int(i) for i in f.mk_ids[f.mk_valid])
assert got == sorted(int(i) for i in ids[valid]), got
bad = [m for m in sys.modules if sys.modules[m] is not None and (
    m == "jax" or m.startswith("jax.") or m == "orb_slam2_aruco_tpu"
    or m.startswith("orb_slam2_aruco_tpu."))]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


# ---------------------------------------------------------------------------
# ORB, image and FAST per-frame functions
# ---------------------------------------------------------------------------


def _angle_diff(a, b):
    return np.abs((np.asarray(a, np.float64) - b + np.pi) % (2 * np.pi)
                  - np.pi)


def test_orientation_map_matches_jax(small_img):
    img = small_img[40:140, 60:220]
    got = _n(torb.orientation_map(_t(img)))
    want = np.asarray(jorb.orientation_map(jnp.asarray(img)))
    kx, ky = jorb._moment_kernels()
    m10 = np.asarray(jimage._conv2d_single(jnp.asarray(img), kx))
    m01 = np.asarray(jimage._conv2d_single(jnp.asarray(img), ky))
    mag = np.hypot(m10, m01)
    strong = mag > 1e-3 * mag.max()
    assert got.shape == want.shape and got.dtype == np.float32
    assert strong.mean() > 0.9
    assert _angle_diff(got, want)[strong].max() <= 1e-4


@pytest.mark.parametrize("blur", [False, True])
def test_keypoint_angles_and_describe_match_jax(small_img, blur):
    img = np.asarray(jimage.gaussian_blur(jnp.asarray(small_img))) \
        if blur else small_img
    rng = np.random.default_rng(12)
    # interior and border-clipped keypoints
    xy = rng.uniform(-4, [324, 244], (300, 2)).astype(np.float32)
    aj = np.asarray(jorb.keypoint_angles(jnp.asarray(img), jnp.asarray(xy)))
    at = _n(torb.keypoint_angles(_t(img), _t(xy)))
    patches = np.asarray(jorb.extract_patches(jnp.asarray(img),
                                              jnp.asarray(xy)))
    kx, ky = jorb._moment_kernels_patch32()
    flat = patches.reshape(len(xy), -1).astype(np.float64)
    mag = np.hypot(flat @ kx, flat @ ky)
    strong = mag > 1e-3 * mag.max()
    assert strong.mean() > 0.9
    assert _angle_diff(at, aj)[strong].max() <= 1e-4
    # describe on JAX's angles: the describe_patches test's limit
    dj = np.asarray(jorb.describe(jnp.asarray(img), jnp.asarray(xy),
                                  jnp.asarray(aj))).view(np.int32)
    dt = _n(torb.describe(_t(img), _t(xy), _t(aj)))
    assert dt.dtype == np.int32 and dt.shape == dj.shape
    assert (dj == dt).all(axis=1).mean() >= 0.99


def test_hamming_popcount_matches_jax_and_the_matcher():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2**32, (37, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (23, 8), dtype=np.uint64).astype(np.uint32)
    b[:3] = a[:3]                                   # zero distances
    b[3] = ~a[3]                                    # 256
    want = np.asarray(jorb.hamming_popcount(jnp.asarray(a), jnp.asarray(b)))
    got = torb.hamming_popcount(_t(a.view(np.int32)), _t(b.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_n(got), want)
    assert want[0, 0] == 0 and want[3, 3] == 256
    mask = _t(rng.uniform(size=37) < 0.8)
    d = tmatching.distance_matrix(_t(a.view(np.int32)),
                                  _t(b.view(np.int32)), mask_a=mask)
    np.testing.assert_array_equal(_n(d)[_n(mask)],
                                  want[_n(mask)].astype(np.float32))


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.bfloat16])
def test_unpack_pm1_dtype(dtype):
    rng = np.random.default_rng(8)
    p = rng.integers(0, 2**32, (9, 8), dtype=np.uint64).astype(np.uint32)
    jdt = jnp.bfloat16 if dtype is torch.bfloat16 else jnp.float32
    want = np.asarray(jorb.unpack_pm1(jnp.asarray(p), dtype=jdt),
                      np.float32)
    got = (torb.unpack_pm1(_t(p.view(np.int32))) if dtype is None
           else torb.unpack_pm1(_t(p.view(np.int32)), dtype=dtype))
    assert got.dtype == (dtype or torch.float32)
    np.testing.assert_array_equal(_n(got.float()), want)


@pytest.mark.parametrize("ksize,sigma", [(7, 2.0), (5, 1.0), (9, 1.6)])
def test_gaussian_kernel1d_is_bit_equal(ksize, sigma):
    got = timage.gaussian_kernel1d(ksize, sigma)
    want = np.asarray(jimage.gaussian_kernel1d(ksize, sigma))
    assert got.dtype == torch.float32
    assert np.array_equal(_n(got), want)


@pytest.mark.parametrize("shape", [(31, 47, 3), (31, 47)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_to_gray_matches_jax(shape, dtype):
    img = np.random.default_rng(9).uniform(0, 255, shape).astype(dtype)
    got = _n(timage.to_gray(_t(img)))
    want = np.asarray(jimage.to_gray(jnp.asarray(img)))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _same_nonzero_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", ["random_61x133", "rendered"])
def test_xla_fast_route_matches_jax(case, small_img):
    if case == "rendered":
        img = small_img
    else:
        img = np.round(np.random.default_rng(1).uniform(
            0, 255, (61, 133))).astype(np.float32)
    for t in (20.0, 7.0):
        got = _n(tfast.fast_score_map(_t(img), t))
        want = np.asarray(jfast.fast_score_map(jnp.asarray(img), t))
        _same_nonzero_close(got, want)
        assert (got > 0).sum() > 10
        _same_nonzero_close(_n(tfast.nms3x3(_t(got))),
                            np.asarray(jfast.nms3x3(jnp.asarray(want))))


@pytest.mark.parametrize("use_pallas", [False, True, None])
def test_detect_level_routes_match_jax(use_pallas, small_img):
    """False: the XLA route on both sides; True: K1's plain version against
    JAX's Pallas kernel in interpret mode; None: the K1 route, as True."""
    args = (20.0, 7.0, 32, 8, 150, 16)
    got = tfast.detect_level(_t(small_img), *args, use_pallas=use_pallas)
    want = jfast.detect_level(jnp.asarray(small_img), *args,
                              use_pallas=use_pallas is not False)
    assert int(_n(got.valid).sum()) > 50
    np.testing.assert_array_equal(_n(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(_n(got.xy), np.asarray(want.xy))
    if use_pallas is False:
        np.testing.assert_allclose(_n(got.score), np.asarray(want.score),
                                   rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(_n(got.score), np.asarray(want.score))
    with pytest.raises(ValueError, match="precomputed score"):
        tfast.detect_level(_t(small_img), *args, use_pallas=False,
                           score=torch.zeros(small_img.shape))


# ---------------------------------------------------------------------------
# geometry, optimizer and synthetic helpers, configuration, exports
# ---------------------------------------------------------------------------


def test_depth_in_cam_and_camera_K_are_bit_equal():
    rng = np.random.default_rng(10)
    R = rng.normal(size=(5, 3, 3)).astype(np.float32)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    X = rng.normal(size=(5, 3)).astype(np.float32) * 4
    want = np.asarray(jtri.depth_in_cam(jnp.asarray(R), jnp.asarray(t),
                                        jnp.asarray(X)))
    assert np.array_equal(_n(ttri.depth_in_cam(_t(R), _t(t), _t(X))), want)
    camc = SETUPS["full"]()[0].camera
    want = np.asarray(jcam.camera_from_config(camc).K)
    got = _n(tcam.camera_from_config(tconfig.CameraConfig(
        **dataclasses.asdict(camc))).K)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    f = rng.uniform(100, 900, (4,)).astype(np.float32)
    jc = jcam.Camera(*(jnp.asarray(f + k) for k in range(4)),
                     jnp.zeros(5), 10, 10)
    tc = tcam.Camera(*(_t(f + k) for k in range(4)), torch.zeros(5), 10, 10)
    assert np.array_equal(_n(tc.K), np.asarray(jc.K))


@pytest.mark.parametrize("n", [3, 6])
def test_small_spd_solve_matches_jax(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(64, n, n))
    H = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(64, n)).astype(np.float32)
    want = np.asarray(jlm.small_spd_solve(jnp.asarray(H), jnp.asarray(b)))
    got = _n(tlm.small_spd_solve(_t(H), _t(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    exact = np.linalg.solve(H.astype(np.float64), b[..., None])[..., 0]
    np.testing.assert_allclose(got, exact, rtol=1e-3,
                               atol=1e-3 * np.abs(exact).max())


def test_ba_solve_without_huber_matches_jax():
    rng = np.random.default_rng(3)
    prob, cam = _ba_problem(rng)
    jc = jcam.Camera(**{k: (jnp.float32(v) if k in ("fx", "fy", "cx", "cy")
                            else v) for k, v in cam.items()})
    tc = tcam.camera_from_numpy(cam)
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()})
    pt = tba.BAProblem(**{k: _t(v) for k, v in prob.items()})
    oj = jba.ba_solve(pj, jc, iters=10, lam0=1e-4, use_huber=False)
    ot = tba.ba_solve(pt, tc, iters=10, lam0=1e-4, use_huber=False)
    huber = tba.ba_solve(pt, tc, iters=10, lam0=1e-4)
    assert float(oj.chi2) < 0.5 * float(jba._total_chi2(pj, jc)[0])
    assert not torch.equal(ot.points, huber.points)   # the flag is used
    np.testing.assert_allclose(float(ot.chi2), float(oj.chi2), rtol=1e-3)
    _close(ot.Rcw, oj.Rcw, atol=1e-3, rtol=0)
    _close(ot.tcw, oj.tcw, atol=1e-3, rtol=0)
    _close(ot.twm, oj.twm, atol=1e-3, rtol=0)
    _close(ot.points, oj.points, atol=1e-3, rtol=0)
    # the edge terms' weights: 1 without Huber
    for jfn, tfn in ((jba._point_edge_terms, tba._point_edge_terms),
                     (jba._marker_edge_terms, tba._marker_edge_terms)):
        wj = np.asarray(jfn(pj, jc, 2.4477, use_huber=False)[3])
        wt = _n(tfn(pt, tc, 2.4477, use_huber=False)[3])
        np.testing.assert_allclose(wt, wj, rtol=1e-6, atol=0)


def test_synthetic_helpers_and_default_config_are_bit_equal():
    for kw in ({}, dict(center_xy=(0.2, 0.1), distance=1.5, radius=0.3,
                        max_yaw=0.1)):
        for n in (0, 1, 7):
            want = jsyn.orbit_trajectory(n, **kw)
            got = tsyn.orbit_trajectory(n, **kw)
            assert len(got) == len(want) == n
            for (Rt, tt), (Rj, tj) in zip(got, want):
                assert Rt.dtype == Rj.dtype and np.array_equal(Rt, Rj)
                assert np.array_equal(tt, tj)
    wj = jsyn.build_world([3, 17, 42], px_per_m=100.0)
    wt = tsyn.build_world([3, 17, 42], px_per_m=100.0)
    for sj, st in zip(wj.markers, wt.markers):
        for a, b in zip(wt.marker_pose_world(st), wj.marker_pose_world(sj)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (dataclasses.asdict(tconfig.default_config())
            == dataclasses.asdict(jconfig.default_config()))


def test_both_clis_take_a_generated_dictionary(tmp_path):
    from orb_slam2_aruco_tpu_torch.examples import mono_synthetic, mono_video

    world = mono_synthetic.make_world("ARUCO_MIP_16h3", 0.165)
    assert [m.marker_id for m in world.markers] == [3, 17, 7, 23]
    for name in ("ARUCO", "TPU_36h12"):
        assert len(mono_synthetic.make_world(name, 0.165).markers) == 8
    args = mono_video.parse_args(["--images", str(tmp_path), "--camera",
                                  "c.yml", "--dict", "ARUCO_MIP_16h3"])
    cfg = mono_video.make_config(tconfig.CameraConfig(), args)
    assert cfg.aruco.dictionary == "ARUCO_MIP_16h3"
    assert tdict.get_dictionary(cfg.aruco.dictionary).name == "TPU_16h5"


SUBPACKAGES = ["geometry", "io", "ops", "ops/aruco", "optim", "parallel",
               "pipeline", "utils", "viz", "worldmap"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackages_export_the_jax_names(sub):
    import importlib

    mod = importlib.import_module("orb_slam2_aruco_tpu_torch."
                                  + sub.replace("/", "."))
    want = _imported_names(os.path.join(JAX_PKG, sub, "__init__.py"))
    assert want
    for name in want:
        assert hasattr(mod, name), name


# ---------------------------------------------------------------------------
# the native quad proposer: built at first use when the library is missing
# ---------------------------------------------------------------------------


def test_native_library_builds_at_first_use(tmp_path, monkeypatch, rec):
    """With the committed native/libquadfind.so out of reach, the binding
    builds native/quadfind.cpp into its build directory (here tmp_path,
    never native/) and its quads equal the committed library's."""
    if not jnative.available():
        pytest.skip("the committed native library does not load here")
    frames = [rec[f"{d}_frame"].astype(np.float32) for d in DICT_SCENES]
    # the 270x480 binaries of the quad proposal, as images
    binaries = [255.0 * _n(tdet.downsample_majority(
        tdet.adaptive_threshold(_t(f)), 2)).astype(np.float32)
        for f in frames]
    want = [tnative.find_quads_native(im) for im in frames + binaries]
    assert all(len(q) >= 8 for q in want[:len(frames)])
    missing = tmp_path / "native" / "libquadfind.so"
    monkeypatch.setattr(tnative, "_LIB_PATH", str(missing))
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "build"))
    tnative._load.cache_clear()
    try:
        assert tnative.available()
        built = os.listdir(tmp_path / "build")
        assert len(built) == 1 and built[0].startswith("libquadfind-")
        assert not missing.exists()
        for im, q in zip(frames + binaries, want):
            np.testing.assert_array_equal(tnative.find_quads_native(im), q)
    finally:
        monkeypatch.undo()
        tnative._load.cache_clear()
    assert tnative.available()


# ---------------------------------------------------------------------------
# name by name: every public name and parameter of the JAX package
# ---------------------------------------------------------------------------

# the port's departures by design (ROADMAP.md C1): the Pallas kernels'
# modules (their kernels are kernels/csrc/*.cu), JAX's mesh axis names and
# shard_map reduction options (the port's mesh is a device list), and the
# Pallas interpret switch (the plain versions run on CPU tensors)
DEPARTURES = {
    "ops/pallas_fast.py", "ops/pallas_patches.py", "ops/pallas_cc.py",
    "ops/pallas_cc_fused.py",
    "optim/ba.py: ba_solve(psum_axis)",
    "optim/ba.py: ba_solve(edges_by_point)",
    "parallel/dist_ba.py: make_mesh(axis)",
    "ops/aruco/detector.py: quad_candidates_fused(interpret)",
}


# the port's default values that depart from JAX's by design (ROADMAP.md
# C1): dtype defaults equal in value, float32 where JAX picks bf16 for the
# MXU (their values are +-1 and 0/1, exact in both)
DEFAULT_DEPARTURES = {
    "ops/orb.py: unpack_pm1(dtype)",
    "worldmap/covisibility.py: incidence_matrix(dtype)",
}


def _params(fn):
    """{parameter: its default as source text, None where it has none}."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = dict.fromkeys(x.arg for x in pos + a.kwonlyargs)
    for x, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        out[x.arg] = ast.unparse(d)
    for x, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            out[x.arg] = ast.unparse(d)
    return out


def _public_defs(path):
    """{name: {parameter: default} or None} of a module's public top-level
    functions, classes, class methods and fields, and assignments; a
    class field with a default is {"": its default}."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    out[f"{node.name}.{m.name}"] = _params(m)
                elif (isinstance(m, ast.AnnAssign)
                      and isinstance(m.target, ast.Name)):
                    out[f"{node.name}.{m.target.id}"] = (
                        None if m.value is None
                        else {"": ast.unparse(m.value)})
        elif isinstance(node, ast.Assign):
            for tg in node.targets:
                if isinstance(tg, ast.Name):
                    out[tg.id] = None
    return {k: v for k, v in out.items()
            if not any(p.startswith("_") and not p.startswith("__")
                       for p in k.split("."))}


def _imported_names(path):
    """The public names a package's __init__.py imports."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name for a in node.names}
    return sorted(n for n in names if not n.startswith("_"))


def missing_names():
    """What the port lacks of each JAX module's public names and
    parameters, departures excepted."""
    out = []
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), JAX_PKG)
            if rel in DEPARTURES:
                continue
            port = os.path.join(PORT_PKG, rel)
            if not os.path.exists(port):
                out.append(f"{rel}: no port module")
                continue
            mine = _public_defs(port)
            for name, params in _public_defs(os.path.join(JAX_PKG,
                                                          rel)).items():
                if name not in mine:
                    out.append(f"{rel}: {name}")
                    continue
                for p in params or []:
                    if p and p not in (mine[name] or []) and (
                            f"{rel}: {name}({p})" not in DEPARTURES):
                        out.append(f"{rel}: {name}({p})")
            if f == "__init__.py":
                have = set(_imported_names(port)) | set(mine)
                out += [f"{rel}: import {n}"
                        for n in _imported_names(os.path.join(JAX_PKG, rel))
                        if n not in have]
    return sorted(out)


def _as_torch(src):
    """A default's source text with JAX's dtype names as torch's
    (jnp.float32 -> torch.float32, jnp.bfloat16 -> torch.bfloat16, ...)."""
    return None if src is None else re.sub(r"\bjnp\.", "torch.", src)


def differing_defaults():
    """Every parameter default and class-field default of a JAX module that
    its port module gives another value (a port parameter without the
    JAX default, or with one JAX lacks, differs too), departures
    excepted."""
    out = []
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), JAX_PKG)
            port = os.path.join(PORT_PKG, rel)
            if not f.endswith(".py") or not os.path.exists(port):
                continue
            mine = _public_defs(port)
            for name, params in _public_defs(os.path.join(JAX_PKG,
                                                          rel)).items():
                if name not in mine:
                    continue
                for p, want in (params or {}).items():
                    # a parameter the port lacks is missing_names' finding;
                    # a field default it lacks is a differing default
                    got = (mine[name] or {}).get(p, want if p else None)
                    key = f"{rel}: {name}({p})" if p else f"{rel}: {name}"
                    if (_as_torch(got) != _as_torch(want)
                            and key not in DEFAULT_DEPARTURES):
                        out.append(f"{key}: JAX {want}, port {got}")
    return sorted(out)


def cli_arguments(path):
    """{flag: its argparse default as source text, None where it has none}
    of every add_argument call in a CLI's source."""
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flag = [a.value for a in node.args
                    if isinstance(a, ast.Constant)][-1]
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
            out[flag] = kw.get("default")
    return out


def test_the_port_has_every_public_name_of_the_jax_package():
    assert missing_names() == []


def test_the_ports_defaults_are_the_jax_packages():
    """Every parameter default and config field default equal to JAX's
    (dtypes mapped jnp -> torch), DEFAULT_DEPARTURES excepted; each
    departure still has a default of its own, equal in value."""
    assert differing_defaults() == []
    for key in DEFAULT_DEPARTURES:
        rel, call = key.split(": ")
        name, p = call[:-1].split("(")
        want = _public_defs(os.path.join(JAX_PKG, rel))[name][p]
        got = _public_defs(os.path.join(PORT_PKG, rel))[name][p]
        assert (want, got) == ("jnp.bfloat16", "torch.float32"), key
    assert _public_defs(os.path.join(
        PORT_PKG, "pipeline", "mapping.py"))["create_keyframe"]["slot"] == (
            "None")


@pytest.mark.parametrize("cli", ["mono_synthetic.py", "mono_video.py"])
def test_the_port_clis_take_the_jax_clis_arguments_and_defaults(cli):
    """Every flag of the JAX example (root examples/) is a flag of the
    port's, with the same default (--out: /tmp/trajectory.tum; --cpu is
    the port's --device cpu); the port adds only --device."""
    want = cli_arguments(os.path.join(REPO, "examples", cli))
    got = cli_arguments(os.path.join(PORT_PKG, "examples", cli))
    assert {k: got.get(k, "absent") for k in want} == want
    assert set(got) - set(want) == {"--device"}
    assert want["--out"] == "'/tmp/trajectory.tum'"


if __name__ == "__main__":
    # prints every public name or parameter of the JAX package the port
    # lacks and every default it gives another value (nothing when there
    # is none)
    for line in missing_names() + differing_defaults():
        print(line)
