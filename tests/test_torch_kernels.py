"""Three of the port's kernels against the JAX package's Pallas kernels (K4
is held to its Pallas kernel in tests/test_torch_cc.py).

On the CPU the port runs each kernel's plain PyTorch version
(`fast_score_nms_torch`, `extract_patches_torch`, `cc_fused_torch`); they
are held to the Pallas kernels in interpret mode, as tests/test_ops.py and
tests/test_pallas_cc.py run them:

  K1 FAST score + NMS: exact in rows/cols [3, H-3) x [3, W-3), where the
     Pallas kernel and the XLA branch of ops/fast.py also agree, one level
     or all eight at once (fast_score_nms_levels, the kernel's per-frame
     form);
  K2 patches: exact, one level or all eight at once (extract_patches_levels,
     the kernel's per-frame form), with the JAX package's corner rounding
     (half to even) and clipping;
  K3 connected components + bboxes: lab, bw, bh and Wp exactly equal,
     including on a blob that does not converge in 3 rounds.

The hand-written CUDA kernels are held to the plain versions by
tests/test_torch_cuda.py (on a GPU) and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu.ops import fast as jfast
from orb_slam2_aruco_tpu.ops import orb as jorb
from orb_slam2_aruco_tpu.ops.pallas_cc_fused import cc_fused as jcc_fused
from orb_slam2_aruco_tpu.ops.pallas_fast import fast_score_nms as jfast_nms
from orb_slam2_aruco_tpu.ops.pallas_patches import extract_patches_pallas
from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.ops import cc_fused, cc_propagate, fast, orb

from test_torch_cuda import T_HI, T_LO, rendered_level, rings, spiral


def _xla_fast(img):
    """The XLA branch of ops/fast.detect_level (fast.py:123-127)."""
    s_high, s_low = jfast._fast_scores(jnp.asarray(img), [T_HI, T_LO])
    s = jfast.nms3x3(s_low)
    return np.asarray(jnp.where((s > 0) & (s_high > 0), s + 1e6, s))


@pytest.mark.parametrize("case", ["random_61x133", "random_64x128",
                                  "random_45x300", "rendered_151x203"])
def test_fast_plain_matches_pallas_and_xla(case):
    rng = np.random.default_rng(1)
    if case == "rendered_151x203":
        img = rendered_level().astype(np.float32)
    else:
        h, w = (int(v) for v in case.split("_")[1].split("x"))
        img = np.round(rng.uniform(0, 255, (h, w))).astype(np.float32)
    plain = fast.fast_score_nms_torch(torch.as_tensor(img), T_HI, T_LO)
    plain = plain.numpy()
    pallas = np.asarray(jfast_nms(jnp.asarray(img), T_HI, T_LO,
                                  interpret=True))
    xla = _xla_fast(img)
    inner = (slice(3, -3), slice(3, -3))
    # exact, no tolerance: same circle order, same float32 operations
    np.testing.assert_array_equal(plain[inner], pallas[inner])
    np.testing.assert_array_equal(plain[inner], xla[inner])
    assert (plain[inner] > 0).sum() > 10          # corners were found
    assert (plain[inner] > 1e6).sum() > 0         # and high-threshold ones


def test_fast_levels_plain_matches_pallas_on_every_level():
    from orb_slam2_aruco_tpu_torch.ops import image

    levels = image.build_pyramid(
        torch.as_tensor(rendered_level().astype(np.float32)), 8, 1.2)
    got = fast.fast_score_nms_levels(levels, T_HI, T_LO)
    assert [tuple(g.shape) for g in got] == [tuple(l.shape) for l in levels]
    assert levels[-1].shape[1] < 60                  # down to the 8th level
    for lvl, mine in zip(levels, got):
        pallas = np.asarray(jfast_nms(jnp.asarray(lvl.numpy()), T_HI, T_LO,
                                      interpret=True))
        inner = (slice(3, -3), slice(3, -3))
        # exact, no tolerance: same circle order, same float32 operations
        np.testing.assert_array_equal(mine.numpy()[inner], pallas[inner])
    assert sum(int((g > 0).sum()) for g in got) > 20


def test_detect_level_takes_a_precomputed_score():
    img = torch.as_tensor(rendered_level().astype(np.float32))
    score = fast.fast_score_nms_levels([img], T_HI, T_LO)[0]
    want = fast.detect_level(img, T_HI, T_LO, 32, 8, 64, 16)
    got = fast.detect_level(img, T_HI, T_LO, 32, 8, 64, 16, score=score)
    assert int(want.valid.sum()) > 10
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_patches_plain_matches_pallas_and_dynamic_slice():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (123, 217)).astype(np.float32)
    # aligned, unaligned and border-clipped corners
    y0 = np.concatenate([[0, 8, 91, 90], rng.integers(0, 123 - 32, 28)])
    x0 = np.concatenate([[0, 128, 185, 1], rng.integers(0, 217 - 32, 28)])
    y0, x0 = y0.astype(np.int32), x0.astype(np.int32)
    plain = orb.extract_patches_torch(torch.as_tensor(img),
                                      torch.as_tensor(y0),
                                      torch.as_tensor(x0)).numpy()
    pallas = np.asarray(extract_patches_pallas(
        jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0), interpret=True))
    ref = np.stack([np.asarray(jax.lax.dynamic_slice(
        jnp.asarray(img), (int(y), int(x)), (32, 32))) for y, x in zip(y0, x0)])
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, ref)


def _jax_corners(img, xy):
    """The JAX package's corners (ops/orb.py extract_patches)."""
    h, w = img.shape
    x0 = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32) - 16, 0, w - 32)
    y0 = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32) - 16, 0, h - 32)
    return y0, x0


def _levels_and_keypoints(n_levels):
    """The first n_levels pyramid levels of a rendered frame (widths 203,
    169, 141, ..., 57), blurred, and their FAST keypoints at ORB quotas."""
    from orb_slam2_aruco_tpu_torch.ops import image
    from orb_slam2_aruco_tpu_torch.pipeline.frontend import level_quotas

    levels = image.build_pyramid(
        torch.as_tensor(rendered_level().astype(np.float32)), 8, 1.2)
    quotas = level_quotas(160, 8, 1.2)
    blurred, xys = [], []
    for lvl, q in list(zip(levels, quotas))[:n_levels]:
        kp = fast.detect_level(lvl, T_HI, T_LO, 32, 8, q, 16)
        blurred.append(image.gaussian_blur(lvl))
        xys.append(kp.xy)
    return blurred, xys


@pytest.mark.parametrize("n_levels", [1, 8])
def test_patches_levels_plain_matches_pallas_and_dynamic_slice(n_levels):
    blurred, xys = _levels_and_keypoints(n_levels)
    got = orb.extract_patches_levels(blurred, xys).numpy()
    assert got.shape == (sum(xy.shape[0] for xy in xys), 32, 32)
    start = 0
    for lvl, xy in zip(blurred, xys):
        img, jxy = jnp.asarray(lvl.numpy()), jnp.asarray(xy.numpy())
        mine = got[start:start + xy.shape[0]]
        start += xy.shape[0]
        y0, x0 = _jax_corners(img, jxy)
        pallas = extract_patches_pallas(img, y0, x0, interpret=True)
        # exact, no tolerance: the same pixels are copied
        np.testing.assert_array_equal(mine, np.asarray(pallas))
        np.testing.assert_array_equal(mine, np.asarray(
            jorb.extract_patches(img, jxy)))       # dynamic_slice on the CPU


def test_patch_corners_round_half_to_even_and_clip_at_every_edge():
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 255, (57, 81)).astype(np.float32)
    h, w = img.shape
    # .5 steps either side of even and odd integers, and keypoints past
    # each edge and each corner
    xy = np.array([[16.5, 16.5], [17.5, 17.5], [20.5, 21.5], [-0.5, 30.0],
                   [-40.0, 30.0], [w + 40.0, 30.0], [w - 16.5, 30.0],
                   [40.0, -3.0], [40.0, h + 9.0], [40.0, h - 15.5],
                   [-9.0, -9.0], [w + 3.0, h + 3.0], [-2.5, h + 0.5],
                   [w - 0.5, -1.5]], np.float32)
    got = orb.extract_patches_levels([torch.as_tensor(img)],
                                     [torch.as_tensor(xy)]).numpy()
    y0, x0 = _jax_corners(jnp.asarray(img), jnp.asarray(xy))
    assert sorted(set(np.asarray(x0).tolist()) & {0, w - 32}) == [0, w - 32]
    assert sorted(set(np.asarray(y0).tolist()) & {0, h - 32}) == [0, h - 32]
    assert np.asarray(x0)[:2].tolist() == [0, 2]      # 16.5 -> 16, 17.5 -> 18
    np.testing.assert_array_equal(got, np.asarray(extract_patches_pallas(
        jnp.asarray(img), y0, x0, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jorb.extract_patches(
        jnp.asarray(img), jnp.asarray(xy))))


@pytest.mark.parametrize("case", ["random_blobs", "marker_rings", "spiral"])
def test_cc_plain_matches_pallas(case):
    rng = np.random.default_rng(3)
    if case == "random_blobs":
        binary = rng.uniform(size=(45, 150)) < 0.45
    elif case == "marker_rings":
        binary = rings(rng, 70, 140)
    else:
        binary = spiral()
    lab, bw, bh, Wp = cc_fused.cc_fused_torch(torch.as_tensor(binary))
    jlab, jbw, jbh, jWp = jcc_fused(jnp.asarray(binary), interpret=True)
    assert Wp == jWp
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(bw.numpy(), np.asarray(jbw))
    np.testing.assert_array_equal(bh.numpy(), np.asarray(jbh))
    if case == "spiral":
        # one connected blob, still several labels after 3 rounds
        assert len(np.unique(lab.numpy()[binary])) > 1


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(4)
    img = torch.as_tensor(rng.uniform(0, 255, (40, 70)).astype(np.float32))
    before = dict(kernels.launch_counts)
    assert torch.equal(fast.fast_score_nms(img, T_HI, T_LO),
                       fast.fast_score_nms_torch(img, T_HI, T_LO))
    binary = img > 128
    got = cc_fused.cc_fused(binary)
    want = cc_fused.cc_fused_torch(binary)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    xy = torch.tensor([[20.0, 20.0], [50.0, 10.0]])
    y0, x0 = orb.patch_corners(img.shape, xy)
    assert torch.equal(orb.extract_patches(img, xy),
                       orb.extract_patches_torch(img, y0, x0))
    assert torch.equal(orb.extract_patches_levels([img, img[:35]], [xy, xy]),
                       orb.extract_patches_levels_torch([img, img[:35]],
                                                        [xy, xy]))
    assert kernels.launch_counts == before


def test_cuda_bindings_refuse_cpu_tensors():
    """A binding launches its kernel or raises: it never falls back to the
    plain version."""
    img = torch.zeros((40, 70))
    idx = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        fast.fast_score_nms_cuda(img, T_HI, T_LO)
    with pytest.raises(ValueError):
        fast.fast_score_nms_levels_cuda([img, img[:20]], T_HI, T_LO)
    with pytest.raises(ValueError):
        cc_propagate.cc_propagate_cuda(idx.reshape(1, 3), 1, 16, 128)
    with pytest.raises(ValueError):
        orb.extract_patches_cuda(img, idx, idx)
    with pytest.raises(ValueError):
        orb.extract_patches_levels_cuda([img], [torch.zeros((3, 2))])
    with pytest.raises(ValueError):
        cc_fused.cc_fused_cuda(img > 0)
