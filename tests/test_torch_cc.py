"""The port's unfused quad proposal against the JAX package: kernel K4's
plain version (`cc_propagate_torch`), `connected_components` and both
routes of `quad_candidates`.

K4 is held to the Pallas kernel in interpret mode, bit for bit, on
converging and non-converging inputs. Interpret mode runs the kernel's grid
tiles against the sweep's input (no tile sees another's update within a
sweep); the TPU runs them in order over an aliased buffer, which differs
until labels converge (the one-row case below). The JAX route with
use_pallas_cc=True is run by swapping its K4 for the interpret-mode call
(the JAX package calls K4 without `interpret=`, which the CPU refuses); the
JAX package itself is not changed. The hand-written kernel is held to the
plain version by tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orb_slam2_aruco_tpu.io import synthetic as jsyn
from orb_slam2_aruco_tpu.ops import pallas_cc
from orb_slam2_aruco_tpu.ops.aruco import detector as jdet
from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.ops import cc_propagate
from orb_slam2_aruco_tpu_torch.ops.aruco import detector as tdet

from test_torch_cuda import init_labels, spiral
from test_torch_slice import DATA_DIR, SETUPS, render_frames


def _jax_k4(labels, **kw):
    return np.asarray(pallas_cc.cc_propagate_pallas(
        jnp.asarray(labels), interpret=True, **kw))


def _pallas_cc_fixture():
    """The input of tests/test_pallas_cc.py::test_cc_pallas_matches_xla."""
    rng = np.random.default_rng(0)
    h = w = 128
    img = rng.random((h, w)) < 0.08
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.sqrt((yy - 64) ** 2 + (xx - 64) ** 2)
    img |= (r > 40) & (r < 48)
    img[10:30, 90:118] = True
    return img


# (binary, kwargs): the Pallas test's fixture (converges in 12 passes), a
# spiral after one pass (far from converged) and one foreground row across
# four tiles after one pass, where the TPU's in-order sweep would carry
# label 16 to x = 32 but interpret mode carries x - 8 (24, 56, 88)
K4_CASES = {
    "pallas_cc_fixture": (_pallas_cc_fixture,
                          dict(passes=12, k_steps=16, tile=64)),
    "spiral_one_pass": (lambda: spiral(96),
                        dict(passes=1, k_steps=16, tile=32)),
    "one_row": (lambda: np.pad(np.ones((1, 128), bool), ((3, 4), (0, 0))),
                dict(passes=1, k_steps=8, tile=32)),
    # the quad proposal's tile and steps on a shape that is no tile
    # multiple (one ragged 128x128 tile + halo), two sweeps
    "tile128_61x133": (lambda: np.random.default_rng(11).uniform(
        size=(61, 133)) < 0.45, dict(passes=2, k_steps=16, tile=128)),
}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_cc_propagate_plain_matches_pallas_interpret(case):
    make, kw = K4_CASES[case]
    binary = make()
    labels = init_labels(binary)
    want = _jax_k4(labels, **kw)
    got = cc_propagate.cc_propagate_torch(torch.as_tensor(labels), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "pallas_cc_fixture":
        ref = np.asarray(jdet.connected_components(jnp.asarray(binary),
                                                   iters=400))
        np.testing.assert_array_equal(got.numpy(), ref)   # converged
    if case == "spiral_one_pass":
        assert len(np.unique(got.numpy()[binary])) > 1    # not converged
    if case == "one_row":
        row = 3 * 128
        assert got.numpy()[3, [32, 64, 96]].tolist() == [
            row + 24, row + 56, row + 88]


def test_cc_propagate_dispatch_on_cpu():
    labels = torch.as_tensor(init_labels(spiral(40)))
    before = dict(kernels.launch_counts)
    assert torch.equal(cc_propagate.cc_propagate(labels, 2, 8, 32),
                       cc_propagate.cc_propagate_torch(labels, 2, 8, 32))
    assert kernels.launch_counts == before
    with pytest.raises(ValueError):
        cc_propagate.cc_propagate_cuda(labels, 1, 16, 128)


def test_k4_route_rounds_at_half_resolution(monkeypatch):
    """quad_candidates(use_pallas_cc=True) at the bench's 270x480 binary
    (cc_iters 0 -> 750) runs 7 K4 sweeps, one per round."""
    calls = []
    plain = cc_propagate.cc_propagate_torch

    def counting(labels, passes, k_steps, tile):
        calls.append((tuple(labels.shape), passes, k_steps, tile))
        return plain(labels, passes, k_steps, tile)

    monkeypatch.setattr(tdet, "cc_propagate", counting)
    binary = torch.zeros((270, 480), dtype=torch.bool)
    binary[100:140, 200:240] = True
    _, _, valid = tdet.quad_candidates(binary, 8, min_area=25.0,
                                       use_pallas_cc=True)
    assert calls == [((270, 480), 1, 16, 128)] * 7
    assert int(valid.sum()) == 1


# ---------------------------------------------------------------------------
# connected components and the quad proposal on rendered frames
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def binaries():
    """The adaptive-threshold binary of a ref_small frame at ds 1 and 2."""
    cfg, world, _, loc = SETUPS["small"]()
    img = render_frames(jsyn, world, cfg.camera, loc[:1])[0][0]
    b = np.array(jdet.adaptive_threshold(jnp.asarray(
        img.astype(np.float32))))
    h, w = b.shape
    return {1: b, 2: b.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3)) * 2 >= 4}


def test_seg_cummin_int64_key():
    """At 2 x 33000 the packed run key exceeds int32 and the port switches
    to int64 (the JAX package, without x64, cannot: ROADMAP §3 C2): every
    foreground run still gets its minimum label."""
    rng = np.random.default_rng(9)
    h, w = 2, 33000
    fg = rng.uniform(size=(h, w)) < 0.7
    lab = np.where(fg, rng.integers(0, h * w, (h, w)), h * w)
    got = tdet._seg_cummin_axis(torch.as_tensor(lab, dtype=torch.int32),
                                torch.as_tensor(fg), h * w, axis=1).numpy()
    want = lab.copy()
    for y in range(h):
        edges = np.flatnonzero(np.diff(np.r_[0, fg[y].astype(int), 0]))
        for a, b in zip(edges[::2], edges[1::2]):
            want[y, a:b] = lab[y, a:b].min()
    assert (w - 1) * (h * w + 1) + h * w > 2**31 - 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ds", [1, 2])
def test_connected_components_matches_jax(binaries, ds):
    b = binaries[ds]
    for rounds in (4, None):
        want = np.asarray(jdet.connected_components(jnp.asarray(b), iters=40,
                                                    rounds=rounds))
        got = tdet.connected_components(torch.as_tensor(b), iters=40,
                                        rounds=rounds)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("route", ["xla_cc", "k4"])
@pytest.mark.parametrize("ds", [1, 2])
def test_quad_candidates_match_jax(binaries, monkeypatch, ds, route):
    b = binaries[ds]
    use_k4 = route == "k4"
    if use_k4:
        monkeypatch.setattr(pallas_cc, "cc_propagate_pallas", functools.
                            partial(pallas_cc.cc_propagate_pallas,
                                    interpret=True))
    qj, sj, vj = (np.asarray(a) for a in jdet.quad_candidates(
        jnp.asarray(b), 64, min_area=100.0 / ds**2, use_pallas_cc=use_k4))
    qt, st, vt = tdet.quad_candidates(torch.as_tensor(b), 64,
                                      min_area=100.0 / ds**2,
                                      use_pallas_cc=use_k4)
    # exact: integer labels, areas and extremal pixels
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(qt.numpy()[vj], qj[vj])
    assert vj.sum() >= 4


def test_k4_quads_match_the_recording():
    """The port's K4 route against the JAX outputs recorded in ref_small
    (tests/test_torch_slice.py add_serving_reference)."""
    from test_torch_slice import half_res_binary

    with np.load(os.path.join(DATA_DIR, "ref_small.npz")) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_quad_")}
    cfg, world, _, loc = SETUPS["small"]()
    imgs, _ = render_frames(jsyn, world, cfg.camera, loc)
    acfg = cfg.aruco
    for k, i in enumerate(ref["ref_quad_frames"]):
        b = torch.as_tensor(half_res_binary(imgs[i], acfg))
        q, s, v = tdet.quad_candidates(
            b, acfg.max_quad_candidates,
            min_area=acfg.min_quad_side_px**2 / acfg.detect_downsample**2,
            cc_iters=acfg.cc_iters, use_pallas_cc=True)
        want_v = ref["ref_quad_valid"][k]
        np.testing.assert_array_equal(v.numpy(), want_v)
        np.testing.assert_array_equal(s.numpy(), ref["ref_quad_score"][k])
        np.testing.assert_array_equal(q.numpy()[want_v],
                                      ref["ref_quad_q"][k][want_v])
