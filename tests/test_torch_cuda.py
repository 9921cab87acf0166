"""The hand-written CUDA kernels against their plain PyTorch versions.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere. This
file imports no jax (the GPU machine has none), so it also runs there
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The input builders here are shared with tests/test_torch_kernels.py, which
holds the plain versions to the JAX package's Pallas kernels on the CPU.
"""

import numpy as np
import pytest
import torch

from orb_slam2_aruco_tpu_torch import kernels
from orb_slam2_aruco_tpu_torch.kernels import build
from orb_slam2_aruco_tpu_torch.ops import cc_fused, cc_propagate, fast, orb

torch.set_num_threads(1)    # as in test_torch_slice.py: small CPU tensors

T_HI, T_LO = 20.0, 7.0


def rendered_level():
    from orb_slam2_aruco_tpu_torch.io import synthetic
    from orb_slam2_aruco_tpu_torch.config import CameraConfig

    camc = CameraConfig(fx=300.0, fy=300.0, cx=100.0, cy=75.0,
                        width=203, height=151)
    world = synthetic.build_world([3, 17], px_per_m=700.0, spacing=0.45,
                                  grid_cols=2)
    R, t = synthetic.look_at_plane_pose((0.2, 0.0), 1.0, yaw=0.05)
    return np.clip(synthetic.render_view(world, camc, R, t), 0, 255)


def rings(rng, h, w):
    img = np.zeros((h, w), bool)
    for _ in range(6):
        s = int(rng.integers(8, 24))
        y, x = int(rng.integers(0, h - s)), int(rng.integers(0, w - s))
        img[y:y + s, x:x + s] = True
        img[y + 2:y + s - 2, x + 2:x + s - 2] = False
    return img


def spiral(n=64):
    """A 1-px square spiral: its label has to turn ~30 corners, far more
    than 3 rounds of the fixed-round algorithm can carry."""
    img = np.zeros((n, n), bool)
    y = x = n // 2
    dy, dx = 0, 1
    step = 2
    while True:
        for _ in range(2):
            for _ in range(step):
                if not (0 <= y < n and 0 <= x < n):
                    return img
                img[y, x] = True
                y, x = y + dy, x + dx
            dy, dx = dx, -dy
        step += 2


def init_labels(binary):
    """K4's input: flat index on foreground, the sentinel H*W elsewhere."""
    h, w = binary.shape
    return np.where(binary, np.arange(h * w).reshape(h, w),
                    h * w).astype(np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode (chip_smoke.py runs them)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fast_cuda_matches_plain(cuda_device):
    img = torch.as_tensor(rendered_level().astype(np.float32),
                          device=cuda_device)
    got = fast.fast_score_nms_cuda(img, T_HI, T_LO)
    want = fast.fast_score_nms_torch(img, T_HI, T_LO)
    assert torch.equal(got[3:-3, 3:-3], want[3:-3, 3:-3])


@pytest.mark.cuda
def test_patches_cuda_matches_plain(cuda_device):
    rng = np.random.default_rng(5)
    img = torch.as_tensor(rng.uniform(0, 255, (123, 217)).astype(np.float32),
                          device=cuda_device)
    y0 = torch.as_tensor(rng.integers(0, 91, 50).astype(np.int32),
                         device=cuda_device)
    x0 = torch.as_tensor(rng.integers(0, 185, 50).astype(np.int32),
                         device=cuda_device)
    assert torch.equal(orb.extract_patches_cuda(img, y0, x0),
                       orb.extract_patches_torch(img, y0, x0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["marker_rings", "spiral"])
def test_cc_cuda_matches_plain(cuda_device, case):
    rng = np.random.default_rng(6)
    binary = rings(rng, 270, 480) if case == "marker_rings" else spiral()
    binary = torch.as_tensor(binary, device=cuda_device)
    got = cc_fused.cc_fused_cuda(binary)
    want = cc_fused.cc_fused_torch(binary)
    assert got[3] == want[3]
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "spiral", "marker_rings"])
def test_cc_propagate_cuda_matches_plain(cuda_device, case):
    rng = np.random.default_rng(7)
    if case == "random":
        binary = rng.uniform(size=(270, 480)) < 0.45
    elif case == "spiral":
        binary = spiral(200)
    else:
        binary = rings(rng, 270, 480)
    labels = torch.as_tensor(init_labels(binary), device=cuda_device)
    for passes in (1, 3):
        got = cc_propagate.cc_propagate_cuda(labels, passes, 16, 128)
        want = cc_propagate.cc_propagate_torch(labels, passes, 16, 128)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cc_propagate_raises_without_its_library(cuda_device, monkeypatch):
    """On a CUDA tensor the dispatcher launches the kernel or raises; it
    never falls back to the plain version."""
    def missing(name):
        raise RuntimeError(f"CUDA kernel build failed: {name}")

    monkeypatch.setattr(build, "launcher", missing)
    labels = torch.as_tensor(init_labels(spiral(64)), device=cuda_device)
    with pytest.raises(RuntimeError, match="build failed"):
        cc_propagate.cc_propagate(labels, 1, 16, 128)


@pytest.mark.cuda
def test_each_cuda_launch_is_counted_once(cuda_device):
    img = torch.rand((64, 160), device=cuda_device) * 255
    kernels.reset_launch_counts()
    fast.fast_score_nms(img, T_HI, T_LO)
    orb.extract_patches(img, torch.tensor([[40.0, 30.0]], device=cuda_device))
    cc_fused.cc_fused(img > 128)
    labels = torch.as_tensor(init_labels(spiral(64)), device=cuda_device)
    cc_propagate.cc_propagate(labels, 1, 16, 128)     # one sweep, one launch
    fast.fast_score_nms_torch(img, T_HI, T_LO)       # plain: not counted
    assert kernels.launch_counts == {"fast": 1, "patches": 1, "cc_fused": 1,
                                     "cc_propagate": 1}
