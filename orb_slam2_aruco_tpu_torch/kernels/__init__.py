"""Hand-written CUDA kernels for Hopper (sm_90a) and their host plumbing.

Each `csrc/<name>.cu` exposes one `extern "C"` launcher. `build.library(name)`
compiles it with nvcc at first use into `_build/` (keyed by a hash of the
source) and loads it with ctypes; nothing is compiled or loaded at import,
so CPU-only machines import this package freely.

The kernels replace the TPU kernels of orb_slam2_aruco_tpu:

  fast      <- ops/pallas_fast.py::fast_score_nms       (ops/fast.py)
  patches   <- ops/pallas_patches.py::extract_patches_pallas  (ops/orb.py)
  cc_fused  <- ops/pallas_cc_fused.py::cc_fused          (ops/cc_fused.py)
  cc_propagate <- ops/pallas_cc.py::cc_propagate_pallas  (ops/cc_propagate.py)

and one runs what the JAX package left to XLA as one jitted program:

  pose_lm   <- optim/pose_opt.py::optimize_pose         (optim/pose_opt.py)

The Python bindings live beside the plain PyTorch versions in those
modules. `launch_counts` counts, per kernel, the launches on the card: each
binding adds one right after a launch succeeds, and nowhere else.
"""

from __future__ import annotations

from orb_slam2_aruco_tpu_torch.kernels import build  # noqa: F401

KERNELS = ("fast", "patches", "cc_fused", "cc_propagate", "pose_lm")

# dynamic shared memory a block may opt into on the H100 (sm_90)
SMEM_LIMIT = 232448

launch_counts = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code, else count the
    launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError {err}")
    launch_counts[name] += 1
