"""orb_slam2_aruco_tpu_torch — the PyTorch + CUDA port of orb_slam2_aruco_tpu.

Monocular ORB + ArUco SLAM engine for one NVIDIA H100. The JAX package
`orb_slam2_aruco_tpu` stays beside this one as the reference; every ported
function is tested against its JAX counterpart on the same inputs
(tests/test_torch_*.py). This package imports torch and numpy only, never jax.

Ported so far (slice 1): localization against a map the JAX package built —
`pipeline.system.SlamSystem.load_map` + `track_monocular`. The three Pallas
kernels on that path are hand-written CUDA kernels here (kernels/csrc):
FAST score + NMS (ops/fast.py), patch extraction (ops/orb.py) and the fused
connected components + blob bounding boxes (ops/cc_fused.py). Each has a
plain PyTorch version beside it, used for CPU tensors.
"""

__version__ = "0.1.0"

import torch as _torch

# Mirror orb_slam2_aruco_tpu/__init__.py:29 (jax_default_matmul_precision =
# "highest"): full float32 matmuls and convolutions. TF32 would break the
# exact integer sums of the blob statistics (ops/aruco/detector.py) and the
# LM normal equations; bf16 is used only where the reference feeds bf16
# operands itself (ops/orb.py steered BRIEF, worldmap/retrieval.py BoW).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from orb_slam2_aruco_tpu_torch.config import SlamConfig  # noqa: E402,F401
