"""orb_slam2_aruco_tpu_torch — the PyTorch + CUDA port of orb_slam2_aruco_tpu.

Monocular ORB + ArUco SLAM engine for one NVIDIA H100. The JAX package
`orb_slam2_aruco_tpu` stays beside this one as the reference; every ported
function is tested against its JAX counterpart on the same inputs
(tests/test_torch_*.py). This package imports torch and numpy only, never jax.

Ported so far: SLAM mode from an empty map (`pipeline.system.SlamSystem`,
synchronous or pipelined, with loop closing and relocalization),
`save_map`, and localization against a saved map of either package —
`SlamSystem.load_map`, then `track_monocular` frame by frame or the chunked
serving form `track_monocular_batch` / `localize_stream`; the two-pass
example is `python -m orb_slam2_aruco_tpu_torch.examples.mono_synthetic`. All
four Pallas kernels are hand-written CUDA kernels here (kernels/csrc): FAST
score + NMS (ops/fast.py), patch extraction (ops/orb.py), the fused
connected components + blob bounding boxes (ops/cc_fused.py) and the
tile-local label propagation of the unfused quad proposal
(ops/cc_propagate.py). Each has a plain PyTorch version beside it, used for
CPU tensors. Entry points run on the card unless given device="cpu".
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


def require_device(device) -> _torch.device:
    """`device` as a torch.device; raises when it names CUDA and there is no
    CUDA GPU (an entry point never falls back to the CPU)."""
    device = _torch.device(device)
    if device.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU is available: this entry point runs "
                           "on the card unless it is given device='cpu'")
    return device
