"""pose_lm_kernel_us: the mean device time of one launch of the CUDA kernel
K5 (kernels/csrc/pose_lm.cu, the whole pose LM of optim/pose_opt) over the
profiled frames, in microseconds. Its block follows the problem's edges
(256 threads up to 2048, 512 above), so a cell's shape picks the block
this reads. Not read where the trace holds no K5 launch."""

KERNEL = "pose_lm_kernel"


def read(t):
    if not t.profile:
        return None
    us = [(b - a) / 1e3 for name, a, b in t.profile["device"]
          if KERNEL in name]
    return sum(us) / len(us) if us else None
