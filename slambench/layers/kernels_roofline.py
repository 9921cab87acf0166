"""kernels_roofline: the share of their roofline that the hand-written
kernels K1-K3 (kernels/csrc/fast.cu, patches.cu, cc_fused.cu) reach over
the profiled frames, in percent: the sum over their launches of the least
time the frame's work allows (reference/kernels.py's frozen counts, the
data sheet's peaks) over the sum of their device time in the trace. Not
read where the trace holds none of them."""

from reference import kernels


def read(t):
    if not t.profile:
        return None
    bounds = kernels.frame_bounds(t.slam)
    need = spent = 0.0
    for key, kname in kernels.KERNEL_NAMES.items():
        for name, a, b in t.profile["device"]:
            if kname in name:
                need += bounds[key]
                spent += (b - a) / 1e9
    return 100.0 * need / spent if spent > 0 else None
