"""pose_lm_kernel_share: the share of the window's pose LM calls
(optim/pose_opt.optimize_pose, two a frame on the common path) that ran as
the CUDA kernel K5 (kernels/csrc/pose_lm.cu): the program's counter
`pose_opt.LM_CALLS` by route, kernel calls over all calls, in %. 100 on
the card."""

try:
    from orb_slam2_aruco_tpu_torch.optim import pose_opt
except ImportError:
    pose_opt = None

ROUTES = ("kernel", "plain")
# a program that keeps no count of its LM calls by route has nothing to
# read, and the metric is left out
COUNTERS = ({"lm_calls." + r: (pose_opt.__name__, "LM_CALLS", r)
             for r in ROUTES}
            if hasattr(pose_opt, "LM_CALLS") else {})


def read(t):
    calls = [t.counters.get("lm_calls." + r) for r in ROUTES]
    if None in calls or not sum(calls):
        return None
    return 100.0 * calls[0] / sum(calls)
