#!/usr/bin/env python3
"""Where K1's time goes (kernels/csrc/fast.cu), on the card: the kernel with
parts of its pre-NMS score cut.

    python3 tools/torch_k1_parts.py

Builds copies of fast.cu into kernels/_build/, each with one edit, all at
once, and times each alone (events around the bare launch behind a device
sleep) on the 8 pyramid levels of the bench frame (data/ref_full.npz,
frame 0), in turns: every variant in order, then in reverse.

  full        the kernel as it is;
  no_compass  without the compass pre-check (every pixel runs the ring;
              the output must still equal the plain version);
  no_hi       without the high-threshold bits and arc (of the path for
              t_lo >= 0 and t_hi >= t_lo, which the bench's thresholds
              take);
  compass     the score ends after the compass pre-check;
  no_ring     the pre-NMS score is 0 everywhere: staging, the NMS, the
              stores and the launch.

Only full and no_compass compute K1's function; the others are
measurements of what remains. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPASS = "  if (nb < 2 && nd < 2) return 0.0f;\n"
_RING = "  float d[16];\n  uint32_t lb = 0, ld = 0;\n"
# variant -> [(anchor in fast.cu, text put in its place)]
VARIANTS = {
    "full": [],
    "no_compass": [(_COMPASS, "")],
    "no_hi": [("      if (x > t_hi) hbits |= 1u << k;\n", ""),
              ("    *hi = arc9(hbits);\n", "")],
    "compass": [(_RING, "  return (float)(nb + nd);\n" + _RING)],
    "no_ring": [("  const float c = p[0];\n",
                 "  return 0.0f;\n  const float c = p[0];\n")],
}
EXACT = ("full", "no_compass")


def build_variants(build):
    with open(os.path.join(build.SRC_DIR, "fast.cu")) as f:
        src = f.read()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for anchor, repl in edits:
            if text.count(anchor) != 1:
                raise SystemExit(f"fast.cu changed: anchor not found once: "
                                 f"{anchor[:60]!r}")
            text = text.replace(anchor, repl)
        cu = os.path.join(build.BUILD_DIR, f"fast_{name}.cu")
        so = os.path.join(build.BUILD_DIR, f"fast_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = build._nvcc_cmd("fast", so)
        cmd[-1] = cu
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"{name:11s} {regs}")
        fn = ctypes.CDLL(so).fast_score_nms_launch
        fn.argtypes = build.SIGNATURES["fast"][1]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke
    import numpy as np
    import torch

    from orb_slam2_aruco_tpu_torch.kernels import build
    from orb_slam2_aruco_tpu_torch.ops import fast, image

    chip_smoke.device_phase()
    libs = build_variants(build)
    _, cfg, _, imgs = chip_smoke.load_reference()
    ocfg = cfg.orb
    t = (ocfg.fast_threshold, ocfg.fast_min_threshold)
    levels = image.build_pyramid(torch.as_tensor(imgs[0]).to("cuda").float(),
                                 ocfg.num_levels, ocfg.scale_factor)
    outs = [torch.empty_like(lvl) for lvl in levels]
    table = np.array([(lvl.data_ptr(), o.data_ptr(), *lvl.shape)
                      for lvl, o in zip(levels, outs)], dtype=np.int64)
    stream = torch.cuda.current_stream().cuda_stream
    want = [fast.fast_score_nms_torch(lvl, *t) for lvl in levels]
    for name in EXACT:
        if libs[name](table.ctypes.data, len(levels), *t, stream) != 0:
            raise SystemExit(f"{name} failed to launch")
        torch.cuda.synchronize()
        inner = (slice(3, -3), slice(3, -3))
        if not all(torch.equal(o[inner], w[inner])
                   for o, w in zip(outs, want)):
            raise SystemExit(f"{name} differs from the plain version")
    times = {name: [] for name in VARIANTS}
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        fn = libs[name]
        times[name].append(chip_smoke.kernel_alone_ms(
            lambda: fn(table.ctypes.data, len(levels), *t, stream), reps=50))
    print(f"8 levels {[tuple(lvl.shape) for lvl in levels]}; {EXACT} equal "
          f"to plain; kernel alone, ms (in order, in reverse):")
    for name, (a, b) in times.items():
        print(f"  {name:11s} {a:.4f}, {b:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
