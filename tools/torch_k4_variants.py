#!/usr/bin/env python3
"""K4 (kernels/csrc/cc_propagate.cu) at every depth of its ghost-row trade,
on the card.

    python3 tools/torch_k4_variants.py

K4 splits each tile's (tile + 2 halo)^2 buffer over a cluster of 8 CTAs.
Each CTA holds its band with g ghost rows on each side and trades them
with its neighbours every g steps (distributed shared memory, one cluster
barrier). g = 1 trades every step, 16 barriers at k 16; g = k never trades:
the CTAs are independent overlapped bands, each carrying k extra rows on
each side (~2.5x the work at tile 128, k 16). This runs one sweep of the
bare launcher at g = 1, 2, 4, 8, 16 on the bench frame's labels (initial
and after one round) at 270x480 and 540x960, checks each equal to the
plain version, and times each alone (events around the bare launch behind
a device sleep), in turns: every g ascending, then descending. It also
times k_steps = 0 (staging and store only). Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS = (1, 2, 4, 8, 16)


def main() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke
    import torch

    from orb_slam2_aruco_tpu_torch.kernels import build
    from orb_slam2_aruco_tpu_torch.ops import cc_propagate
    from orb_slam2_aruco_tpu_torch.ops.aruco import detector

    chip_smoke.device_phase()
    launch = build.launcher("cc_propagate")
    print(f"wrapper default: g = {cc_propagate.EXCHANGE}")
    _, cfg, _, imgs = chip_smoke.load_reference()
    stream = torch.cuda.current_stream().cuda_stream
    k, tile = 16, 128
    for ds in (2, 1):
        binary = chip_smoke.quad_binary(imgs[0], cfg, ds)
        H, W = binary.shape
        labels0 = detector.initial_labels(binary)
        labels1 = detector.pointer_jump(
            cc_propagate.cc_propagate_torch(labels0, 1, k, tile), H * W)
        dst = torch.empty_like(labels0)
        for lab in (labels0, labels1):
            want = cc_propagate.cc_propagate_torch(lab, 1, k, tile)
            for g in DEPTHS:
                dst.fill_(-1)
                if launch(lab.data_ptr(), dst.data_ptr(), H, W, tile, k, k, g,
                          stream) != 0:
                    raise SystemExit(f"g = {g} failed to launch")
                if not torch.equal(dst, want):
                    raise SystemExit(f"g = {g} differs from plain at {H}x{W}: "
                                     f"{int((dst != want).sum())} pixels")

        def alone(g, steps=k):
            return chip_smoke.kernel_alone_ms(lambda: launch(
                labels0.data_ptr(), dst.data_ptr(), H, W, tile, steps, steps,
                g, stream), reps=50)

        times = {g: [] for g in DEPTHS}
        for g in DEPTHS + DEPTHS[::-1]:
            times[g].append(alone(g))
        print(f"{H}x{W}, tile {tile}, k {k}: every g equal to plain (initial "
              f"and one-round labels); kernel alone, ms (ascending, "
              f"descending): " + "; ".join(
                  f"g {g}: {a:.4f}, {b:.4f}" for g, (a, b) in times.items())
              + f"; k_steps 0 (stage and store only): {alone(1, 0):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
