#!/usr/bin/env python3
"""Phase times inside one K3 launch (kernels/csrc/cc_fused.cu) on the card.

    python3 tools/torch_k3_phases.py

Builds a copy of cc_fused.cu into kernels/_build/ with %globaltimer
stamps added, taken by thread 0 of block 0: after every grid-wide sync,
and inside each phase after staging, after the computation and after the
store of that block's last work unit. It runs the copy on the bench frame's
binary at 270x480 (detect_downsample=2) and 540x960 (detect_downsample=1),
checks the result equal to the plain version, and prints per phase (J
Jacobi, R rows, C columns; round 0-2): its time including the sync after
it, and block 0's stage / compute / store split and what remains (waiting
for the other blocks, then the sync). The stamps cost about 2 us per call.
Also prints the unmodified kernel's time alone for comparison. Needs a
CUDA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAMP = ("if (blockIdx.x == 0 && threadIdx.x == 0) { unsigned long long t_; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); ")
# (anchor in cc_fused.cu, text put in its place)
EDITS = [
    ("constexpr int kBatch = 8;       // loads in flight per thread when "
     "staging\n",
     "constexpr int kBatch = 8;\n__device__ unsigned long long g_sync[16];\n"
     "__device__ unsigned long long g_part[64];\n__device__ int g_phase;\n"
     f"#define PART(k) {STAMP}g_part[g_phase * 4 + (k)] = t_; }}\n"),
    ("    __syncthreads();\n    // both buffers hold",
     "    __syncthreads();\n    PART(0);\n    // both buffers hold"),
    ("    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {",
     "    PART(1);\n    for (int i = threadIdx.x; i < kTile * kTile; "
     "i += kThreads) {"),
    ("    __syncthreads();  // the next tile restages the buffers",
     "    __syncthreads();  // the next tile restages the buffers\n"
     "    PART(2);"),
    ("    __syncwarp();\n    scan_line(s, p.Wp, C, CS, p.Hp * p.Wp);",
     "    __syncwarp();\n    PART(0);\n    scan_line(s, p.Wp, C, CS, "
     "p.Hp * p.Wp);\n    PART(1);"),
    ("g[k] = s[chunk_slot(k, c_div, CS)];\n    __syncwarp();",
     "g[k] = s[chunk_slot(k, c_div, CS)];\n    __syncwarp();\n    PART(2);"),
    ("    __syncthreads();\n    scan_line(smem + warp * LS, p.Hp, C, CS, "
     "big);\n    __syncthreads();",
     "    __syncthreads();\n    PART(0);\n    scan_line(smem + warp * LS, "
     "p.Hp, C, CS, big);\n    __syncthreads();\n    PART(1);"),
    ("    __syncthreads();  // the next strip restages the buffer",
     "    __syncthreads();  // the next strip restages the buffer\n"
     "    PART(2);"),
    ("  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n  int n_sync = 0;\n"
     f"#define SYNCED {STAMP}g_sync[n_sync++] = t_; }}\n"
     "#define PHASE(v) if (blockIdx.x == 0 && threadIdx.x == 0) "
     "g_phase = (v);\n  SYNCED;\n"),
    ("    jacobi_phase(p, src, dst, smem);\n    grid.sync();\n",
     "    PHASE(r * 3);\n    jacobi_phase(p, src, dst, smem);\n"
     "    grid.sync();\n    SYNCED;\n"),
    ("    row_phase(p, dst, smem);\n    grid.sync();\n",
     "    PHASE(r * 3 + 1);\n    row_phase(p, dst, smem);\n    grid.sync();\n"
     "    SYNCED;\n"),
    ("    col_phase(p, dst, smem, last);\n    if (!last) grid.sync();\n",
     "    PHASE(r * 3 + 2);\n    col_phase(p, dst, smem, last);\n"
     "    grid.sync();\n    SYNCED;\n"),
    ("extern \"C\" int cc_fused_launch(",
     "extern \"C\" int cc_phase_stamps(unsigned long long* sync, "
     "unsigned long long* part) {\n  cudaError_t e = cudaMemcpyFromSymbol("
     "sync, g_sync, sizeof(g_sync));\n  if (e == cudaSuccess) e = "
     "cudaMemcpyFromSymbol(part, g_part, sizeof(g_part));\n  return (int)e;"
     "\n}\n\nextern \"C\" int cc_fused_launch("),
]


def build_stamped(build):
    with open(os.path.join(build.SRC_DIR, "cc_fused.cu")) as f:
        src = f.read()
    for anchor, text in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"cc_fused.cu changed: anchor not found once: "
                             f"{anchor[:60]!r}")
        src = src.replace(anchor, text)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, "cc_fused_stamped.cu")
    so = os.path.join(build.BUILD_DIR, "cc_fused_stamped.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = build._nvcc_cmd("cc_fused", so)
    cmd[-1] = cu
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.cc_fused_launch.argtypes = build.SIGNATURES["cc_fused"][1]
    lib.cc_fused_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke
    import torch

    from orb_slam2_aruco_tpu_torch.kernels import build
    from orb_slam2_aruco_tpu_torch.ops import cc_fused

    chip_smoke.device_phase()
    lib = build_stamped(build)
    plain_lib = build.launcher("cc_fused")
    _, cfg, _, imgs = chip_smoke.load_reference()
    stream = torch.cuda.current_stream().cuda_stream
    for ds in (2, 1):
        binary = chip_smoke.quad_binary(imgs[0], cfg, ds)
        H, W = binary.shape
        Hp, Wp = cc_fused.padded_shape(H, W)
        fields = torch.empty((2, Hp, Wp, 4), dtype=torch.int32, device="cuda")
        outs = torch.zeros((3, H, W), dtype=torch.int32, device="cuda")
        args = (binary.data_ptr(), H, W, Hp, Wp, fields.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), 3,
                2, stream)
        alone = chip_smoke.kernel_alone_ms(lambda: plain_lib(*args))
        stamped = chip_smoke.kernel_alone_ms(lambda: lib.cc_fused_launch(*args))
        if lib.cc_fused_launch(*args) != 0:
            raise SystemExit("the stamped kernel failed to launch")
        torch.cuda.synchronize()
        want = cc_fused.cc_fused_torch(binary)
        if not all(torch.equal(a, b) for a, b in zip(outs, want[:3])):
            raise SystemExit("the stamped kernel differs from plain")
        sync = (ctypes.c_ulonglong * 16)()
        part = (ctypes.c_ulonglong * 64)()
        lib.cc_phase_stamps(sync, part)
        print(f"{H}x{W} (padded {Hp}x{Wp}): kernel alone {alone * 1000:.2f} "
              f"us, with the stamps {stamped * 1000:.2f} us; from launch to "
              f"the last sync {(sync[9] - sync[0]) / 1000:.2f} us")
        for k in range(9):
            name = f"{'JRC'[k % 3]}{k // 3}"
            s0, s1, s2 = part[4 * k], part[4 * k + 1], part[4 * k + 2]
            print(f"  {name}: {(sync[k + 1] - sync[k]) / 1000:6.2f} us; block "
                  f"0 stage {(s0 - sync[k]) / 1000:.2f}, compute "
                  f"{(s1 - s0) / 1000:.2f}, store {(s2 - s1) / 1000:.2f}, "
                  f"then waits and syncs {(sync[k + 1] - s2) / 1000:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
