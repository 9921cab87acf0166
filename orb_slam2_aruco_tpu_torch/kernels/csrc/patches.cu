// K2: batched fixed-size patch extraction.
//
// Replaces orb_slam2_aruco_tpu/ops/pallas_patches.py::extract_patches_pallas
// (_patch_kernel): out[n] = img[y0[n] : y0[n]+P, x0[n] : x0[n]+P].
//
// Bound: device-memory traffic (4 KB read and written per 32x32 keypoint
// window, ~8 MB per frame at 1000 keypoints x 2 reads of the level) and
// launch latency. Design: one block per keypoint, 32x8 threads, each thread
// copying every 8th row of its column, so a warp reads 32 consecutive floats
// of one image row (coalesced) and writes one patch row. The TPU kernel's
// aligned superset windows and rolls were an artefact of Mosaic's alignment
// rules and have no counterpart here. The corners arrive clipped to
// [0, H-P] x [0, W-P]; the kernel clamps them once more (as dynamic_slice,
// the reference's non-TPU path, does), so a bad corner can never read out of
// bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void extract_patches_kernel(const float* __restrict__ img,
                                       const int32_t* __restrict__ y0,
                                       const int32_t* __restrict__ x0,
                                       float* __restrict__ out, int H, int W,
                                       int P) {
  const int n = blockIdx.x;
  int y = y0[n], x = x0[n];
  y = min(max(y, 0), H - P);
  x = min(max(x, 0), W - P);
  const float* src = img + (size_t)y * W + x;
  float* dst = out + (size_t)n * P * P;
  for (int r = threadIdx.y; r < P; r += blockDim.y)
    for (int c = threadIdx.x; c < P; c += blockDim.x)
      dst[r * P + c] = src[(size_t)r * W + c];
}

}  // namespace

extern "C" int extract_patches_launch(const float* img, const int32_t* y0,
                                      const int32_t* x0, float* out, int N,
                                      int H, int W, int P, void* stream) {
  if (N == 0) return 0;
  dim3 block(32, 8);
  extract_patches_kernel<<<N, block, 0, (cudaStream_t)stream>>>(
      img, y0, x0, out, H, W, P);
  return (int)cudaGetLastError();
}
