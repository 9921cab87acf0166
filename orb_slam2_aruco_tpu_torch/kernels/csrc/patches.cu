// K2: fixed-size patch extraction for every pyramid level in one launch.
//
// Replaces orb_slam2_aruco_tpu/ops/pallas_patches.py::extract_patches_pallas
// (_patch_kernel): per level, out[n] = img[y0[n] : y0[n]+32, x0[n] : x0[n]+32].
// One launch takes the frame's L levels and all their keypoints and writes
// the [N_total, 32, 32] patches in level order. A level gives either the
// keypoints xy [N, 2] float32, whose corners are computed here exactly as
// ops/orb.py::patch_corners computes them (rintf rounds half to even, as
// torch.round does; minus 16; clamped to [0, H-32] x [0, W-32]), or the
// top-left corners y0, x0 [N] int32, clamped the same way (as
// dynamic_slice clamps them).
//
// Bound: launch latency. The work is one 4 KB copy per keypoint, ~4 MB per
// frame at 1000 keypoints (about 1.5 us of device-memory time), so what the
// design removes is launches and host work: the level table (base
// pointers, H, W, first output index, keypoint pointers) goes to the kernel
// by value, as one __grid_constant__ parameter filled by the launcher from
// a host array, not through device memory (an upload of a descriptor table
// would add a copy and a synchronizing call per frame).
//
// Layout: one block of 8 warps per patch, one warp per 4 patch rows; lane l
// moves row 4*warp + l/8, columns 4*(l%8) .. +3. The output rows are 128 B
// and 128-byte aligned, so each lane stores one float4 and a warp stores
// 512 contiguous bytes. Source rows are not 16-byte aligned (level widths
// 960, 800, 667, ... and any x0), so the loads are scalar; a warp's loads
// cover 4 rows of 128 contiguous bytes each. TMA is not used: a tensor
// map needs 16-byte row pitches, which 667-wide levels lack, and the whole
// copy is 4 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 32;
constexpr int kMaxLevels = 16;

struct PatchLevel {
  const float* img;    // [H, W]
  const float* xy;     // [n, 2] keypoints, or null: corners y0, x0 below
  const int32_t* y0;   // [n]
  const int32_t* x0;   // [n]
  int H, W;
  int begin;           // first output patch of this level
};

struct PatchArgs {
  PatchLevel lv[kMaxLevels];
  int L;
  float* out;          // [N_total, 32, 32]
};

__global__ void __launch_bounds__(256)
extract_patches_kernel(const __grid_constant__ PatchArgs a) {
  const int n = blockIdx.x;
  int l = 0;
  while (l + 1 < a.L && n >= a.lv[l + 1].begin) ++l;
  const PatchLevel& lv = a.lv[l];
  const int i = n - lv.begin;
  int y, x;
  if (lv.xy) {
    x = (int)rintf(lv.xy[2 * i]) - kPatch / 2;
    y = (int)rintf(lv.xy[2 * i + 1]) - kPatch / 2;
  } else {
    y = lv.y0[i];
    x = lv.x0[i];
  }
  y = min(max(y, 0), lv.H - kPatch);
  x = min(max(x, 0), lv.W - kPatch);
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * 4 + (lane >> 3);
  const int col = (lane & 7) * 4;
  const float* src = lv.img + (size_t)(y + row) * lv.W + x + col;
  const float4 v = make_float4(src[0], src[1], src[2], src[3]);
  *reinterpret_cast<float4*>(a.out + ((size_t)n * kPatch + row) * kPatch +
                             col) = v;
}

}  // namespace

// table: L rows of 7 int64 (img, xy, y0, x0 pointers as integers, H, W,
// number of patches); out: [sum of the counts, 32, 32] float32.
extern "C" int extract_patches_launch(const int64_t* table, int L, float* out,
                                      void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  PatchArgs a = {};
  a.L = L;
  a.out = out;
  int total = 0;
  for (int l = 0; l < L; ++l) {
    const int64_t* r = table + 7 * l;
    a.lv[l].img = reinterpret_cast<const float*>(r[0]);
    a.lv[l].xy = reinterpret_cast<const float*>(r[1]);
    a.lv[l].y0 = reinterpret_cast<const int32_t*>(r[2]);
    a.lv[l].x0 = reinterpret_cast<const int32_t*>(r[3]);
    a.lv[l].H = (int)r[4];
    a.lv[l].W = (int)r[5];
    a.lv[l].begin = total;
    if (a.lv[l].H < kPatch || a.lv[l].W < kPatch)
      return (int)cudaErrorInvalidValue;
    total += (int)r[6];
  }
  if (total == 0) return 0;
  extract_patches_kernel<<<total, 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
