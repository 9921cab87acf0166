// K1: FAST-9/16 corner score + strict 3x3 NMS + high-threshold bonus for one
// pyramid level.
//
// Replaces orb_slam2_aruco_tpu/ops/pallas_fast.py::fast_score_nms
// (_fast_kernel). Same arithmetic as the plain version
// (ops/fast.py::fast_score_nms_torch): the 16 circle terms are summed in
// _CIRCLE order, so scores match bit for bit; the arc-of-9 test runs on
// uint32 ring bits (logical shifts, so no sign-extension mask is needed,
// but the 0xFFFF window mask of the TPU kernel is kept: windows starting at
// bits 0..15 cover every cyclic arc).
//
// Bound: device-memory traffic (one float read and one float write per
// pixel; ~3 MB over the 8 levels of a 960x540 frame) and launch latency at
// the small levels. Design: one thread per output pixel in 32x8 tiles; the
// tile plus a 4-pixel halo (3 for the circle, 1 for the NMS) is staged in
// shared memory once, the pre-NMS score of the tile plus a 1-pixel ring is
// computed into shared memory, then each thread takes its 3x3 maximum.
// Reads outside the image return 0, as the TPU kernel's zero padding does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int HALO = 4;
constexpr int SW = TX + 2 * HALO;  // staged image tile width
constexpr int SH = TY + 2 * HALO;
constexpr int QW = TX + 2;         // pre-NMS score tile (tile + 1-px ring)
constexpr int QH = TY + 2;

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool arc9(uint32_t bits) {
  uint32_t b = bits | (bits << 16);
  uint32_t acc = b;
#pragma unroll
  for (int s = 1; s < 9; ++s) acc &= (b >> s);
  return (acc & 0xFFFFu) != 0u;
}

__global__ void fast_score_nms_kernel(const float* __restrict__ img,
                                      float* __restrict__ out, int H, int W,
                                      float t_hi, float t_lo) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_score[QH][QW];
  __shared__ unsigned char s_hi[QH][QW];

  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nthreads = TX * TY;

  for (int i = tid; i < SH * SW; i += nthreads) {
    int ly = i / SW, lx = i % SW;
    int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    s_img[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? img[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  for (int i = tid; i < QH * QW; i += nthreads) {
    int qy = i / QW, qx = i % QW;
    int gy = y0 - 1 + qy, gx = x0 - 1 + qx;
    float score = 0.0f;
    unsigned char hi = 0;
    if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
      int sy = qy - 1 + HALO, sx = qx - 1 + HALO;  // centre in s_img
      float c = s_img[sy][sx];
      uint32_t lb = 0, ld = 0, hb = 0, hd = 0;
      float sb = 0.0f, sd = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float d = s_img[sy + c_dy[k]][sx + c_dx[k]] - c;
        float nd = -d;
        uint32_t one = 1u << k;
        if (d > t_lo) lb |= one;
        if (nd > t_lo) ld |= one;
        if (d > t_hi) hb |= one;
        if (nd > t_hi) hd |= one;
        sb = __fadd_rn(sb, fmaxf(__fsub_rn(d, t_lo), 0.0f));
        sd = __fadd_rn(sd, fmaxf(__fsub_rn(nd, t_lo), 0.0f));
      }
      bool b_lo = arc9(lb), d_lo = arc9(ld);
      if (b_lo || d_lo) {
        score = __fadd_rn(b_lo ? sb : 0.0f, d_lo ? sd : 0.0f);
      }
      hi = (arc9(hb) || arc9(hd)) ? 1 : 0;
    }
    s_score[qy][qx] = score;
    s_hi[qy][qx] = hi;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int qy = threadIdx.y + 1, qx = threadIdx.x + 1;
  float s = s_score[qy][qx];
  float m = s;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) m = fmaxf(m, s_score[qy + dy][qx + dx]);
  float o = (s >= m) ? s : 0.0f;
  if (o > 0.0f && s_hi[qy][qx]) o = __fadd_rn(o, 1e6f);
  out[(size_t)y * W + x] = o;
}

}  // namespace

extern "C" int fast_score_nms_launch(const float* img, float* out, int H,
                                     int W, float t_hi, float t_lo,
                                     void* stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  fast_score_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, out, H, W, t_hi, t_lo);
  return (int)cudaGetLastError();
}
