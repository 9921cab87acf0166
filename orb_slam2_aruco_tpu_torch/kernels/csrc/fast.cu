// K1: FAST-9/16 corner score + strict 3x3 NMS + high-threshold bonus for
// every pyramid level of a frame in one launch.
//
// Replaces orb_slam2_aruco_tpu/ops/pallas_fast.py::fast_score_nms
// (_fast_kernel), which runs once per level. Same arithmetic as the plain
// version (ops/fast.py::fast_score_nms_torch): the 16 circle terms are
// summed in _CIRCLE order with __fadd_rn, so scores match bit for bit; the
// arc-of-9 test runs on uint32 ring bits (logical shifts, so no
// sign-extension mask is needed, but the 0xFFFF window mask of the TPU
// kernel is kept: windows starting at bits 0..15 cover every cyclic arc).
//
// Bound: ~290 scalar operations per pixel over ~1.6 M pixels per 960x540
// frame (about 6.5 us at the card's float32 rate), far above its ~13 MB of
// traffic; and, with one launch per level, launch latency and the tails of
// the small levels. Design:
//   * one launch for all levels: a flat 1-D grid over every level's 64x16
//     tiles, the level table (image and output pointers, H, W, tiles per
//     row, first block) passed by value as a __grid_constant__ parameter;
//     a block finds its level with a scan of at most 8 entries;
//   * per block, 256 threads: the tile plus a 4-pixel halo (3 for the
//     circle, 1 for the NMS) is staged in shared memory, each thread's 12
//     loads all issued before the first store (staged one at a time, their
//     latency made staging, NMS and stores 40 % of the kernel on the H100,
//     tools/torch_k1_parts.py); the
//     pre-NMS score of the tile plus a 1-pixel ring (66x18 positions, 4.6
//     per thread) is computed into shared memory, then each thread takes
//     the 3x3 maximum of 4 output pixels; index maps divide only by
//     compile-time widths;
//   * exact early rejection: an arc of 9 contiguous ring pixels holds at
//     least 2 of the 4 compass pixels (0, 4, 8, 12), so a pixel with fewer
//     than 2 compass pixels past t_lo in either polarity scores 0 without
//     the rest of the ring. A warp skips the ring only where all its
//     pixels stop there, which on a textured frame is the minority;
//   * fewer instructions where an arc passes: the high-threshold arc is
//     read only there (the bonus applies only where the NMS'd score is
//     > 0, which needs a low arc, for any order of t_hi and t_lo), only
//     the passing polarity's 16-term sum runs, and the arc test doubles
//     runs (4 shift-and steps, not 8). Where t_lo >= 0 and t_hi >= t_lo
//     (the thresholds the frontend passes; checked once per launch) only
//     the passing polarity's t_hi bits are taken, in the loop of its sum.
// Reads outside the image return 0, as the TPU kernel's zero padding does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int TX = 64;             // output tile
constexpr int TY = 16;
constexpr int NTY = 4;             // block = TX x NTY threads
constexpr int NT = TX * NTY;
constexpr int HALO = 4;
constexpr int SW = TX + 2 * HALO;  // staged image tile width
constexpr int SH = TY + 2 * HALO;
constexpr int QW = TX + 2;         // pre-NMS score tile (tile + 1-px ring)
constexpr int QH = TY + 2;

struct FastLevel {
  const float* img;  // [H, W]
  float* out;        // [H, W]
  int H, W;
  int tiles_x;
  int first;         // first block of this level
};

struct FastArgs {
  FastLevel lv[kMaxLevels];
  int L;
  float t_hi, t_lo;
};

// 9 contiguous set bits on the 16-bit ring: bit i of the doubled ring's
// run mask is bits i..i+8 all set, built by doubling runs of 2, 4, 8, then 9
// (the same windows as the plain version's 8 shifts).
__device__ __forceinline__ bool arc9(uint32_t bits) {
  const uint32_t b = bits | (bits << 16);
  uint32_t r = b & (b >> 1);
  r &= r >> 2;
  r &= r >> 4;
  r &= b >> 8;
  return (r & 0xFFFFu) != 0u;
}

// Sum over the ring of max(sign * d - t_lo, 0) in _CIRCLE order. sign is
// +1 or -1, so sign * d is exact and the fma rounds once, as
// __fsub_rn(+-d, t_lo) does.
__device__ __forceinline__ float ring_sum(const float (&d)[16], float sign,
                                          float t_lo) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    s = __fadd_rn(s, fmaxf(__fmaf_rn(sign, d[k], -t_lo), 0.0f));
  return s;
}

// Pre-NMS score of the staged pixel p (row pitch SW) and, where it is > 0,
// whether the t_hi arc passes. one_pol: t_lo >= 0 and t_hi >= t_lo.
__device__ __forceinline__ float ring_score(const float* p, float t_hi,
                                            float t_lo, bool one_pol,
                                            bool* hi) {
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                           3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                           0, -1, -2, -3, -3, -3, -2, -1};
  const float c = p[0];
  int nb = 0, nd = 0;
#pragma unroll
  for (int k = 0; k < 16; k += 4) {
    const float d = __fsub_rn(p[kDy[k] * SW + kDx[k]], c);
    nb += d > t_lo;
    nd += -d > t_lo;
  }
  if (nb < 2 && nd < 2) return 0.0f;
  float d[16];
  uint32_t lb = 0, ld = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    d[k] = __fsub_rn(p[kDy[k] * SW + kDx[k]], c);
    if (d[k] > t_lo) lb |= 1u << k;
    if (-d[k] > t_lo) ld |= 1u << k;
  }
  const bool b_lo = arc9(lb), d_lo = arc9(ld);
  if (!(b_lo || d_lo)) return 0.0f;
  // only the passing polarity's sum: the score is sb + 0 or 0 + sd, and
  // x + 0 = x for the sums (never -0)
  const float sign = b_lo ? 1.0f : -1.0f;
  if (one_pol) {
    // t_lo >= 0: one polarity's arc at most; t_hi >= t_lo: the other
    // polarity's t_hi bits lie within its t_lo bits, which hold no arc, so
    // only this polarity's t_hi arc can pass. sign * d is exact.
    uint32_t hbits = 0;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float x = sign * d[k];
      if (x > t_hi) hbits |= 1u << k;
      s = __fadd_rn(s, fmaxf(__fsub_rn(x, t_lo), 0.0f));
    }
    *hi = arc9(hbits);
    return s;
  }
  uint32_t hb = 0, hd = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (d[k] > t_hi) hb |= 1u << k;
    if (-d[k] > t_hi) hd |= 1u << k;
  }
  *hi = arc9(hb) || arc9(hd);
  // a bright and a dark arc at once needs t_lo < 0; the score is then
  // sb + sd, as in the plain version
  const float s = ring_sum(d, sign, t_lo);
  return (b_lo && d_lo) ? __fadd_rn(s, ring_sum(d, -1.0f, t_lo)) : s;
}

__global__ void __launch_bounds__(NT)
fast_score_nms_kernel(const __grid_constant__ FastArgs a) {
  __shared__ float s_img[SH * SW];
  __shared__ float s_score[QH * QW];
  __shared__ unsigned char s_hi[QH * QW];

  int l = 0;
  while (l + 1 < a.L && (int)blockIdx.x >= a.lv[l + 1].first) ++l;
  const FastLevel& lv = a.lv[l];
  const int H = lv.H, W = lv.W;
  const int b = blockIdx.x - lv.first;
  const int by = b / lv.tiles_x;
  const int x0 = (b - by * lv.tiles_x) * TX;
  const int y0 = by * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // staging: every load of this thread in flight before the first store
  // (SH / NTY rows; a second column for the SW - TX rightmost halo pixels)
  constexpr int kRows = SH / NTY;
  static_assert(SH % NTY == 0 && SW - TX <= TX, "staging layout");
  const int sgx = x0 - HALO + tx;
  const bool in0 = sgx >= 0 && sgx < W;
  const bool in1 = tx < SW - TX && sgx + TX < W;
  float v0[kRows], v1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gy = y0 - HALO + ty + r * NTY;
    const bool row_in = gy >= 0 && gy < H;
    const float* row = lv.img + (size_t)(row_in ? gy : 0) * W;
    v0[r] = (row_in && in0) ? row[sgx] : 0.0f;
    v1[r] = (row_in && in1) ? row[sgx + TX] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float* srow = s_img + (ty + r * NTY) * SW;
    srow[tx] = v0[r];
    if (tx < SW - TX) srow[tx + TX] = v1[r];
  }
  __syncthreads();

  const float t_hi = a.t_hi, t_lo = a.t_lo;
  const bool one_pol = t_lo >= 0.0f && t_hi >= t_lo;
  for (int i = ty * TX + tx; i < QH * QW; i += NT) {
    const int qy = i / QW, qx = i - qy * QW;
    const int gy = y0 - 1 + qy, gx = x0 - 1 + qx;
    float score = 0.0f;
    bool hi = false;
    if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3)
      score = ring_score(&s_img[(qy - 1 + HALO) * SW + qx - 1 + HALO], t_hi,
                         t_lo, one_pol, &hi);
    s_score[i] = score;
    s_hi[i] = hi;
  }
  __syncthreads();

  const int x = x0 + tx;
  if (x >= W) return;
  for (int oy = ty; oy < TY; oy += NTY) {
    const int y = y0 + oy;
    if (y >= H) break;
    const int q = (oy + 1) * QW + tx + 1;
    const float s = s_score[q];
    float m = s;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) m = fmaxf(m, s_score[q + dy * QW + dx]);
    float o = (s >= m) ? s : 0.0f;
    if (o > 0.0f && s_hi[q]) o = __fadd_rn(o, 1e6f);
    lv.out[(size_t)y * W + x] = o;
  }
}

}  // namespace

// table: L rows of 4 int64 (image and output pointers as integers, H, W);
// each image and output [H, W] float32. One launch for all L levels.
extern "C" int fast_score_nms_launch(const int64_t* table, int L, float t_hi,
                                     float t_lo, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  FastArgs a = {};
  a.L = L;
  a.t_hi = t_hi;
  a.t_lo = t_lo;
  int blocks = 0;
  for (int l = 0; l < L; ++l) {
    const int64_t* r = table + 4 * l;
    FastLevel& lv = a.lv[l];
    lv.img = reinterpret_cast<const float*>(r[0]);
    lv.out = reinterpret_cast<float*>(r[1]);
    lv.H = (int)r[2];
    lv.W = (int)r[3];
    lv.tiles_x = (lv.W + TX - 1) / TX;
    lv.first = blocks;
    blocks += lv.tiles_x * ((lv.H + TY - 1) / TY);
  }
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  fast_score_nms_kernel<<<blocks, dim3(TX, NTY), 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
