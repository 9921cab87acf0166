// K3: approximate connected components + per-pixel blob bounding box.
//
// Replaces orb_slam2_aruco_tpu/ops/pallas_cc_fused.py::cc_fused
// (_cc_fused_kernel). The same fixed-round algorithm, so the output is
// bit-identical to the TPU kernel whether or not a blob has converged:
// four int32 fields on the padded grid [Hp, Wp] (Hp = ceil(H/8)*8,
// Wp = ceil(W/128)*128),
//   f0 = min(y*Wp + x)   -> label, min_y = f0 / Wp
//   f1 = min(x*Hp + y)   -> min_x = f1 / Hp
//   f2 = max(y*Wp + x)   -> max_y = f2 / Wp
//   f3 = max(x*Hp + y)   -> max_x = f3 / Hp
// go through `rounds` x [`prop_steps` Jacobi 8-neighbour steps, then exact
// inclusive segmented scans: row forward, row backward, column forward,
// column backward]. A segment starts at every background pixel and at every
// foreground pixel whose predecessor in scan order is background or off the
// grid. Min/max over int32 is associative and exact, so the warp scan here
// equals the TPU kernel's doubling scan.
//
// Bound: launch latency and L2 traffic (four fields are ~2.2 MB at
// 272x512, well inside the 50 MB L2). The fields do not fit one SM's shared
// memory, so the work spans many blocks: one grid-wide kernel per Jacobi
// step (double-buffered) and one warp per row or column for each scan
// (each lane scans a contiguous chunk, the warp combines the chunk carries
// with shuffles, each lane rescans its chunk with its carry). All 20
// launches of a call are issued from the host function below.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cc_init_kernel(const uint8_t* __restrict__ binary, int H,
                               int W, int Hp, int Wp,
                               uint8_t* __restrict__ fg,
                               int32_t* __restrict__ f) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Wp || y >= Hp) return;
  const size_t plane = (size_t)Hp * Wp;
  const size_t i = (size_t)y * Wp + x;
  bool on = (y < H && x < W) && binary[(size_t)y * W + x] != 0;
  fg[i] = on ? 1 : 0;
  const int big = Hp * Wp;
  f[i] = on ? y * Wp + x : big;
  f[plane + i] = on ? x * Hp + y : big;
  f[2 * plane + i] = on ? y * Wp + x : -1;
  f[3 * plane + i] = on ? x * Hp + y : -1;
}

__global__ void cc_prop8_kernel(const uint8_t* __restrict__ fg,
                                const int32_t* __restrict__ src,
                                int32_t* __restrict__ dst, int Hp, int Wp) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Wp || y >= Hp) return;
  const size_t plane = (size_t)Hp * Wp;
  const size_t i = (size_t)y * Wp + x;
  int a = src[i], b = src[plane + i];
  int c = src[2 * plane + i], d = src[3 * plane + i];
  if (fg[i]) {
    for (int dy = -1; dy <= 1; ++dy) {
      int yy = y + dy;
      if (yy < 0 || yy >= Hp) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        int xx = x + dx;
        if (xx < 0 || xx >= Wp) continue;
        size_t j = (size_t)yy * Wp + xx;
        a = min(a, src[j]);
        b = min(b, src[plane + j]);
        c = max(c, src[2 * plane + j]);
        d = max(d, src[3 * plane + j]);
      }
    }
  }
  dst[i] = a;
  dst[plane + i] = b;
  dst[2 * plane + i] = c;
  dst[3 * plane + i] = d;
}

struct Agg {
  int a, b, c, d;  // min, min, max, max
};

__device__ __forceinline__ Agg agg_identity() {
  return Agg{INT_MAX, INT_MAX, INT_MIN, INT_MIN};
}

__device__ __forceinline__ Agg agg_comb(const Agg& p, const Agg& q) {
  return Agg{min(p.a, q.a), min(p.b, q.b), max(p.c, q.c), max(p.d, q.d)};
}

// One warp per line. axis == 1: rows (lines are y, positions x); axis == 0:
// columns. reverse walks the line from its far end.
__global__ void cc_seg_scan_kernel(const uint8_t* __restrict__ fg,
                                   int32_t* __restrict__ f, int Hp, int Wp,
                                   int axis, int reverse) {
  const int warps_per_block = blockDim.x / 32;
  const int line = blockIdx.x * warps_per_block + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int L = axis == 1 ? Wp : Hp;
  const int nlines = axis == 1 ? Hp : Wp;
  if (line >= nlines) return;  // whole warp exits together
  const size_t plane = (size_t)Hp * Wp;
  const size_t step = axis == 1 ? 1 : (size_t)Wp;
  const size_t base = axis == 1 ? (size_t)line * Wp : (size_t)line;
  auto addr = [&](int k) -> size_t {
    int pos = reverse ? (L - 1 - k) : k;
    return base + (size_t)pos * step;
  };
  auto is_start = [&](int k) -> bool {
    if (!fg[addr(k)]) return true;
    if (k == 0) return true;
    return !fg[addr(k - 1)];
  };
  const int C = (L + 31) / 32;
  const int k0 = min(lane * C, L), k1 = min(k0 + C, L);

  // pass 1: this lane's segmented aggregate and whether it holds a start
  Agg agg = agg_identity();
  bool flag = false;
  for (int k = k0; k < k1; ++k) {
    size_t i = addr(k);
    Agg v{f[i], f[plane + i], f[2 * plane + i], f[3 * plane + i]};
    if (is_start(k)) {
      agg = v;
      flag = true;
    } else {
      agg = agg_comb(agg, v);
    }
  }
  // warp inclusive scan of (agg, flag) under the segmented operator
  for (int off = 1; off < 32; off <<= 1) {
    Agg p;
    p.a = __shfl_up_sync(0xffffffffu, agg.a, off);
    p.b = __shfl_up_sync(0xffffffffu, agg.b, off);
    p.c = __shfl_up_sync(0xffffffffu, agg.c, off);
    p.d = __shfl_up_sync(0xffffffffu, agg.d, off);
    bool pf = __shfl_up_sync(0xffffffffu, (int)flag, off) != 0;
    if (lane >= off) {
      if (!flag) agg = agg_comb(p, agg);
      flag = flag || pf;
    }
  }
  // exclusive carry into this lane's chunk
  Agg carry;
  carry.a = __shfl_up_sync(0xffffffffu, agg.a, 1);
  carry.b = __shfl_up_sync(0xffffffffu, agg.b, 1);
  carry.c = __shfl_up_sync(0xffffffffu, agg.c, 1);
  carry.d = __shfl_up_sync(0xffffffffu, agg.d, 1);
  if (lane == 0) carry = agg_identity();

  // pass 2: rescan the chunk from the carry and write back in place
  Agg run = carry;
  for (int k = k0; k < k1; ++k) {
    size_t i = addr(k);
    Agg v{f[i], f[plane + i], f[2 * plane + i], f[3 * plane + i]};
    run = is_start(k) ? v : agg_comb(run, v);
    f[i] = run.a;
    f[plane + i] = run.b;
    f[2 * plane + i] = run.c;
    f[3 * plane + i] = run.d;
  }
}

__global__ void cc_finish_kernel(const uint8_t* __restrict__ fg,
                                 const int32_t* __restrict__ f, int H, int W,
                                 int Hp, int Wp, int32_t* __restrict__ lab,
                                 int32_t* __restrict__ bw,
                                 int32_t* __restrict__ bh) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = (size_t)Hp * Wp;
  const size_t i = (size_t)y * Wp + x;
  const size_t o = (size_t)y * W + x;
  if (fg[i]) {
    int l = f[i];
    lab[o] = l;
    bw[o] = f[3 * plane + i] / Hp - f[plane + i] / Hp + 1;
    bh[o] = f[2 * plane + i] / Wp - l / Wp + 1;
  } else {
    lab[o] = Hp * Wp;
    bw[o] = 0;
    bh[o] = 0;
  }
}

}  // namespace

// binary [H, W] uint8; scratch: fg [Hp*Wp] uint8, fa and fb [4*Hp*Wp] int32;
// outputs lab, bw, bh [H, W] int32.
extern "C" int cc_fused_launch(const uint8_t* binary, int H, int W, int Hp,
                               int Wp, uint8_t* fg, int32_t* fa, int32_t* fb,
                               int32_t* lab, int32_t* bw, int32_t* bh,
                               int rounds, int prop_steps, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  dim3 block(32, 8);
  dim3 grid((Wp + 31) / 32, (Hp + 7) / 8);
  cc_init_kernel<<<grid, block, 0, stream>>>(binary, H, W, Hp, Wp, fg, fa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int scan_threads = 256;  // 8 warps = 8 lines per block
  const int wpb = scan_threads / 32;
  int32_t* cur = fa;
  int32_t* nxt = fb;
  for (int r = 0; r < rounds; ++r) {
    for (int s = 0; s < prop_steps; ++s) {
      cc_prop8_kernel<<<grid, block, 0, stream>>>(fg, cur, nxt, Hp, Wp);
      int32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
    const int axes[4] = {1, 1, 0, 0};
    const int revs[4] = {0, 1, 0, 1};
    for (int p = 0; p < 4; ++p) {
      int nlines = axes[p] == 1 ? Hp : Wp;
      cc_seg_scan_kernel<<<(nlines + wpb - 1) / wpb, scan_threads, 0,
                           stream>>>(fg, cur, Hp, Wp, axes[p], revs[p]);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 ogrid((W + 31) / 32, (H + 7) / 8);
  cc_finish_kernel<<<ogrid, block, 0, stream>>>(fg, cur, H, W, Hp, Wp, lab,
                                                bw, bh);
  return (int)cudaGetLastError();
}
