// K3: approximate connected components + per-pixel blob bounding box.
//
// Replaces orb_slam2_aruco_tpu/ops/pallas_cc_fused.py::cc_fused
// (_cc_fused_kernel). The same fixed-round algorithm, so the output is
// bit-identical to the TPU kernel whether or not a blob has converged:
// four int32 fields on the padded grid [Hp, Wp] (Hp = ceil(H/8)*8,
// Wp = ceil(W/128)*128), kept interleaved as one int4 per pixel,
//   x = min(y*Wp + x)   -> label, min_y = x / Wp
//   y = min(x*Hp + y)   -> min_x = y / Hp
//   z = max(y*Wp + x)   -> max_y = z / Wp
//   w = max(x*Hp + y)   -> max_x = w / Hp
// go through `rounds` x [`prop_steps` Jacobi 8-neighbour steps, then exact
// inclusive segmented scans: row forward, row backward, column forward,
// column backward]. A segment starts at every background pixel and at every
// foreground pixel whose predecessor in scan order is background or off the
// grid. Min/max over int32 is associative and commutative, so any split of
// a scan into chunks gives the TPU kernel's doubling scan exactly.
// Background pixels hold (Hp*Wp, Hp*Wp, -1, -1) throughout, and a
// foreground pixel's x field never exceeds its own index, so "foreground"
// is read off the x field (x < Hp*Wp) wherever a field is already loaded.
//
// Bound: latency. The fields are 2.2 MB at 272x512 and 8.9 MB at 544x1024,
// read and written in L2 (50 MB), so device memory is not the limit (the
// bound by bytes is 0.5 us and 2 us); the work is a chain of dependent
// phases, each a round trip through L2 and a grid-wide barrier. The design
// is one cooperative launch (cudaLaunchCooperativeKernel; grid = the
// co-resident blocks, capped by the most work units any phase has) whose
// phases are separated by grid.sync(), 3 per round and 8 in all at
// rounds = 3, instead of the 20 launches of a kernel per step:
//
//   J  Jacobi steps: a block stages a 32x32 output tile plus a
//      `prop_steps`-pixel halo of the fields in shared memory (two
//      ping-pong buffers; round 0 builds the initial fields from the binary
//      image here), runs all `prop_steps` steps there and stores the
//      interior to the other global buffer.
//   R  row scans: a warp owns a whole row. It loads it coalesced into
//      shared memory, laid out so lane l holds the contiguous chunk
//      [l*C, l*C + C) at stride CS = C | 1 (odd, so the 16-byte accesses of
//      the chunk walks hit distinct banks), scans its chunk, combines the
//      chunk carries with warp shuffles, rescans; then the backward pass on
//      the same data; then one coalesced store.
//   C  column scans: a block owns a strip of 8 columns; its 256 threads
//      load the strip row by row (8 int4 = one 128-byte line per row) into
//      the same chunked layout, one warp per column runs the row scan's
//      forward and backward passes, and the block stores the strip back
//      (in the last round, the labels and bounding boxes instead).
//
// What the measurements of this kernel taught (phase times from
// %globaltimer on the H100): every staging loop keeps kBatch loads in
// flight; index maps divide by the runtime chunk and tile sizes through a
// multiply-high (FastDiv), since the emulated division cost more than the
// loads; a scan step is written as selects and a min/max (the int4
// conditional compiled to a branch and tripled the walks); the backward
// pass's chunk aggregate is gathered by the forward rescan, so three walks
// over a chunk remain, not four.
//
// Fixed at build time: 256 threads (8 warps, one column line each in C,
// and an 8-column strip whose rows are one 128-byte line), 4 of them owning
// rows in R (so that a 1024-wide row buffer per warp still leaves three
// blocks per SM), and the 32x32 Jacobi tile (36x36 staged with the default
// 2-pixel halo, ~5 pixels per thread per step). Shared memory is the
// largest of the three phases' needs; the launcher refuses sizes the card's
// opt-in limit cannot hold, and Hp, Wp >= 65536 (the range of FastDiv).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kStrip = kWarps;  // columns per block in the column phase
constexpr int kRowWarps = 4;    // warps of a block that own rows
constexpr int kBatch = 8;       // loads in flight per thread when staging

struct CcParams {
  const uint8_t* binary;  // [H, W]
  int4* fa;               // [Hp * Wp] fields, rounds 0, 2, ...
  int4* fb;               // [Hp * Wp] fields, rounds 1, 3, ...
  int32_t* lab;           // [H, W] outputs
  int32_t* bw;
  int32_t* bh;
  int H, W, Hp, Wp;
  int rounds, halo;
  int row_c, row_cs;  // row chunk length and its stride in shared memory
  int col_c, col_cs;  // the same for columns
};

__device__ __forceinline__ int4 agg_identity() {
  return make_int4(INT_MAX, INT_MAX, INT_MIN, INT_MIN);
}

__device__ __forceinline__ int4 agg_comb(int4 p, int4 q) {
  return make_int4(min(p.x, q.x), min(p.y, q.y), max(p.z, q.z),
                   max(p.w, q.w));
}

__device__ __forceinline__ int4 shfl_up4(int4 v, int off) {
  return make_int4(__shfl_up_sync(0xffffffffu, v.x, off),
                   __shfl_up_sync(0xffffffffu, v.y, off),
                   __shfl_up_sync(0xffffffffu, v.z, off),
                   __shfl_up_sync(0xffffffffu, v.w, off));
}

__device__ __forceinline__ int4 shfl_down4(int4 v, int off) {
  return make_int4(__shfl_down_sync(0xffffffffu, v.x, off),
                   __shfl_down_sync(0xffffffffu, v.y, off),
                   __shfl_down_sync(0xffffffffu, v.z, off),
                   __shfl_down_sync(0xffffffffu, v.w, off));
}

// store(i, load(i)) for i = first, first + stride, ... < n, with kBatch
// loads issued before their stores, so that a thread waits for one L2
// round trip per batch instead of one per element.
template <class Load, class Store>
__device__ __forceinline__ void batched_copy(int first, int stride, int n,
                                             Load load, Store store) {
  for (int base = first; base < n; base += stride * kBatch) {
    int4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (base + u * stride < n) v[u] = load(base + u * stride);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (base + u * stride < n) store(base + u * stride, v[u]);
  }
}

// n / d for 0 <= n < 2^16 and 0 < d < 2^16 as a multiply-high by
// ceil(2^32 / d), exact in that range: the index maps below divide by
// runtime chunk and tile sizes once per element.
struct FastDiv {
  unsigned m;
  int d;
  __device__ explicit FastDiv(int d_) : m(0xffffffffu / d_ + 1), d(d_) {}
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)__umulhi((unsigned)n, m);
  }
};

// Shared-memory slot of pixel k of a line: chunk k / C at stride CS.
__device__ __forceinline__ int chunk_slot(int k, const FastDiv& C, int CS) {
  const int q = C.div(k);
  return q * CS + k - q * C.d;
}

// The fields of pixel (y, x) before round 0.
__device__ __forceinline__ int4 initial_fields(const CcParams& p, int y,
                                               int x) {
  const bool on = y < p.H && x < p.W && __ldg(p.binary + (size_t)y * p.W + x);
  const int big = p.Hp * p.Wp;
  const int yx = y * p.Wp + x, xy = x * p.Hp + y;
  return on ? make_int4(yx, xy, yx, xy) : make_int4(big, big, -1, -1);
}

// Phase J: `halo` Jacobi steps on every 32x32 tile, src -> dst (src null:
// the initial fields from the binary image).
__device__ void jacobi_phase(const CcParams& p, const int4* src, int4* dst,
                             int4* smem) {
  const int h = p.halo;
  const int hb = kTile + 2 * h;
  const int big = p.Hp * p.Wp;
  const int tiles_x = p.Wp / kTile;
  const int ntiles = tiles_x * ((p.Hp + kTile - 1) / kTile);
  const int in = hb - 2;  // the inner region, rewritten by each step
  const FastDiv hb_div(hb), in_div(in);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int ty0 = (t / tiles_x) * kTile;
    const int tx0 = (t % tiles_x) * kTile;
    int4* a = smem;
    int4* b = smem + hb * hb;
    batched_copy(
        threadIdx.x, kThreads, hb * hb,
        [&](int i) {
          const int q = hb_div.div(i);
          const int gy = ty0 - h + q;
          const int gx = tx0 - h + i - q * hb;
          if (gy < 0 || gy >= p.Hp || gx < 0 || gx >= p.Wp)
            return agg_identity();  // off the grid: no neighbour
          return src ? __ldcg(src + (size_t)gy * p.Wp + gx)
                     : initial_fields(p, gy, gx);
        },
        [&](int i, int4 v) {
          a[i] = v;
          b[i] = v;
        });
    __syncthreads();
    // both buffers hold the outer ring and every background pixel, which
    // never change; each step rewrites the foreground of the inner region
    for (int s = 0; s < h; ++s) {
      for (int i = threadIdx.x; i < in * in; i += kThreads) {
        const int q = in_div.div(i);
        const int c = (1 + q) * hb + 1 + i - q * in;
        int4 m = a[c];
        if (m.x < big) {
          m = agg_comb(m, agg_comb(agg_comb(a[c - hb - 1], a[c - hb]),
                                   a[c - hb + 1]));
          m = agg_comb(m, agg_comb(a[c - 1], a[c + 1]));
          m = agg_comb(m, agg_comb(agg_comb(a[c + hb - 1], a[c + hb]),
                                   a[c + hb + 1]));
          b[c] = m;
        }
      }
      __syncthreads();
      int4* t2 = a;
      a = b;
      b = t2;
    }
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int y = i / kTile, x = i % kTile;
      if (ty0 + y < p.Hp)
        dst[(size_t)(ty0 + y) * p.Wp + tx0 + x] = a[(h + y) * hb + h + x];
    }
    __syncthreads();  // the next tile restages the buffers
  }
}

// One step of a segmented scan walk: `run` takes in pixel value v, whose
// predecessor in walk order was foreground iff `prev`. Returns whether v
// starts a segment.
// Written as a per-field select of the identity followed by one min/max,
// so that the step compiles to selects and no branch.
__device__ __forceinline__ bool walk(int4 v, int big, bool& prev, int4& run) {
  const bool f = v.x < big;
  const bool st = !f || !prev;
  run.x = min(st ? INT_MAX : run.x, v.x);
  run.y = min(st ? INT_MAX : run.y, v.y);
  run.z = max(st ? INT_MIN : run.z, v.z);
  run.w = max(st ? INT_MIN : run.w, v.w);
  prev = f;
  return st;
}

// Walks chunk[0, n) forward (dir = 1) or backward (dir = -1) with `walk`,
// kWalk elements at a time: their shared-memory loads are issued together,
// so only the min/max chain is serial. With `write`, each element is
// replaced by the running value and `tail` receives the backward walk's
// aggregate of the written values (see scan_line). Returns whether a
// segment started.
constexpr int kWalk = 8;
struct Tail {
  int4 agg;   // min/max of the written values up to the first backward start
  bool done;  // that start has been seen
};
__device__ __forceinline__ void tail_step(Tail& t, const int4& w, bool prev,
                                          bool f, bool first) {
  // element j ends the backward walk's first segment iff it is background
  // or its successor is; that is known when the successor is read
  if (first) {
    t.agg = w;
  } else if (!t.done) {
    if (!prev || !f)
      t.done = true;
    else
      t.agg = agg_comb(t.agg, w);
  }
}
__device__ __forceinline__ bool walk_chunk(int4* chunk, int n, int dir,
                                           int big, bool prev, int4& run,
                                           bool write, Tail* tail) {
  bool started = false;
  int j0 = 0;
  for (; j0 + kWalk <= n; j0 += kWalk) {
    int4 v[kWalk];
#pragma unroll
    for (int u = 0; u < kWalk; ++u)
      v[u] = chunk[dir > 0 ? j0 + u : n - 1 - j0 - u];
#pragma unroll
    for (int u = 0; u < kWalk; ++u) {
      const bool before = prev;
      started |= walk(v[u], big, prev, run);
      if (write) chunk[dir > 0 ? j0 + u : n - 1 - j0 - u] = run;
      if (tail) tail_step(*tail, run, before, prev, j0 + u == 0);
    }
  }
  for (; j0 < n; ++j0) {
    int4& e = chunk[dir > 0 ? j0 : n - 1 - j0];
    const bool before = prev;
    started |= walk(e, big, prev, run);
    if (write) e = run;
    if (tail) tail_step(*tail, run, before, prev, j0 == 0);
  }
  return started;
}

// Forward then backward inclusive segmented scan of one line of L pixels
// held by one warp in shared memory: lane l's chunk [l*C, min(l*C+C, L))
// lies at s + l*CS. Each lane aggregates its chunk, the warp combines the
// chunk carries with shuffles, and each lane rescans its chunk from its
// carry; then the same backward over the forward results, whose chunk
// aggregate the forward rescan has already gathered (the min/max of the
// results from the chunk's start to the first pixel that ends a segment).
__device__ void scan_line(int4* s, int L, int C, int CS, int big) {
  const int lane = threadIdx.x & 31;
  const int k0 = min(lane * C, L);
  const int n = min(k0 + C, L) - k0;
  int4* chunk = s + lane * CS;
  // foreground of the pixels just before and just after the chunk (off the
  // line: background, so the chunk's end pixel starts a segment)
  const bool fg_before = n > 0 && lane > 0 && s[(lane - 1) * CS + C - 1].x < big;
  const bool fg_after = n > 0 && k0 + n < L && s[(lane + 1) * CS].x < big;
  __syncwarp();

  // forward: the chunk's aggregate since its last segment start, and
  // whether it holds a start
  int4 agg = agg_identity();
  bool flag = walk_chunk(chunk, n, 1, big, fg_before, agg, false, nullptr);
  for (int off = 1; off < 32; off <<= 1) {
    const int4 q = shfl_up4(agg, off);
    const bool qf = __shfl_up_sync(0xffffffffu, (int)flag, off) != 0;
    if (lane >= off) {
      if (!flag) agg = agg_comb(q, agg);
      flag = flag || qf;
    }
  }
  int4 run = shfl_up4(agg, 1);
  if (lane == 0) run = agg_identity();
  Tail tail{agg_identity(), false};
  walk_chunk(chunk, n, 1, big, fg_before, run, true, &tail);

  // backward over the forward results: the same, mirrored; the chunk's
  // last pixel ends a segment iff it or the pixel after the chunk is
  // background
  agg = tail.agg;
  flag = n > 0 && (tail.done || chunk[n - 1].x >= big || !fg_after);
  for (int off = 1; off < 32; off <<= 1) {
    const int4 q = shfl_down4(agg, off);
    const bool qf = __shfl_down_sync(0xffffffffu, (int)flag, off) != 0;
    if (lane + off < 32) {
      if (!flag) agg = agg_comb(q, agg);
      flag = flag || qf;
    }
  }
  run = shfl_down4(agg, 1);
  if (lane == 31) run = agg_identity();
  walk_chunk(chunk, n, -1, big, fg_after, run, true, nullptr);
  __syncwarp();
}

// Phase R: every row, forward and backward, in place.
__device__ void row_phase(const CcParams& p, int4* f, int4* smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp >= kRowWarps) return;
  const int C = p.row_c, CS = p.row_cs;
  const FastDiv c_div(C);
  int4* s = smem + warp * 32 * CS;
  // rows spread over the blocks (row y on block y % gridDim.x), so that
  // as many SMs as possible share the staging traffic
  for (int y = warp * gridDim.x + blockIdx.x; y < p.Hp;
       y += gridDim.x * kRowWarps) {
    int4* g = f + (size_t)y * p.Wp;
    batched_copy(
        lane, 32, p.Wp, [&](int k) { return __ldcg(g + k); },
        [&](int k, int4 v) { s[chunk_slot(k, c_div, CS)] = v; });
    __syncwarp();
    scan_line(s, p.Wp, C, CS, p.Hp * p.Wp);
    for (int k = lane; k < p.Wp; k += 32) g[k] = s[chunk_slot(k, c_div, CS)];
    __syncwarp();
  }
}

// Phase C: every column, forward and backward, in place; in the last
// round the labels and bounding boxes are written instead.
__device__ void col_phase(const CcParams& p, int4* f, int4* smem,
                          bool last) {
  const int warp = threadIdx.x / 32;
  const int C = p.col_c, CS = p.col_cs;
  // one int4 of padding between the strip's lines: the 8 threads that
  // stage one row of the strip then hit distinct banks
  const int LS = 32 * CS + 1;
  const FastDiv c_div(C);
  const int big = p.Hp * p.Wp;
  for (int x0 = blockIdx.x * kStrip; x0 < p.Wp; x0 += gridDim.x * kStrip) {
    batched_copy(
        threadIdx.x, kThreads, p.Hp * kStrip,
        [&](int i) {
          return __ldcg(f + (size_t)(i / kStrip) * p.Wp + x0 + i % kStrip);
        },
        [&](int i, int4 v) {
          const int y = i / kStrip, c = i % kStrip;
          smem[c * LS + chunk_slot(y, c_div, CS)] = v;
        });
    __syncthreads();
    scan_line(smem + warp * LS, p.Hp, C, CS, big);
    __syncthreads();
    for (int i = threadIdx.x; i < p.Hp * kStrip; i += kThreads) {
      const int y = i / kStrip, c = i % kStrip;
      const int4 v = smem[c * LS + chunk_slot(y, c_div, CS)];
      if (!last) {
        f[(size_t)y * p.Wp + x0 + c] = v;
      } else if (y < p.H && x0 + c < p.W) {
        const size_t o = (size_t)y * p.W + x0 + c;
        const bool fg = v.x < big;
        p.lab[o] = fg ? v.x : big;
        p.bw[o] = fg ? v.w / p.Hp - v.y / p.Hp + 1 : 0;
        p.bh[o] = fg ? v.z / p.Wp - v.x / p.Wp + 1 : 0;
      }
    }
    __syncthreads();  // the next strip restages the buffer
  }
}

__global__ void __launch_bounds__(kThreads)
cc_fused_kernel(const CcParams p) {
  extern __shared__ int4 smem[];
  cg::grid_group grid = cg::this_grid();
  for (int r = 0; r < p.rounds; ++r) {
    const int4* src = r == 0 ? nullptr : (r % 2 ? p.fa : p.fb);
    int4* dst = r % 2 ? p.fb : p.fa;
    jacobi_phase(p, src, dst, smem);
    grid.sync();
    row_phase(p, dst, smem);
    grid.sync();
    const bool last = r == p.rounds - 1;
    col_phase(p, dst, smem, last);
    if (!last) grid.sync();
  }
}

int scan_stride(int L) { return ((L + 31) / 32) | 1; }

// How many blocks of the kernel with `smem` bytes of dynamic shared memory
// the current device holds at once (cooperative launches need them all
// resident). The device queries and the occupancy calculation cost tens of
// microseconds of host time, so the answer is kept per (device, smem). The
// kernel's shared-memory limit only ever grows, to the largest size asked
// for on the device, so that every cached size stays launchable.
cudaError_t co_resident_blocks(size_t smem, int* blocks) {
  struct Entry {
    int dev;
    size_t smem;
    int blocks;  // 0: the entry records the shared-memory limit set
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Entry* limit = nullptr;
  for (Entry& e : cache) {
    if (e.dev == dev && e.blocks == 0) limit = &e;
    if (e.dev == dev && e.blocks > 0 && e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  }
  int sms, optin, per_sm;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (!limit || limit->smem < smem) {
    err = cudaFuncSetAttribute(cc_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (limit)
      limit->smem = smem;
    else
      cache.push_back(Entry{dev, smem, 0});
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cc_fused_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  cache.push_back(Entry{dev, smem, per_sm * sms});
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// binary [H, W] uint8; fields: scratch of 2 * Hp * Wp int4 (16-byte
// aligned); outputs lab, bw, bh [H, W] int32. One cooperative launch.
extern "C" int cc_fused_launch(const uint8_t* binary, int H, int W, int Hp,
                               int Wp, int32_t* fields, int32_t* lab,
                               int32_t* bw, int32_t* bh, int rounds,
                               int prop_steps, void* stream_ptr) {
  if (rounds < 1 || prop_steps < 0 || Hp % 8 || Wp % 128 || Hp >= 65536 ||
      Wp >= 65536 || (long long)Hp * Wp > INT_MAX)
    return (int)cudaErrorInvalidValue;
  CcParams p;
  p.binary = binary;
  p.fa = reinterpret_cast<int4*>(fields);
  p.fb = p.fa + (size_t)Hp * Wp;
  p.lab = lab;
  p.bw = bw;
  p.bh = bh;
  p.H = H;
  p.W = W;
  p.Hp = Hp;
  p.Wp = Wp;
  p.rounds = rounds;
  p.halo = prop_steps;
  p.row_c = (Wp + 31) / 32;
  p.row_cs = scan_stride(Wp);
  p.col_c = (Hp + 31) / 32;
  p.col_cs = scan_stride(Hp);
  const int hb = kTile + 2 * prop_steps;
  size_t smem = 2 * (size_t)hb * hb;
  if ((size_t)kRowWarps * 32 * p.row_cs > smem)
    smem = (size_t)kRowWarps * 32 * p.row_cs;
  if ((size_t)kStrip * (32 * p.col_cs + 1) > smem)
    smem = (size_t)kStrip * (32 * p.col_cs + 1);
  smem *= sizeof(int4);

  int resident;
  cudaError_t err = co_resident_blocks(smem, &resident);
  if (err != cudaSuccess) return (int)err;
  // every block is co-resident; no phase has work for more blocks than this
  const int tiles = (Wp / kTile) * ((Hp + kTile - 1) / kTile);
  int work = tiles;
  if ((Hp + kRowWarps - 1) / kRowWarps > work)
    work = (Hp + kRowWarps - 1) / kRowWarps;
  if (Wp / kStrip > work) work = Wp / kStrip;
  const int blocks = resident < work ? resident : work;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)cc_fused_kernel, blocks,
                                    kThreads, args, smem,
                                    (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
