// K4: one sweep of tile-local K-step 8-neighbour min-label propagation.
//
// Replaces orb_slam2_aruco_tpu/ops/pallas_cc.py::cc_propagate_pallas
// (_cc_kernel), the label propagation of the ArUco quad proposal's K4 route
// (detector.py quad_candidates, use_pallas_cc=True). Labels are [H, W]
// int32, background = the sentinel H*W. The image is cut into tile x tile
// tiles (the last ones ragged); each tile's buffer is the tile plus a
// `halo`-pixel ring, read from the sweep's INPUT, where every pixel outside
// the image reads as the sentinel (the TPU kernel's padded copy, without
// the copy: padding pixels are never updated, `c < sentinel` being false,
// and only act as background). The buffer runs `k_steps` Jacobi steps over
// its inner (hb-2) x (hb-2) region, the outer ring held fixed:
//
//   new = c < sentinel ? min(c, min of the 8 neighbours) : c
//
// and the tile's interior is written to the separate, unpadded OUTPUT. No
// tile sees another tile's update within a sweep: this is the Pallas
// kernel's interpret-mode semantics (the TPU runs its grid in order over an
// aliased buffer, so later tiles there read earlier tiles' updates; the two
// agree once labels converge). The output is bit-equal to the
// interpret-mode kernel on every input, converged or not.
//
// Bound: at the path's shape (270x480, tile 128, halo 16: 12 tiles of a
// 160x160 buffer) one sweep reads and writes 0.5 MB and does 16 x 8 int32
// mins over 158^2 pixels per tile, both well under a microsecond of the
// card's rates: a sweep is bound by latency (16 dependent steps, each a
// barrier) and by how many SMs take part. One block per tile filled 12 of
// 132 SMs. Design: a thread-block cluster of 8 CTAs per tile (96 CTAs at
// 270x480, 320 at 540x960). CTA q owns a band of R = ceil(hb/8) buffer
// rows and holds it in shared memory with `exchange` (g) ghost rows above
// and below, in two ping-pong buffers. Every step updates all its rows but
// the outermost ghost rows, which stay fixed: the error of a fixed edge
// travels one row per step, so after g steps the band itself is exact.
// Then each CTA writes its first and last g band rows into its neighbours'
// inboxes through distributed shared memory, one cluster barrier publishes
// them, and each CTA copies its inbox into its ghost rows. g = 1 trades rows
// every step; g = k_steps never trades (independent overlapped bands, ~2.5x
// the work at tile 128, k 16). A step is a separable 3x3 minimum in
// registers: a thread loads the three-pixel row minima of its few rows (all
// loads issued before any is used) and takes the column minimum of three.
// Device memory is touched only to stage the rows and to store the tile's
// interior.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // CTAs per tile
constexpr int kMaxRows = 12;  // rows per thread and step

__global__ void __launch_bounds__(1024)
cc_propagate_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                    int H, int W, int tile, int halo, int k_steps, int g,
                    int tiles_x) {
  extern __shared__ int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int hb = tile + 2 * halo;  // buffer side
  const int R = (hb + kCluster - 1) / kCluster;
  const int q = (int)cluster.block_rank();
  const int y_first = q * R;       // first buffer row of the band
  const int n = max(0, min(R, hb - y_first));
  const int L = R + 2 * g;         // local rows: g ghosts, band, g ghosts
  const int y0 = y_first - g;      // buffer row of local row 0
  const int32_t sentinel = H * W;
  const int t = blockIdx.x / kCluster;
  const int tile_y = t / tiles_x;
  const int gy0 = tile_y * tile - halo;  // image row of buffer row 0
  const int gx0 = (t - tile_y * tiles_x) * tile - halo;
  const int x = threadIdx.x;
  int32_t* a = smem;
  int32_t* b = a + L * hb;
  int32_t* inbox = b + L * hb;     // [2 parities][g rows above, g below]

  if (x < hb) {
    const int gx = gx0 + x;
    for (int j = threadIdx.y; j < n + 2 * g; j += blockDim.y) {
      const int y = y0 + j;
      if (y < 0 || y >= hb) continue;
      const int gy = gy0 + y;
      const int32_t v = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                            ? src[(size_t)gy * W + gx] : sentinel;
      a[j * hb + x] = v;
      b[j * hb + x] = v;
    }
  }
  cluster.sync();

  // this thread's local rows [j_lo, j_lo + cnt) within [1, n + 2g - 1)
  const int rows = max(0, n + 2 * g - 2);
  const int per = (rows + blockDim.y - 1) / blockDim.y;
  const int j_lo = 1 + threadIdx.y * per;
  const int cnt = max(0, min(per, rows + 1 - j_lo));
  const bool active = x >= 1 && x <= hb - 2 && cnt > 0;
  const bool has_up = q > 0 && n > 0;
  const bool has_dn = n > 0 && y_first + n < hb;
  int32_t* up = has_up ? cluster.map_shared_rank(inbox, q - 1) : nullptr;
  int32_t* dn = has_dn ? cluster.map_shared_rank(inbox, q + 1) : nullptr;
  for (int s = 0, blk = 0; s < k_steps; ++blk) {
    if (blk > 0) {
      // the neighbours' rows of the last exchange become the ghost rows
      // (the ring columns 0 and hb - 1 never change and are not sent)
      const int32_t* box = inbox + (blk & 1) * 2 * g * hb;
      for (int i = threadIdx.y; i < g && x >= 1 && x <= hb - 2;
           i += blockDim.y) {
        if (has_up) a[i * hb + x] = box[i * hb + x];
        if (has_dn) a[(n + g + i) * hb + x] = box[(g + i) * hb + x];
      }
      __syncthreads();
    }
    const int steps = min(g, k_steps - s);
    for (int i = 0; i < steps; ++i) {
      if (active) {
        int32_t h[kMaxRows + 2], c[kMaxRows + 2];
        const int32_t* r0 = a + (j_lo - 1) * hb + x;
#pragma unroll
        for (int r = 0; r < kMaxRows + 2; ++r) {
          if (r < cnt + 2) {
            c[r] = r0[r * hb];
            h[r] = min(min(r0[r * hb - 1], c[r]), r0[r * hb + 1]);
          }
        }
#pragma unroll
        for (int r = 1; r <= kMaxRows; ++r) {
          const int y = y0 + j_lo - 1 + r;
          if (r <= cnt && y >= 1 && y <= hb - 2)
            b[(j_lo - 1 + r) * hb + x] =
                c[r] < sentinel ? min(min(h[r - 1], h[r]), h[r + 1]) : c[r];
        }
      }
      __syncthreads();
      int32_t* tmp = a;
      a = b;
      b = tmp;
    }
    s += steps;
    if (s < k_steps) {
      // send the first g band rows (local g..2g-1) to the upper
      // neighbour's rows from below (its inbox rows g..2g-1) and the last
      // g (local n..n+g-1) to the lower neighbour's rows from above (its
      // inbox rows 0..g-1), in the next parity; the barrier publishes them
      const int next = ((blk + 1) & 1) * 2 * g * hb;
      if (active) {
        for (int j = j_lo; j < j_lo + cnt; ++j) {
          if (up && j >= g && j < 2 * g)
            up[next + j * hb + x] = a[j * hb + x];
          if (dn && j >= n && j < n + g)
            dn[next + (j - n) * hb + x] = a[j * hb + x];
        }
      }
      cluster.sync();
    }
  }

  // the tile's interior rows of the band, from the last step's buffer
  if (x < halo || x >= halo + tile || gx0 + x >= W) return;
  for (int j = g + threadIdx.y; j < g + n; j += blockDim.y) {
    const int y = y0 + j;
    const int gy = gy0 + y;
    if (y >= halo && y < halo + tile && gy < H)
      dst[(size_t)gy * W + gx0 + x] = a[j * hb + x];
  }
}

}  // namespace

// src, dst: [H, W] int32 (dst is written at every pixel). One launch = one
// sweep: a cluster of 8 CTAs per tile over ceil(H/tile) x ceil(W/tile)
// tiles, trading `exchange` ghost rows between neighbouring CTAs every
// `exchange` steps (1 <= exchange <= ceil((tile + 2 halo) / 8)).
extern "C" int cc_propagate_launch(const int32_t* src, int32_t* dst, int H,
                                   int W, int tile, int halo, int k_steps,
                                   int exchange, void* stream) {
  static int smem_set = 48 * 1024;  // dynamic shared memory opted into
  const int hb = tile + 2 * halo;
  const int R = (hb + kCluster - 1) / kCluster;
  const int g = exchange;
  const int threads_x = (hb + 31) / 32 * 32;
  if (H < 1 || W < 1 || tile < 1 || halo < 0 || k_steps < 0 || g < 1 ||
      g > R || threads_x > 1024)
    return (int)cudaErrorInvalidValue;
  // threads per column: as many as fit, each with at most kMaxRows rows
  const int rows = R + 2 * g - 2;
  const int groups = min(1024 / threads_x, max(1, rows));
  if ((rows + groups - 1) / groups > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const int smem = (2 * (R + 2 * g) + 4 * g) * hb * (int)sizeof(int32_t);
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        cc_propagate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int tiles_x = (W + tile - 1) / tile;
  const int tiles = tiles_x * ((H + tile - 1) / tile);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * kCluster);
  cfg.blockDim = dim3(threads_x, groups);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, cc_propagate_kernel, src, dst, H,
                                       W, tile, halo, k_steps, g, tiles_x);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
