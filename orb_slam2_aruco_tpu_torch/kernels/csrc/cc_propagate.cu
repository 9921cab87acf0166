// K4: one sweep of tile-local K-step 8-neighbour min-label propagation.
//
// Replaces orb_slam2_aruco_tpu/ops/pallas_cc.py::cc_propagate_pallas
// (_cc_kernel), the label propagation of the ArUco quad proposal's K4 route
// (detector.py quad_candidates, use_pallas_cc=True). The label image comes
// padded by the caller to tile multiples plus a `halo`-pixel ring, all
// padding set to the sentinel H*W (background). For each tile, a buffer of
// the tile plus its halo is read from the sweep's INPUT and runs `k_steps`
// Jacobi steps over its inner (hb-2) x (hb-2) region, the outer ring held
// fixed:
//
//   new = c < sentinel ? min(c, min of the 8 neighbours) : c
//
// and the tile's interior is written to a separate OUTPUT buffer. No tile
// sees another tile's update within a sweep: this is the Pallas kernel's
// interpret-mode semantics (the TPU runs its grid in order over an aliased
// buffer, so later tiles there read earlier tiles' updates; the two agree
// once labels converge). The output is bit-equal to the interpret-mode
// kernel on every input, converged or not.
//
// Bound: at the path's shape (270x480 padded to 384x512 + a 16-px ring,
// tile 128, 12 tiles) one sweep reads ~0.9 MB and writes ~0.8 MB, and does
// 16 x 8 int32 mins over 160^2 pixels per tile: both well under a
// microsecond of the card's rate, so a sweep is bound by launch latency and
// by its 12 blocks filling only 12 of 132 SMs. The design keeps every step
// in shared memory: one block per tile stages tile + halo once (two
// 160x160 int32 buffers, 200 KB of dynamic shared memory, ping-ponged
// between steps) and touches device memory only to load it and to store the
// interior.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(1024)
cc_propagate_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                    int Wb, int tile, int halo, int k_steps, int sentinel) {
  extern __shared__ int32_t smem[];
  const int hb = tile + 2 * halo;  // square tile + halo buffer side
  int32_t* a = smem;
  int32_t* b = smem + hb * hb;
  const int y0 = blockIdx.y * tile;
  const int x0 = blockIdx.x * tile;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // stage tile + halo in both buffers: the outer ring of each stays fixed
  for (int i = tid; i < hb * hb; i += nthreads) {
    const int y = i / hb;
    const int x = i - y * hb;
    const int32_t v = src[(size_t)(y0 + y) * Wb + x0 + x];
    a[i] = v;
    b[i] = v;
  }
  __syncthreads();

  for (int s = 0; s < k_steps; ++s) {
    for (int y = 1 + threadIdx.y; y < hb - 1; y += blockDim.y) {
      const int32_t* up = a + (y - 1) * hb;
      const int32_t* mid = a + y * hb;
      const int32_t* dn = a + (y + 1) * hb;
      for (int x = 1 + threadIdx.x; x < hb - 1; x += blockDim.x) {
        const int32_t c = mid[x];
        int32_t m = min(min(up[x - 1], up[x]), up[x + 1]);
        m = min(m, min(mid[x - 1], mid[x + 1]));
        m = min(m, min(min(dn[x - 1], dn[x]), dn[x + 1]));
        b[y * hb + x] = c < sentinel ? min(c, m) : c;
      }
    }
    __syncthreads();
    int32_t* t = a;
    a = b;
    b = t;
  }

  for (int i = tid; i < tile * tile; i += nthreads) {
    const int y = i / tile;
    const int x = i - y * tile;
    dst[(size_t)(y0 + halo + y) * Wb + x0 + halo + x] =
        a[(halo + y) * hb + halo + x];
  }
}

}  // namespace

// src, dst: [Hb, Wb] int32, Hb = Hp + 2*halo, Wb = Wp + 2*halo with Hp, Wp
// multiples of `tile`; dst's halo ring is left untouched (the caller fills
// it with the sentinel). One launch = one sweep, grid (Wp/tile, Hp/tile).
extern "C" int cc_propagate_launch(const int32_t* src, int32_t* dst, int Hb,
                                   int Wb, int tile, int halo, int k_steps,
                                   int sentinel, void* stream_ptr) {
  const int hb = tile + 2 * halo;
  const int smem = 2 * hb * hb * (int)sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      cc_propagate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wb - 2 * halo) / tile, (Hb - 2 * halo) / tile);
  dim3 block(32, 32);
  cc_propagate_kernel<<<grid, block, smem, (cudaStream_t)stream_ptr>>>(
      src, dst, Wb, tile, halo, k_steps, sentinel);
  return (int)cudaGetLastError();
}
