// K5: the pose-only Levenberg-Marquardt of optim/pose_opt.py in one launch.
//
// Replaces no TPU kernel: the JAX package runs optim/pose_opt.py's
// optimize_pose as one jitted XLA program (a fori_loop of rounds around a
// while_loop of LM iterations), which on the TPU is already one dispatch.
// In eager PyTorch the same loop is ~180 small operations an iteration,
// ~7400 kernels a call, each costing ~12 us of host launch time for 1-2 us
// of device work: the tracking cascade's two calls a frame were ~80 % of a
// localized frame. This kernel runs the whole call, `rounds` x
// `iters` iterations, in one launch.
//
// Bound: latency. A call is ~1 064 edges (1 000 keypoint slots and 4 x 16
// marker corners) of ~150 float32 operations each per pass, 0.2 MFLOP a
// pass and ~10 MFLOP a call; the edge inputs are 34 KB, read from L1 after
// the first pass. What is left is a chain of ~40 dependent 6x6 solves,
// each behind a block-wide reduction. So the design is one CTA that holds
// the whole problem: no grid-wide synchronization, no device-memory round
// trip between iterations, no host involvement until the caller reads the
// result.
//
// One CTA, kThreads threads (256 up to 2048 edges, 512 above: the block
// size follows from E = N + 4A, an input shape). Thread i owns edges i,
// i + kThreads, ...: point edges 0..N-1 and marker-corner edges N..E-1,
// read from the caller's arrays as they are (no concatenation). Per LM
// iteration:
//   1. thread 0 solves (H + lam*clamp(diag H, 1e-10) + 1e-10*I) dx = b with
//      the JAX package's unrolled Cholesky (optim/lm.py small_spd_solve:
//      pivots clamped at 1e-12; a non-finite entry of dx becomes 0), applies
//      se3_exp and se3_compose (geometry/lie.py order) and publishes the
//      candidate pose in shared memory;
//   2. every thread computes, for its edges at the candidate pose, the
//      residual, the weight (Huber IRLS in rounds 0-1, zero where the
//      camera-frame depth is <= 0.05), the 2x6 Jacobian, and accumulates
//      the 21 upper entries of J^T W J, the 6 of J^T W r and chi2;
//   3. the 28 sums are reduced with warp shuffles, then across warps in
//      shared memory in warp order (a fixed order: a run repeats bit for
//      bit);
//   4. thread 0 accepts or rejects (optim/pose_opt.py's rule, lam x0.5 /
//      x4 clamped to [1e-9, 1e6], the stall count). An accepted candidate
//      brings its H and b with it, so the next iteration needs no second
//      pass over the edges: H and b are a function of the pose within a
//      round, whose weights are fixed.
// A round stops once two iterations in a row fail to improve chi2 by
// 1e-5 (the JAX while_loop's rule; the plain PyTorch version masks those
// iterations off, with the same poses). At the start of each round after
// the first, every thread reclassifies its point edges at the current pose
// (r^2 * inv_sigma2 < chi2_th) into the `inliers` output, which holds the
// flags between passes; a last pass reclassifies at the final pose, sums
// the final chi2 and counts the inliers. Thread 0 writes the pose, its
// rotation projected onto SO(3) through a unit quaternion
// (geometry/lie.py orthonormalize). Everything is float32 (FMA
// contraction as nvcc does by default); only the order of the sums differs
// from the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSums = 28;    // 21 entries of H (upper, row-major), 6 of b, chi2
constexpr int kChi2 = 27;

struct PoseLmArgs {
  const float* R0;         // [3, 3]
  const float* t0;         // [3]
  const float* cam[4];     // fx, fy, cx, cy: 0-d tensors
  const float* pts;        // [N, 3] world points
  const float* uv;         // [N, 2] observed pixels
  const bool* mask;        // [N]
  const float* inv_s2;     // [N]
  const float* mk_pts;     // [A, 4, 3] marker corners in the world
  const float* mk_uv;      // [A, 4, 2]
  const bool* mk_mask;     // [A]
  int N, A;
  float marker_weight, chi2_th, huber_delta, lam0;
  int rounds, iters;
  float* R_out;            // [3, 3]
  float* t_out;            // [3]
  uint8_t* inliers;        // [N] bool: the flags between passes, then out
  int64_t* n_inliers;      // []
  float* chi2_out;         // []
};

struct Pose {
  float R[9];
  float t[3];
};

// One edge at pose P: the residual r = z - proj(R X + t) and the camera
// point p (optim/residuals.py reproj_residual), returned through r0, r1, p.
__device__ __forceinline__ void residual(const Pose& P, const float* cam,
                                         float X0, float X1, float X2,
                                         float Z0, float Z1, float& r0,
                                         float& r1, float* p) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    p[j] = fmaf(X2, P.R[3 * j + 2], fmaf(X1, P.R[3 * j + 1], X0 * P.R[3 * j]))
           + P.t[j];
  const float z = fabsf(p[2]) < 1e-9f ? 1e-9f : p[2];
  r0 = Z0 - (cam[0] * p[0] / z + cam[2]);
  r1 = Z1 - (cam[1] * p[1] / z + cam[3]);
}

// Adds one edge of weight w at pose P to the 28 sums: its J^T W J, J^T W r
// and chi2 (optim/residuals.py jac_pose, huber_weight).
__device__ __forceinline__ void add_edge(const Pose& P, const float* cam,
                                         float X0, float X1, float X2,
                                         float Z0, float Z1, float w,
                                         bool huber, float delta,
                                         float* acc) {
  float r0, r1, p[3];
  residual(P, cam, X0, X1, X2, Z0, Z1, r0, r1, p);
  const float chi2_e = (r0 * r0 + r1 * r1) * w;
  acc[kChi2] += chi2_e;
  float wt = w;
  if (huber) {
    const float rr = sqrtf(fmaxf(chi2_e, 1e-18f));
    wt = w * (rr <= delta ? 1.0f : delta / rr);
  }
  if (p[2] <= 0.05f) wt = 0.0f;
  const float z = fabsf(p[2]) < 1e-9f ? 1e-9f : p[2];
  const float iz = 1.0f / z;
  const float iz2 = iz * iz;
  const float a = cam[0] * iz, c = -cam[0] * p[0] * iz2;
  const float b = cam[1] * iz, d = -cam[1] * p[1] * iz2;
  // -(dproj/dp @ [I | -hat(p)]), rows u and v
  const float J0[6] = {-a, 0.0f, -c, -(c * p[1]), -(a * p[2] - c * p[0]),
                       a * p[1]};
  const float J1[6] = {0.0f, -b, -d, -(d * p[1] - b * p[2]), d * p[0],
                       -(b * p[0])};
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float w0 = J0[i] * wt, w1 = J1[i] * wt;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += fmaf(w1, J1[j], w0 * J0[j]);
    acc[21 + i] += fmaf(w1, r1, w0 * r0);
  }
}

// Sums v[0..K) over the block. Every thread calls it; the totals land in
// lane 0 of warp 0 (thread 0), in a fixed order: a butterfly within each
// warp, then warp 0's lanes add the warps' partials in warp order.
template <int K, int kWarps>
__device__ __forceinline__ void block_sum(float* v, float (*red)[kSums]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.0f;
    if (lane < K) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][lane];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __shfl_sync(0xffffffffu, s, k);
  }
}

// (H + lam * clamp(diag H, 1e-10) + 1e-10 I) dx = b by the JAX package's
// unrolled Cholesky (optim/lm.py small_spd_solve, solve_damped); H holds
// the upper triangle row-major.
__device__ __forceinline__ void solve_damped(const float* H, const float* b,
                                             float lam, float* dx) {
  float A[6][6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = A[j][i] = H[k++];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    A[i][i] = (A[i][i] + lam * fmaxf(A[i][i], 1e-10f)) + 1e-10f;
  float L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) s = s - L[i][m] * L[j][m];
      L[i][j] = i == j ? sqrtf(fmaxf(s, 1e-12f)) : s / L[j][j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int m = 0; m < i; ++m) s = s - L[i][m] * y[m];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s = s - L[m][i] * dx[m];
    dx[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (!isfinite(dx[i])) dx[i] = 0.0f;
}

__device__ __forceinline__ void hat(const float* w, float* W) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

__device__ __forceinline__ void matmul3(const float* A, const float* B,
                                        float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = fmaf(A[3 * i + 2], B[6 + j],
                          fmaf(A[3 * i + 1], B[3 + j], A[3 * i] * B[j]));
}

// The candidate exp(dx) * (R, t) (geometry/lie.py se3_exp, se3_compose).
__device__ __forceinline__ void se3_step(const float* dx, const Pose& P,
                                         Pose& out) {
  const float* v = dx;
  const float* w = dx + 3;
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta2 < 1e-8f;
  const float theta2_safe = small ? 1.0f : theta2;
  const float theta = sqrtf(theta2_safe);
  const float s = sinf(theta), co = cosf(theta);
  const float a = small ? 1.0f - theta2 / 6.0f : s / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - co) / theta2_safe;
  const float c = small ? 1.0f / 6.0f - theta2 / 120.0f
                        : (theta - s) / (theta2_safe * theta);
  float W[9], WW[9], dR[9], V[9];
  hat(w, W);
  matmul3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
    dR[i] = (eye + a * W[i]) + b * WW[i];
    V[i] = (eye + b * W[i]) + c * WW[i];
  }
  float dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dt[i] = fmaf(V[3 * i + 2], v[2], fmaf(V[3 * i + 1], v[1], V[3 * i] * v[0]));
  matmul3(dR, P.R, out.R);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out.t[i] = fmaf(dR[3 * i + 2], P.t[2],
                    fmaf(dR[3 * i + 1], P.t[1], dR[3 * i] * P.t[0])) + dt[i];
}

// R projected onto SO(3) through a unit quaternion (geometry/lie.py
// rot_to_quat, quat_to_rot).
__device__ void orthonormalize(const float* m, float* out) {
  const float qw2 = fmaxf(1.0f + m[0] + m[4] + m[8], 0.0f);
  const float qx2 = fmaxf(1.0f + m[0] - m[4] - m[8], 0.0f);
  const float qy2 = fmaxf(1.0f - m[0] + m[4] - m[8], 0.0f);
  const float qz2 = fmaxf(1.0f - m[0] - m[4] + m[8], 0.0f);
  const float cand[4][4] = {
      {qw2, m[7] - m[5], m[2] - m[6], m[3] - m[1]},
      {m[7] - m[5], qx2, m[1] + m[3], m[2] + m[6]},
      {m[2] - m[6], m[1] + m[3], qy2, m[5] + m[7]},
      {m[3] - m[1], m[2] + m[6], m[5] + m[7], qz2}};
  const float piv[4] = {qw2, qx2, qy2, qz2};
  int k = 0;
  for (int i = 1; i < 4; ++i)
    if (piv[i] > piv[k]) k = i;
  float q[4];
  float n2 = 0.0f;
  for (int i = 0; i < 4; ++i) {
    q[i] = cand[k][i];
    n2 += q[i] * q[i];
  }
  float n = fmaxf(sqrtf(n2), 1e-8f);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
  const float sgn = q[0] < 0.0f ? -1.0f : 1.0f;
  n2 = 0.0f;
  for (int i = 0; i < 4; ++i) {
    q[i] = q[i] * sgn;
    n2 += q[i] * q[i];
  }
  n = fmaxf(sqrtf(n2), 1e-8f);
  const float w = q[0] / n, x = q[1] / n, y = q[2] / n, z = q[3] / n;
  out[0] = 1.0f - 2.0f * (y * y + z * z);
  out[1] = 2.0f * (x * y - w * z);
  out[2] = 2.0f * (x * z + w * y);
  out[3] = 2.0f * (x * y + w * z);
  out[4] = 1.0f - 2.0f * (x * x + z * z);
  out[5] = 2.0f * (y * z - w * x);
  out[6] = 2.0f * (x * z - w * y);
  out[7] = 2.0f * (y * z + w * x);
  out[8] = 1.0f - 2.0f * (x * x + y * y);
}

// Mode of a pass over the edges.
enum Pass { kCandidate, kRoundStart, kFinal };

// One pass over this thread's edges at pose P. kCandidate and kRoundStart
// add every edge's terms to acc; kFinal adds its chi2 to acc[0] and the
// inliers to acc[1]. `reclassify` (the start of rounds 1.., and kFinal
// after any round) first classifies each point edge at P and keeps the
// flag in `inliers`, where the other passes of the round read it
// (`flagged`; round 0 weighs every edge as an inlier). kFinal leaves
// inlier & mask there.
template <int kThreads>
__device__ __forceinline__ void edge_pass(const PoseLmArgs& a, const Pose& P,
                                          const float* cam, Pass mode,
                                          bool reclassify, bool flagged,
                                          bool huber, float* acc) {
  const int E = a.N + 4 * a.A;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const bool point = e < a.N;
    const int k = point ? e : e - a.N;
    const float* X = point ? a.pts + 3 * k : a.mk_pts + 3 * k;
    const float* Z = point ? a.uv + 2 * k : a.mk_uv + 2 * k;
    float r2 = 0.0f;
    if (mode == kFinal || (point && reclassify)) {
      float r0, r1, p[3];
      residual(P, cam, X[0], X[1], X[2], Z[0], Z[1], r0, r1, p);
      r2 = r0 * r0 + r1 * r1;
    }
    float w;
    if (point) {
      const float m = a.mask[k] ? 1.0f : 0.0f;
      float inl = 1.0f;
      if (reclassify) {
        inl = r2 * a.inv_s2[k] < a.chi2_th ? 1.0f : 0.0f;
        if (mode != kFinal) a.inliers[k] = inl > 0.0f;
      } else if (flagged) {
        inl = a.inliers[k] ? 1.0f : 0.0f;
      }
      w = (m * inl) * a.inv_s2[k];
      if (mode == kFinal) {
        const bool out = inl > 0.0f && m > 0.0f;
        a.inliers[k] = out;
        acc[1] += out ? 1.0f : 0.0f;
      }
    } else {
      w = (a.mk_mask[k >> 2] ? 1.0f : 0.0f) * a.marker_weight;
    }
    if (mode == kFinal)
      acc[0] += r2 * w;
    else
      add_edge(P, cam, X[0], X[1], X[2], Z[0], Z[1], w, huber, a.huber_delta,
               acc);
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const __grid_constant__ PoseLmArgs a) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float red[kWarps][kSums];
  __shared__ Pose cur, cand;
  __shared__ float cam[4];
  __shared__ int stop;
  const bool lead = threadIdx.x == 0;
  if (lead) {
    for (int i = 0; i < 9; ++i) cur.R[i] = a.R0[i];
    for (int i = 0; i < 3; ++i) cur.t[i] = a.t0[i];
    for (int i = 0; i < 4; ++i) cam[i] = *a.cam[i];
  }
  __syncthreads();
  // thread 0's LM state: H and b at the current pose, chi2, lam, stall
  float H[21], b[6], chi2_cur = 0.0f, lam = a.lam0;
  int stall = 0;
  float acc[kSums];
  for (int rd = 0; rd < a.rounds; ++rd) {
    const bool huber = rd < 2;
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    edge_pass<kThreads>(a, cur, cam, kRoundStart, rd > 0, false, huber,
                        acc);
    block_sum<kSums, kWarps>(acc, red);
    if (lead) {
#pragma unroll
      for (int k = 0; k < 21; ++k) H[k] = acc[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) b[k] = -acc[21 + k];
      chi2_cur = acc[kChi2];
      lam = a.lam0;
      stall = 0;
    }
    for (int it = 0; it < a.iters; ++it) {
      if (lead) {
        stop = stall >= 2;
        if (!stop) {
          float dx[6];
          solve_damped(H, b, lam, dx);
          se3_step(dx, cur, cand);
        }
      }
      __syncthreads();
      if (stop) break;
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
      edge_pass<kThreads>(a, cand, cam, kCandidate, false, rd > 0, huber,
                          acc);
      block_sum<kSums, kWarps>(acc, red);
      if (lead) {
        const float chi2_new = acc[kChi2];
        const bool accept = chi2_new < chi2_cur;
        const bool improved = chi2_new < chi2_cur * (1.0f - 1e-5f);
        if (accept) {
          cur = cand;
#pragma unroll
          for (int k = 0; k < 21; ++k) H[k] = acc[k];
#pragma unroll
          for (int k = 0; k < 6; ++k) b[k] = -acc[21 + k];
          chi2_cur = chi2_new;
        }
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-9f), 1e6f);
        stall = improved ? 0 : stall + 1;
      }
    }
    __syncthreads();
  }
  acc[0] = acc[1] = 0.0f;
  edge_pass<kThreads>(a, cur, cam, kFinal, a.rounds > 0, false, false, acc);
  block_sum<2, kWarps>(acc, red);
  if (lead) {
    orthonormalize(cur.R, a.R_out);
    for (int i = 0; i < 3; ++i) a.t_out[i] = cur.t[i];
    *a.chi2_out = acc[0];
    *a.n_inliers = (int64_t)acc[1];
  }
}

}  // namespace

// One pose LM (optim/pose_opt.py optimize_pose) on the given stream; A = 0
// takes no marker arrays. Outputs: R_out [3, 3],
// t_out [3], inliers [N] bool, n_inliers int64, chi2_out float32.
extern "C" int pose_lm_launch(
    const float* R0, const float* t0, const float* fx, const float* fy,
    const float* cx, const float* cy, const float* pts, const float* uv,
    const bool* mask, const float* inv_s2, int N, const float* mk_pts,
    const float* mk_uv, const bool* mk_mask, int A,
    float marker_weight, float chi2_th, float huber_delta, float lam0,
    int rounds, int iters, float* R_out, float* t_out, uint8_t* inliers,
    int64_t* n_inliers, float* chi2_out, void* stream) {
  if (N < 0 || A < 0 || rounds < 0 || iters < 0 ||
      (long long)N + 4LL * A >= (1LL << 24))
    return (int)cudaErrorInvalidValue;
  PoseLmArgs a = {};
  a.R0 = R0; a.t0 = t0;
  a.cam[0] = fx; a.cam[1] = fy; a.cam[2] = cx; a.cam[3] = cy;
  a.pts = pts; a.uv = uv; a.mask = mask; a.inv_s2 = inv_s2;
  a.mk_pts = mk_pts; a.mk_uv = mk_uv; a.mk_mask = mk_mask;
  a.N = N; a.A = A;
  a.marker_weight = marker_weight; a.chi2_th = chi2_th;
  a.huber_delta = huber_delta; a.lam0 = lam0;
  a.rounds = rounds; a.iters = iters;
  a.R_out = R_out; a.t_out = t_out; a.inliers = inliers;
  a.n_inliers = n_inliers; a.chi2_out = chi2_out;
  cudaStream_t s = (cudaStream_t)stream;
  if (N + 4 * A <= 2048)
    pose_lm_kernel<256><<<1, 256, 0, s>>>(a);
  else
    pose_lm_kernel<512><<<1, 512, 0, s>>>(a);
  return (int)cudaGetLastError();
}
