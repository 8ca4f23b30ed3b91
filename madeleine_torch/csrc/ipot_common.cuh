// Device code shared by the IPOT forward (K8), its backward (K9) and the GW
// gamma loop (K10): one block owns one transport problem and walks it with
// row and column passes, plus an f32 block GEMM for K10.
//
// One IPOT iteration with uniform marginals (madeleine_tpu/ops/ipot.py::_step):
//   Q = A o T;  u = rowsum(Q o sigma^T);  delta = 1 / (n u)
//   a = colsum(Q o delta);  sigma' = 1 / (m a);  T' = (delta o Q) o sigma'^T
// with A = exp(-C / beta). A problem's A and T (2 x n x m f32, 512 KB at
// 256 x 256) do not fit one SM, so both live in device memory (L2 for the
// blocks in flight); delta and sigma live in shared memory.
//
// Exact f32 throughout: IEEE division and expf (no fast math), products in
// the order of the JAX loop. Every sum runs in a fixed order with no atomics
// (a warp per row: lanes stride the row, then a butterfly; a column pass:
// GROUPS row groups each summed in order, then the groups in order), so two
// launches give bitwise-equal results. Buffers that a kernel writes and then
// reads back (A, T, the GEMM operands) carry no __restrict__: the read-only
// cache path that it allows is coherent only between launches.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace madeleine_ipot {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int COLW = 128;                 // columns per chunk of a column pass
constexpr int GROUPS = THREADS / COLW;    // row groups of a column pass

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A = exp(-C / beta) over one problem.
__device__ __forceinline__ void exp_cost(const float* __restrict__ C, float* __restrict__ A,
                                         size_t nm, float beta) {
  for (size_t e = threadIdx.x; e < nm; e += THREADS) A[e] = expf(-C[e] / beta);
}

// Row pass of one iteration. On entry delta holds the previous iteration's
// delta and sigma this iteration's sigma. Each element becomes
//   t = first ? 1 : (delta_prev_i * (A_ij * Tin_ij)) * sigma_j   -> Tout_ij
// (the previous iteration's update, T_0 = 1), then, when want_delta,
//   delta_i = 1 / (n * sum_j (A_ij * t) * sigma_j).
// Tout may equal Tin: each element is read and written by one thread.
__device__ __forceinline__ void row_pass(const float* A, const float* Tin,
                                         float* Tout, float* delta, const float* sigma,
                                         int n, int m, bool first, bool want_delta) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += WARPS) {
    const float dp = first ? 0.f : delta[i];
    const float* Ar = A + (size_t)i * m;
    const float* Tr = Tin + (size_t)i * m;
    float* Or = Tout + (size_t)i * m;
    float acc = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float a = Ar[j];
      const float t = first ? 1.f : (dp * (a * Tr[j])) * sigma[j];
      Or[j] = t;
      acc += (a * t) * sigma[j];
    }
    acc = warp_sum(acc);
    if (want_delta && lane == 0) delta[i] = 1.f / ((float)n * acc);
  }
}

// Column pass: sigma_j = 1 / (m * sum_i (A_ij * T_ij) * delta_i).
// part: GROUPS * COLW floats of shared memory. Ends with a barrier.
__device__ __forceinline__ void col_pass(const float* A, const float* T,
                                         const float* delta, float* sigma, float* part,
                                         int n, int m) {
  const int c = threadIdx.x % COLW, g = threadIdx.x / COLW;
  for (int j0 = 0; j0 < m; j0 += COLW) {
    const int j = j0 + c;
    float acc = 0.f;
    if (j < m)
      for (int i = g; i < n; i += GROUPS) {
        const size_t e = (size_t)i * m + j;
        acc += (A[e] * T[e]) * delta[i];
      }
    part[g * COLW + c] = acc;
    __syncthreads();
    if (g == 0 && j < m) {
      float s = part[c];
#pragma unroll
      for (int q = 1; q < GROUPS; ++q) s += part[q * COLW + c];
      sigma[j] = 1.f / ((float)m * s);
    }
    __syncthreads();
  }
}

// `iters` IPOT iterations on A (device memory), T written to T (which may
// hold anything on entry: T_0 = 1 is implicit). delta [n], sigma [m] and
// part [GROUPS * COLW] are shared memory; sigma is reset to 1/m here.
__device__ __forceinline__ void ipot_loop(const float* A, float* T, float* delta,
                                          float* sigma, float* part, int n, int m, int iters) {
  for (int j = threadIdx.x; j < m; j += THREADS) sigma[j] = 1.f / (float)m;
  __syncthreads();
  for (int k = 0; k < iters; ++k) {
    row_pass(A, T, T, delta, sigma, n, m, k == 0, true);
    __syncthreads();
    col_pass(A, T, delta, sigma, part, n, m);
  }
  // the last iteration's update T = (delta o Q) o sigma^T (or T_0 when iters = 0)
  row_pass(A, T, T, delta, sigma, n, m, iters == 0, false);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// f32 block GEMM (K10): out(i, j) = sum_k X(i, k) * Y(k, j) for one problem,
// X(i, k) = X[i * xsi + k * xsk], Y(k, j) = Y[k * ysk + j * ysj]. Output tiles
// of 128 x 64, k stages of 16 in shared memory, 4 x 4 FFMA accumulators per
// thread, k summed in order (fmaf). The tile loaders read along whichever
// index has stride 1, so both row- and column-major operands load coalesced.
// `epi(i, j, acc)` consumes each output. smem: gemm_smem_floats() floats.
// ---------------------------------------------------------------------------
constexpr int BM = 128, BN = 64, BK = 16;
constexpr int XS = BM + 4, YS = BN + 4;   // padded rows (bank spread, 16-byte aligned)

__host__ __device__ constexpr int gemm_smem_floats() { return BK * XS + BK * YS; }

template <class Epi>
__device__ __forceinline__ void block_gemm(const float* X, size_t xsi, size_t xsk,
                                           const float* Y, size_t ysk, size_t ysj,
                                           int M, int N, int K, float* smem, Epi epi) {
  float* Xs = smem;             // [BK][XS]
  float* Ys = smem + BK * XS;   // [BK][YS]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;   // 16 x 32 threads
  for (int i0 = 0; i0 < M; i0 += BM)
    for (int j0 = 0; j0 < N; j0 += BN) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int k0 = 0; k0 < K; k0 += BK) {
        for (int e = tid; e < BM * BK; e += THREADS) {
          int r, kk;
          if (xsk == 1) { r = e / BK; kk = e % BK; } else { kk = e / BM; r = e % BM; }
          const int gi = i0 + r, gk = k0 + kk;
          Xs[kk * XS + r] = (gi < M && gk < K) ? X[gi * xsi + gk * xsk] : 0.f;
        }
        for (int e = tid; e < BK * BN; e += THREADS) {
          int c, kk;
          if (ysj == 1) { kk = e / BN; c = e % BN; } else { c = e / BK; kk = e % BK; }
          const int gj = j0 + c, gk = k0 + kk;
          Ys[kk * YS + c] = (gj < N && gk < K) ? Y[gk * ysk + gj * ysj] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 xv = *reinterpret_cast<const float4*>(&Xs[kk * XS + ty * 4]);
          const float4 yv = *reinterpret_cast<const float4*>(&Ys[kk * YS + tx * 4]);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
          const float yr[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xr[r], yr[c], acc[r][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + ty * 4 + r, j = j0 + tx * 4 + c;
          if (i < M && j < N) epi(i, j, acc[r][c]);
        }
    }
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace madeleine_ipot
