// IPOT transport plan, backward (kernel K9).
//
// Replaces madeleine_tpu/ops/ipot.py::_bwd_kernel: the exact adjoint of the
// unrolled forward loop (the derivative that autodiff through the loop
// computes; the reference differentiates through the unconverged iterations).
// Given C [b, n, m] and the plan's cotangent G [b, n, m], returns dC.
//
// First the forward is replayed, storing each iteration's input T_k
// ([b, iters, n, m] history in device memory: 2.0 GB at the train step's
// [260, 256, 256] and 30 iterations; the TPU kept it in VMEM, which one SM
// cannot), its delta_k and sigma_k. Then, for k = iters-1 .. 0, with
// Q = A o T_k, delta = delta_k, sigma1 = sigma_{k+1} and the incoming dT, dsig:
//   dsig1  = dsig + colsum((delta o dT) o Q)
//   da     = -m sigma1^2 dsig1
//   ddelta = rowsum(Q o (dT sigma1)) + rowsum(Q o da)    (the two adjoint terms)
//   du     = -n delta^2 ddelta
//   dQ     = dT delta sigma1 + delta da + du sigma_k
//   dsig   = colsum(du o Q);  dT = dQ o A;  dA += dQ o T_k
// and finally dC = dA o A * (-1 / beta). dA accumulates in the dC buffer.
//
// What bounds it on an H100: the TPU kernel's CostEstimate, 6 * b * iters *
// 7 * n * m flops (43 GFLOP at [260, 256, 256] x 30), 0.64 ms at the FP32
// peak. This first version makes, per backward iteration, two column passes
// and a row pass over A, T_k and dT in device memory, so it is bound by
// memory traffic far above that (one block of 512 threads per problem, as K8;
// sums in a fixed order, no atomics, so two launches are bitwise equal).

#include "ipot_common.cuh"

using namespace madeleine_ipot;

namespace {

__global__ void __launch_bounds__(THREADS, 2)
ipot_bwd_kernel(const float* __restrict__ C, const float* __restrict__ G, float* A, float* Th,
                float* Dh, float* Sh, float* dT, float* dC, int n, int m, float beta,
                int iters) {
  extern __shared__ float smem[];
  float* delta = smem;          // [n]
  float* du = delta + n;        // [n]
  float* sigma = du + n;        // [m]  sigma_k
  float* sigma1 = sigma + m;    // [m]  sigma_{k+1}
  float* da = sigma1 + m;       // [m]
  float* dsig = da + m;         // [m]
  float* part = dsig + m;       // [GROUPS * COLW]
  const int tid = threadIdx.x;
  const int c = tid % COLW, g = tid / COLW;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t nm = (size_t)n * m, off = (size_t)blockIdx.x * nm;
  A += off; dT += off; dC += off;
  Th += (size_t)blockIdx.x * iters * nm;
  Dh += (size_t)blockIdx.x * iters * n;
  Sh += (size_t)blockIdx.x * (iters + 1) * m;
  exp_cost(C + off, A, nm, beta);
  for (size_t e = tid; e < nm; e += THREADS) {
    dT[e] = G[off + e];
    dC[e] = 0.f;
  }
  for (int j = tid; j < m; j += THREADS) {
    sigma[j] = 1.f / (float)m;
    Sh[j] = sigma[j];
    dsig[j] = 0.f;
  }
  __syncthreads();

  // ---- replay: the row pass of iteration k writes T_k into Th[k] ----------
  for (int k = 0; k < iters; ++k) {
    row_pass(A, Th + (k > 0 ? (size_t)(k - 1) * nm : 0), Th + (size_t)k * nm, delta, sigma, n,
             m, k == 0, true);
    __syncthreads();
    col_pass(A, Th + (size_t)k * nm, delta, sigma, part, n, m);
    for (int i = tid; i < n; i += THREADS) Dh[(size_t)k * n + i] = delta[i];
    for (int j = tid; j < m; j += THREADS) Sh[(size_t)(k + 1) * m + j] = sigma[j];
    __syncthreads();   // the next row pass rewrites delta in place
  }

  // ---- adjoint, last iteration first --------------------------------------
  for (int k = iters - 1; k >= 0; --k) {
    const float* Tk = Th + (size_t)k * nm;
    for (int i = tid; i < n; i += THREADS) delta[i] = Dh[(size_t)k * n + i];
    for (int j = tid; j < m; j += THREADS) {
      sigma[j] = Sh[(size_t)k * m + j];
      sigma1[j] = Sh[(size_t)(k + 1) * m + j];
    }
    __syncthreads();
    // da_j from dsig1_j = dsig_j + colsum((delta o dT) o Q)
    for (int j0 = 0; j0 < m; j0 += COLW) {
      const int j = j0 + c;
      float acc = 0.f;
      if (j < m)
        for (int i = g; i < n; i += GROUPS) {
          const size_t e = (size_t)i * m + j;
          acc += (delta[i] * dT[e]) * (A[e] * Tk[e]);
        }
      part[g * COLW + c] = acc;
      __syncthreads();
      if (g == 0 && j < m) {
        float s = part[c];
#pragma unroll
        for (int q = 1; q < GROUPS; ++q) s += part[q * COLW + c];
        const float dsig1 = dsig[j] + s;
        da[j] = ((-(float)m * sigma1[j]) * sigma1[j]) * dsig1;
      }
      __syncthreads();
    }
    // du_i from ddelta_i = rowsum(Q o (dT sigma1)) + rowsum(Q o da)
    for (int i = warp; i < n; i += WARPS) {
      const size_t r = (size_t)i * m;
      float acc1 = 0.f, acc2 = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float q = A[r + j] * Tk[r + j];
        acc1 += q * (dT[r + j] * sigma1[j]);
        acc2 += q * da[j];
      }
      acc1 = warp_sum(acc1);
      acc2 = warp_sum(acc2);
      if (lane == 0) du[i] = ((-(float)n * delta[i]) * delta[i]) * (acc1 + acc2);
    }
    __syncthreads();
    // dQ, then dT <- dQ o A, dA += dQ o T_k, dsig <- colsum(du o Q)
    for (int j0 = 0; j0 < m; j0 += COLW) {
      const int j = j0 + c;
      float acc = 0.f;
      if (j < m)
        for (int i = g; i < n; i += GROUPS) {
          const size_t e = (size_t)i * m + j;
          const float a = A[e], t = Tk[e], q = a * t;
          const float dq = (dT[e] * delta[i]) * sigma1[j] + delta[i] * da[j] + du[i] * sigma[j];
          acc += du[i] * q;
          dT[e] = dq * a;
          dC[e] += dq * t;
        }
      part[g * COLW + c] = acc;
      __syncthreads();
      if (g == 0 && j < m) {
        float s = part[c];
#pragma unroll
        for (int q = 1; q < GROUPS; ++q) s += part[q * COLW + c];
        dsig[j] = s;
      }
      __syncthreads();
    }
  }
  const float scale = -1.f / beta;
  for (size_t e = tid; e < nm; e += THREADS) dC[e] = (dC[e] * A[e]) * scale;
}

}  // namespace

extern "C" size_t ipot_bwd_smem_bytes(int n, int m) {
  return sizeof(float) * (2 * (size_t)n + 4 * (size_t)m + GROUPS * COLW);
}

// Returns the cudaError_t of the launch (0 = success). Device pointers, all
// f32 and contiguous: C, G, A (scratch), dT (scratch) and dC [b, n, m]; the
// history Th [b, iters, n, m], Dh [b, iters, n], Sh [b, iters + 1, m].
extern "C" int ipot_backward(const float* C, const float* G, float* A, float* Th, float* Dh,
                             float* Sh, float* dT, float* dC, int b, int n, int m, float beta,
                             int iters, void* stream) {
  const size_t smem = ipot_bwd_smem_bytes(n, m);
  cudaError_t err = allow_smem(ipot_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ipot_bwd_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      C, G, A, Th, Dh, Sh, dT, dC, n, m, beta, iters);
  return (int)cudaGetLastError();
}
