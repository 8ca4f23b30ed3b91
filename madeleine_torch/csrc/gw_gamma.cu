// Gromov-Wasserstein transport plan gamma (kernel K10), forward only.
//
// Replaces madeleine_tpu/ops/ipot.py::_gw_kernel (ref: loss.py:236-258). Per
// problem, with Cs [n, n], Ct [m, m], Cst [n, m] f32 and gamma_0 = 1/(n m):
//   `outer` times:  C_g = Cst - 2 (Cs gamma) Ct^T;  gamma = IPOT(C_g, beta, iters)
// with the IPOT loop of K8 (uniform marginals, T_0 = 1). Every caller detaches
// gamma, so there is no adjoint.
//
// What bounds it on an H100: the TPU kernel's CostEstimate, 2 * b * outer *
// (2 n m max(n, m) + iters * 7 n m) flops: 111 GFLOP at the train step's
// [260, 256, 256] (87 of them in the two products per outer step), 1.66 ms at
// the FP32 peak. The products must stay full f32 (beta = 0.1 multiplies C_g's
// error by 10 inside the exponential), so no TF32 tensor cores.
//
// Design (first version): one block of 512 threads per problem. Each outer
// step runs the two products with the hand-written FFMA block GEMM of
// ipot_common.cuh (128 x 64 output tiles, 16-deep shared-memory stages):
// t1 = Cs gamma into a device scratch, then t1 Ct^T, whose epilogue writes
// A = exp(-(Cst - 2 acc) / beta) straight into the A scratch; then the IPOT
// loop overwrites gamma with the new plan.

#include "ipot_common.cuh"

using namespace madeleine_ipot;

namespace {

__global__ void __launch_bounds__(THREADS, 2)
gw_gamma_kernel(const float* __restrict__ Cs, const float* __restrict__ Ct,
                const float* __restrict__ Cst, float* t1, float* A, float* gamma, int n, int m,
                float beta, float gamma0, int outer, int iters) {
  extern __shared__ float smem[];
  float* gsm = smem;                         // GEMM tiles
  float* delta = gsm + gemm_smem_floats();   // [n]
  float* sigma = delta + n;                  // [m]
  float* part = sigma + m;                   // [GROUPS * COLW]
  const size_t nm = (size_t)n * m, off = (size_t)blockIdx.x * nm;
  Cs += (size_t)blockIdx.x * n * n;
  Ct += (size_t)blockIdx.x * m * m;
  Cst += off; t1 += off; A += off; gamma += off;
  for (size_t e = threadIdx.x; e < nm; e += THREADS) gamma[e] = gamma0;
  __syncthreads();
  for (int o = 0; o < outer; ++o) {
    // t1 = Cs gamma: X = Cs (i, k) row-major, Y = gamma (k, j) row-major
    block_gemm(Cs, n, 1, gamma, m, 1, n, m, n, gsm,
               [&](int i, int j, float acc) { t1[(size_t)i * m + j] = acc; });
    __syncthreads();
    // t1 Ct^T: X = t1 (i, k), Y(k, j) = Ct[j, k]
    block_gemm(t1, m, 1, Ct, 1, m, n, m, m, gsm, [&](int i, int j, float acc) {
      const size_t e = (size_t)i * m + j;
      A[e] = expf(-(Cst[e] - 2.f * acc) / beta);
    });
    __syncthreads();
    ipot_loop(A, gamma, delta, sigma, part, n, m, iters);
  }
}

}  // namespace

extern "C" size_t gw_gamma_smem_bytes(int n, int m) {
  return sizeof(float) * ((size_t)gemm_smem_floats() + n + m + GROUPS * COLW);
}

// Returns the cudaError_t of the launch (0 = success). Device pointers, f32,
// contiguous: Cs [b, n, n], Ct [b, m, m], Cst [b, n, m]; t1 and A scratch
// [b, n, m]; gamma [b, n, m] out. gamma0 = 1/(n m) as the caller rounds it.
extern "C" int gw_gamma_forward(const float* Cs, const float* Ct, const float* Cst, float* t1,
                                float* A, float* gamma, int b, int n, int m, float beta,
                                float gamma0, int outer, int iters, void* stream) {
  const size_t smem = gw_gamma_smem_bytes(n, m);
  cudaError_t err = allow_smem(gw_gamma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gw_gamma_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      Cs, Ct, Cst, t1, A, gamma, n, m, beta, gamma0, outer, iters);
  return (int)cudaGetLastError();
}
