// IPOT transport plan, forward (kernel K8).
//
// Replaces madeleine_tpu/ops/ipot.py::_fwd_kernel: `iters` proximal Sinkhorn
// iterations with uniform marginals on each of b cost matrices C [n, m] f32,
// T_0 = 1, sigma_0 = 1/m, A = exp(-C / beta); writes the plan T [b, n, m].
//
// What bounds it on an H100: the TPU kernel's CostEstimate counts
// 2 * b * iters * 7 * n * m flops (7.2 GFLOP at the train step's
// [260, 256, 256], 30 iterations), 0.11 ms at the FP32 peak; its bytes (read C,
// write T, 136 MB) take 0.04 ms. So the bound is operations, but every
// iteration is a strict chain of a row sum, a column sum and an update over
// the whole problem, and one problem's A and T (512 KB) do not fit one SM.
//
// Design (first version, simple and exact): one block of 512 threads per
// problem. A = exp(-C / beta) goes to a device scratch once; T lives in the
// output. Each iteration is one row pass (a warp per row: apply the previous
// iteration's update to the row, store it, sum the new row for delta) and one
// column pass (threads across columns, four row groups, summed in order, for
// sigma), then a last row pass applies the final update. No closed form
// T_k = A^k o (d s^T): exp(-2k C / beta) underflows f32 at k = 30. Each
// iteration reads A and T twice and writes T once; the blocks in flight hold
// about 67 MB, beyond the 50 MB L2, so the passes partly stream from HBM.
// A thread-block cluster that splits a problem's rows across SMs and keeps
// A and T on chip is the fast design (later work).

#include "ipot_common.cuh"

using namespace madeleine_ipot;

namespace {

__global__ void __launch_bounds__(THREADS, 2)
ipot_fwd_kernel(const float* __restrict__ C, float* A, float* T, int n, int m, float beta,
                int iters) {
  extern __shared__ float smem[];
  float* delta = smem;           // [n]
  float* sigma = delta + n;      // [m]
  float* part = sigma + m;       // [GROUPS * COLW]
  const size_t nm = (size_t)n * m, off = (size_t)blockIdx.x * nm;
  exp_cost(C + off, A + off, nm, beta);
  __syncthreads();
  ipot_loop(A + off, T + off, delta, sigma, part, n, m, iters);
}

}  // namespace

extern "C" size_t ipot_fwd_smem_bytes(int n, int m) {
  return sizeof(float) * ((size_t)n + m + GROUPS * COLW);
}

// Returns the cudaError_t of the launch (0 = success). C, A (scratch) and T
// are device pointers to [b, n, m] f32, contiguous.
extern "C" int ipot_forward(const float* C, float* A, float* T, int b, int n, int m, float beta,
                            int iters, void* stream) {
  const size_t smem = ipot_fwd_smem_bytes(n, m);
  cudaError_t err = allow_smem(ipot_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ipot_fwd_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(C, A, T, n, m, beta,
                                                                           iters);
  return (int)cudaGetLastError();
}
