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
// Two routes, chosen by shape in madeleine_torch/ops/ipot.py::transport_route.
//
// The cluster route (ipot_fwd_cluster_kernel, the train step's): one
// thread-block cluster of c blocks of 1024 threads per problem
// (ipot_cluster.cuh), the block of rank r owning the rows i = r + c k for the
// whole launch. It reads its rows of C once, keeps A = exp(-C / beta) and
// Q = A o T on chip, and writes its rows of T once: no device scratch, the
// only device traffic is C in and T out. Each iteration is the global
// route's row pass over the block's rows (a warp per row; on the fast path,
// m <= 256, a thread keeps its two rows' A and Q in registers and writes Q
// to shared memory), then a column pass in which one thread per column sums
// Q o delta over the block's rows in row order; the c partials are pushed
// to every rank through DSMEM and added in rank order after one cluster
// barrier. At c = 4 the ranks are exactly the global route's four
// column-pass row groups, so every product and sum runs in the global
// route's order and the two routes' plans are equal bit for bit: a training
// run does not depend on the route. (K9/K10's loop, ipot_loop_fast, sums
// columns in another order; as K8 it took 0.89 ms against this design's
// 0.98 at [260, 256, 256], but moved the weights of the chip check's
// no-fused training run enough to miss a bf16 bar there: PERF.md.) A block
// holds 137 KB at c = 4 (the A slice serves only the general path) and
// 64 registers a thread, so one block per SM: 30 problems in flight, 260 in
// about 9 waves, each set by the latency of its 30 iteration chains (row
// pass, column pass, exchange, cluster barrier).
//
// The global route (ipot_fwd_kernel, the first design, for problems whose
// state does not fit a cluster): one block of 512 threads per problem.
// A = exp(-C / beta) goes to a device scratch once; T lives in the output.
// Each iteration is one row pass (a warp per row: apply the previous
// iteration's update to the row, store it, sum the new row for delta) and
// one column pass (threads across columns, four row groups, summed in
// order, for sigma), then a last row pass applies the final update. No
// closed form T_k = A^k o (d s^T): exp(-2k C / beta) underflows f32 at
// k = 30. Each iteration reads A and T twice and writes T once, from L2 or
// device memory.

#include <stdint.h>

#include "ipot_cluster.cuh"
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

namespace cl = madeleine_ipot::cluster;

// shared memory of the cluster route: A's and T's row slices, delta, sigma
// and the receive buffers (two parities of c slots)
__host__ __device__ inline size_t cluster_smem_floats(int n, int m, int c) {
  return 2 * cl::slice_floats(n, m, c) + cl::round4(cl::max_rows(n, c)) +
         (1 + 2 * (size_t)c) * cl::round4(m);
}

// threads of a cluster-route block: 32 warps, so that at c = 4 (64 rows of
// a 256-row problem per block) a warp holds two rows and a thread 64 registers
constexpr int FTHREADS = 1024, FWARPS = FTHREADS / 32;

// The row pass of one iteration over the block's rows (local row i), in the
// global route's arithmetic (ipot_common.cuh::row_pass), with Q = A o T of
// the previous iteration kept in place of T (Q = A before the first):
//   t = first ? 1 : (delta_i * Q_ij) * sigma_j;  Q_ij <- A_ij * t;
//   delta_i = 1 / (n * sum_j Q_ij * sigma_j)
// (lane l sums its columns l, l + 32, ... in order, then a butterfly: the
// global route's Q, t and sums, bit for bit). Q goes to shared memory for
// the column pass. With out, the pass is the last iteration's update
// instead: t goes to out + i * ldo + j and nothing else is written.
//
// The general path: a warp per row, A and Q read from shared memory.
__device__ __forceinline__ void row_pass_smem(const float* A, float* Q, float* delta,
                                              const float* sigma, int nr, int n, int m,
                                              bool first, float* out, size_t ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < nr; i += FWARPS) {
    const float dp = first ? 0.f : delta[i];
    const float* Ar = A + (size_t)i * m;
    float* Qr = Q + (size_t)i * m;
    float acc = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float tt = first ? 1.f : (dp * Qr[j]) * sigma[j];
      if (out) {
        out[(size_t)i * ldo + j] = tt;
      } else {
        const float q = Ar[j] * tt;
        Qr[j] = q;
        acc += q * sigma[j];
      }
    }
    if (out) continue;
    acc = warp_sum(acc);
    if (lane == 0) delta[i] = 1.f / ((float)n * acc);
  }
}

// The fast path (m <= 256, at most ROWS rows per warp): thread (warp w,
// lane l) owns local rows w + FWARPS u (u < ROWS) and columns l + 32 t
// (t < JPL) for the whole launch, their A and Q in registers (a, q), so a
// row pass reads only delta and sigma from shared memory and writes Q
// there once; a warp's rows are in flight together.
constexpr int ROWS = 2, JPL = 8;   // 32 JPL = cl::FAST_M

__device__ __forceinline__ void row_pass_regs(const float (&a)[ROWS][JPL], float (&q)[ROWS][JPL],
                                              float* Q, float* delta, const float* sigma,
                                              int nr, int n, int m, bool first, float* out,
                                              size_t ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sg[JPL], acc[ROWS];
#pragma unroll
  for (int t = 0; t < JPL; ++t) sg[t] = lane + 32 * t < m ? sigma[lane + 32 * t] : 0.f;
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int i = warp + FWARPS * u;
    acc[u] = 0.f;
    if (i >= nr) continue;   // the same for the whole warp
    const float dp = first ? 0.f : delta[i];
#pragma unroll
    for (int t = 0; t < JPL; ++t) {
      const int j = lane + 32 * t;
      if (j >= m) continue;
      const float tt = first ? 1.f : (dp * q[u][t]) * sg[t];
      if (out) {
        out[(size_t)i * ldo + j] = tt;
      } else {
        q[u][t] = a[u][t] * tt;
        Q[(size_t)i * m + j] = q[u][t];
        acc[u] += q[u][t] * sg[t];
      }
    }
  }
  if (out) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < ROWS; ++u) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int i = warp + FWARPS * u;
    if (i < nr && lane == 0) delta[i] = 1.f / ((float)n * acc[u]);
  }
}

// The block of rank r owns the problem's rows i = r + c k (local row k): at
// c = GROUPS these are the rows of the global route's column-pass row group
// r. Per iteration: the row pass, then each column's partial over the local
// rows in row order (one thread per column, as col_pass sums a group),
// pushed to every rank and added in rank order, as col_pass adds its
// groups. FAST: the register-resident row pass.
template <bool FAST>
__global__ void __launch_bounds__(FTHREADS, 1)
ipot_fwd_cluster_kernel(const float* __restrict__ C, float* __restrict__ T_out, int n, int m,
                        float beta, int iters) {
  cl::cg::cluster_group cluster = cl::cg::this_cluster();
  const int c = (int)cluster.num_blocks(), r = (int)cluster.block_rank(), tid = threadIdx.x;
  const int p = blockIdx.x / c;
  const int nr = r < n ? (n - r + c - 1) / c : 0;
  const size_t S = cl::slice_floats(n, m, c), mp = cl::round4(m);
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // [nr, m] (the general path)
  float* Q = A + S;                              // [nr, m]: A o T
  float* delta = Q + S;                          // [nr]
  float* sigma = delta + cl::round4(cl::max_rows(n, c));   // [m]
  float* recv = sigma + mp;                      // [2][c][mp]
  const float* Cp = C + ((size_t)p * n + r) * m;   // local row k at Cp + k c m
  float* Tp = T_out + ((size_t)p * n + r) * m;
  const size_t nrm = (size_t)nr * m, cm = (size_t)c * m;
  // A = exp(-C / beta) over the block's rows, C read once: into registers
  // (the fast path; a warp's loads are 128 contiguous bytes) or shared
  // memory (float4 when m % 4 == 0 and C starts on 16 bytes)
  float a[FAST ? ROWS : 1][JPL], q[FAST ? ROWS : 1][JPL];
  if constexpr (FAST) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
#pragma unroll
      for (int t = 0; t < JPL; ++t) {
        const int i = warp + FWARPS * u, j = lane + 32 * t;
        a[u][t] = i < nr && j < m ? expf(-Cp[i * cm + j] / beta) : 0.f;
        q[u][t] = 0.f;
      }
  } else if (m % 4 == 0 && (reinterpret_cast<uintptr_t>(Cp) & 15) == 0) {
    const int m4 = m / 4;
    for (size_t e = tid; e < nrm / 4; e += FTHREADS) {
      const float4 x = reinterpret_cast<const float4*>(Cp + (e / m4) * cm)[e % m4];
      reinterpret_cast<float4*>(A)[e] = make_float4(expf(-x.x / beta), expf(-x.y / beta),
                                                    expf(-x.z / beta), expf(-x.w / beta));
    }
  } else {
    for (size_t e = tid; e < nrm; e += FTHREADS) A[e] = expf(-Cp[(e / m) * cm + e % m] / beta);
  }
  for (int j = tid; j < m; j += FTHREADS) sigma[j] = 1.f / (float)m;
  // every block of the cluster is running before the first push into a
  // peer's receive buffer
  cluster.sync();
  auto row_pass = [&](bool first, float* out) {
    if constexpr (FAST)
      row_pass_regs(a, q, Q, delta, sigma, nr, n, m, first, out, cm);
    else
      row_pass_smem(A, Q, delta, sigma, nr, n, m, first, out, cm);
  };
  int par = 0;
  for (int k = 0; k < iters; ++k) {
    row_pass(k == 0, nullptr);
    __syncthreads();
    float* rv = recv + par * c * mp;
    for (int j = tid; j < m; j += FTHREADS) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < nr; ++i) acc += Q[(size_t)i * m + j] * delta[i];
      cl::push(cluster, rv, r, c, mp, j, acc);
    }
    cluster.sync();
    for (int j = tid; j < m; j += FTHREADS)
      sigma[j] = 1.f / ((float)m * cl::recv_sum(rv, c, mp, j));
    __syncthreads();   // the next row pass reads sigma and rewrites delta
    par ^= 1;
  }
  // the last iteration's update (or T_0 = 1 when iters = 0), straight to the
  // output; no peer reads this block's shared memory after the last
  // exchange's barrier
  row_pass(iters == 0, Tp);
}

using ClusterKernel = void (*)(const float*, float*, int, int, float, int);

// the fast path where m <= 256 and a warp holds its block's rows
ClusterKernel cluster_kernel(int n, int m, int c) {
  return m <= cl::FAST_M && cl::max_rows(n, c) <= ROWS * FWARPS
             ? ipot_fwd_cluster_kernel<true>
             : ipot_fwd_cluster_kernel<false>;
}

}  // namespace

extern "C" size_t ipot_fwd_smem_bytes(int n, int m) {
  return sizeof(float) * ((size_t)n + m + GROUPS * COLW);
}

// The global route. Returns the cudaError_t of the launch (0 = success).
// C, A (scratch) and T are device pointers to [b, n, m] f32, contiguous.
extern "C" int ipot_forward(const float* C, float* A, float* T, int b, int n, int m, float beta,
                            int iters, void* stream) {
  const size_t smem = ipot_fwd_smem_bytes(n, m);
  cudaError_t err = allow_smem(ipot_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ipot_fwd_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(C, A, T, n, m, beta,
                                                                           iters);
  return (int)cudaGetLastError();
}

extern "C" size_t ipot_fwd_cluster_smem_bytes(int n, int m, int c) {
  return sizeof(float) * cluster_smem_floats(n, m, c);
}

// The cluster route: C [b, n, m] in, T [b, n, m] out (device pointers, f32,
// contiguous); c blocks per problem. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int ipot_fwd_cluster(const float* C, float* T, int b, int n, int m, int c,
                                float beta, int iters, void* stream) {
  return (int)cl::launch_clusters<FTHREADS>(cluster_kernel(n, m, c), b, c,
                                            ipot_fwd_cluster_smem_bytes(n, m, c),
                                            static_cast<cudaStream_t>(stream), C, T, n, m, beta,
                                            iters);
}

// cudaOccupancyMaxActiveClusters of the cluster route at (n, m, c)
extern "C" int ipot_fwd_cluster_occupancy(int n, int m, int c) {
  return cl::active_clusters<FTHREADS>(cluster_kernel(n, m, c), c,
                                       ipot_fwd_cluster_smem_bytes(n, m, c));
}
