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
// Two routes, chosen by shape in madeleine_torch/ops/ipot.py::transport_route.
//
// The cluster route (gw_gamma_cluster_kernel, the train step's): one cluster
// of c blocks per problem (ipot_cluster.cuh), the block of rank r holding its
// slice of rows of A and gamma in shared memory for the whole launch (two
// [n/c, m] slots, 64 KB each at [256, 256] with c = 4); Cs, Ct and Cst are
// read from device memory (L2) and gamma is written once at the end. Each
// outer step:
//   1. t1 = Cs[rows] gamma: gamma's rows come from every rank's slot through
//      DSMEM; t1 goes to the other slot (A is dead once the IPOT loop ends).
//   2. a cluster barrier: no peer reads this block's gamma any more.
//   3. A = exp(-(Cst[rows] - 2 t1 Ct^T) / beta) into gamma's slot (the product's
//      epilogue), Ct read from L2.
//   4. the IPOT loop on A writes the new plan into t1's slot; the two slots
//      swap roles (every block alike, so the DSMEM offsets agree).
// The products are FFMA from shared-memory stages (tile_gemm, k summed in
// order with fmaf, as the global route's block_gemm); the IPOT loop's column
// sums are combined across the cluster in rank order (one cluster barrier
// per iteration). At the step's shape the problems run in waves: 30 clusters
// of 4 fit the card at once (cudaOccupancyMaxActiveClusters), so 260
// problems take 9 waves. Timed per phase on the card (PERF.md), the products
// are bound by the stage's shared-memory reads and the next stage's fetch
// latency, the loop by each iteration's chain of sweep, exchange and barrier.
//
// The global route (gw_gamma_kernel, the first design, for problems whose
// state does not fit a cluster): one block of 512 threads per problem. Each
// outer step runs the two products with the FFMA block GEMM of
// ipot_common.cuh (128 x 64 output tiles, 16-deep shared-memory stages):
// t1 = Cs gamma into a device scratch, then t1 Ct^T, whose epilogue writes
// A = exp(-(Cst - 2 acc) / beta) straight into the A scratch; then the IPOT
// loop overwrites gamma with the new plan.

#include "ipot_cluster.cuh"
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

namespace cl = madeleine_ipot::cluster;

// shared memory of the cluster route: two state slots, the product stages,
// delta, sigma, the receive buffers (two parities of c slots), the
// column-sum scratch and a pointer per row of the problem to that row in its
// owner's first slot
__host__ __device__ inline size_t cluster_smem_floats(int n, int m, int c) {
  return 2 * cl::slice_floats(n, m, c) + cl::stage_floats() + cl::round4(cl::max_rows(n, c)) +
         (1 + 2 * (size_t)c) * cl::round4(m) + cl::red_floats(m) + 2 * (size_t)n;
}

// FAST: cl::fast_path(m), the IPOT loop on the fast path (ipot_cluster.cuh)
template <bool FAST>
__global__ void __launch_bounds__(cl::CTHREADS, 1)
gw_gamma_cluster_kernel(const float* __restrict__ Cs, const float* __restrict__ Ct,
                        const float* __restrict__ Cst, float* __restrict__ gamma_out, int n,
                        int m, float beta, float gamma0, int outer, int iters) {
  cl::cg::cluster_group cluster = cl::cg::this_cluster();
  const int c = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int p = blockIdx.x / c;
  const int r0 = cl::row0(n, c, r), nr = cl::row0(n, c, r + 1) - r0;
  const size_t S = cl::slice_floats(n, m, c), mp = cl::round4(m);
  extern __shared__ float4 smem4[];
  float* g = reinterpret_cast<float*>(smem4);   // gamma's slot
  float* a = g + S;                             // A's slot (t1 during the products)
  float* stage = a + S;
  float* delta = stage + cl::stage_floats();    // [nr]
  float* sigma = delta + cl::round4(cl::max_rows(n, c));   // [m]
  float* recv = sigma + mp;                     // [2][c][mp]
  float* red = recv + 2 * c * mp;               // column-sum scratch
  float** rowp = reinterpret_cast<float**>(red + cl::red_floats(m));   // [n]
  // row k of the problem lives in its owner's slots, at rowp[k] (the first
  // slot) and rowp[k] + S (the second): DSMEM addresses, mapped once
  for (int k = threadIdx.x; k < n; k += cl::CTHREADS) {
    const int q = cl::owner(k, n, c);
    rowp[k] = cluster.map_shared_rank(g, q) + (size_t)(k - cl::row0(n, c, q)) * m;
  }
  size_t goff = 0;   // gamma's slot: 0 the first, S the second
  const float* Csp = Cs + (size_t)p * n * n + (size_t)r0 * n;
  const float* Ctp = Ct + (size_t)p * m * m;
  const float* Cstp = Cst + (size_t)p * n * m + (size_t)r0 * m;
  const size_t nrm = (size_t)nr * m;
  for (size_t e = threadIdx.x; e < nrm; e += cl::CTHREADS) g[e] = gamma0;
  int par = 0;
  for (int o = 0; o < outer; ++o) {
    cluster.sync();   // every rank's gamma slice is written
    // t1 = Cs[rows] gamma -> a
    cl::tile_gemm<false>(
        nr, m, n, stage, [&](int i, int k) { return Csp[(size_t)i * n + k]; },
        [&](int k, int j) { return rowp[k][goff + j]; },
        [&](int i, int j, float v) { a[(size_t)i * m + j] = v; });
    cluster.sync();   // no peer reads this block's gamma any more
    // A = exp(-(Cst - 2 t1 Ct^T) / beta) -> g
    cl::tile_gemm<true>(
        nr, m, m, stage, [&](int i, int k) { return a[(size_t)i * m + k]; },
        [&](int k, int j) { return Ctp[(size_t)j * m + k]; },
        [&](int i, int j, float v) {
          g[(size_t)i * m + j] = expf(-(Cstp[(size_t)i * m + j] - 2.f * v) / beta);
        });
    __syncthreads();
    if (FAST)
      cl::ipot_loop_fast(cluster, g, a, delta, sigma, recv, c * mp, red, nr, n, m, iters, par,
                         true, nullptr, 0, nullptr, nullptr);
    else
      cl::ipot_loop(cluster, g, a, delta, sigma, recv, c * mp, red, nr, n, m, iters, par);
    float* t = g;   // the new plan is in a
    g = a;
    a = t;
    goff = S - goff;
  }
  float* out = gamma_out + (size_t)p * n * m + (size_t)r0 * m;
  for (size_t e = threadIdx.x; e < nrm; e += cl::CTHREADS) out[e] = g[e];
  cluster.sync();   // no block leaves while a peer may still read its shared memory
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

extern "C" size_t gw_gamma_cluster_smem_bytes(int n, int m, int c) {
  return sizeof(float) * cluster_smem_floats(n, m, c);
}

// The cluster route: Cs [b, n, n], Ct [b, m, m], Cst [b, n, m] in, gamma
// [b, n, m] out (device pointers, f32, contiguous); c blocks per problem.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int gw_gamma_cluster_forward(const float* Cs, const float* Ct, const float* Cst,
                                        float* gamma, int b, int n, int m, int c, float beta,
                                        float gamma0, int outer, int iters, void* stream) {
  const size_t smem = gw_gamma_cluster_smem_bytes(n, m, c);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cl::fast_path(m))
    return (int)cl::launch_clusters(gw_gamma_cluster_kernel<true>, b, c, smem, st, Cs, Ct, Cst,
                                    gamma, n, m, beta, gamma0, outer, iters);
  return (int)cl::launch_clusters(gw_gamma_cluster_kernel<false>, b, c, smem, st, Cs, Ct, Cst,
                                  gamma, n, m, beta, gamma0, outer, iters);
}

// cudaOccupancyMaxActiveClusters of the cluster route at (n, m, c)
extern "C" int gw_gamma_cluster_occupancy(int n, int m, int c) {
  const size_t smem = gw_gamma_cluster_smem_bytes(n, m, c);
  return cl::fast_path(m) ? cl::active_clusters(gw_gamma_cluster_kernel<true>, c, smem)
                         : cl::active_clusters(gw_gamma_cluster_kernel<false>, c, smem);
}
