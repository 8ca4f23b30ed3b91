// Device code shared by the cluster routes of K8 (IPOT forward), K9 (IPOT
// backward) and K10 (the GW gamma loop): one thread-block cluster per
// transport problem, each block holding a contiguous slice of the problem's
// rows in its own shared memory.
//
// Rows. The block of cluster rank r owns rows [row0(r), row0(r + 1)) with
// row0(r) = floor(r n / c): slices of floor(n / c) or ceil(n / c) rows, any n
// (a rank may own none). Each per-row slice of the state ([rows, m] f32) sits
// in shared memory at a stride of slice_floats(n, m, c) floats.
//
// Sums. Row quantities (delta, u, du) are sums within one row, so within one
// block (a warp per row, as ipot_common.cuh's row_pass). Column quantities
// (sigma, a, dsigma) are sums over all rows: each block sums its own rows in
// a fixed order (per lane over a warp's rows, then the warps in order, on
// the fast path; row groups, then the groups in order, on the general one)
// into a partial vector and pushes it, through distributed
// shared memory (DSMEM), into slot r of every rank's receive buffer [c][m];
// after one cluster barrier every block adds its c slots in rank order, so
// every block holds the same vector bit for bit, and two launches give
// bitwise-equal results. Receive buffers alternate between two parities: a
// block writes parity p only after the barrier that follows every peer's
// last read of it, so one cluster barrier per exchange serves.
//
// Exact f32 as the rest of the IPOT code: IEEE division and expf, products in
// the order of the JAX loop, no atomics.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ipot_common.cuh"

namespace madeleine_ipot {
namespace cluster {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 8;   // the portable cluster size limit
// threads of a cluster-route block (the global routes' THREADS is their own)
constexpr int CTHREADS = 512;
constexpr int CWARPS = CTHREADS / 32;
constexpr int CGROUPS = CTHREADS / COLW;   // row groups of a column pass

__host__ __device__ inline size_t round4(size_t x) { return (x + 3) & ~(size_t)3; }

// first row of rank r, and the largest slice
__host__ __device__ inline int row0(int n, int c, int r) {
  return (int)(((long long)r * n) / c);
}
__host__ __device__ inline int max_rows(int n, int c) { return (n + c - 1) / c; }

// floats between two slices of the state in shared memory (and in K9's
// history): a multiple of 4, so every slice starts on 16 bytes
__host__ __device__ inline size_t slice_floats(int n, int m, int c) {
  return round4((size_t)max_rows(n, c) * m);
}

// the rank that owns row k: the r with row0(r) <= k < row0(r + 1)
__device__ __forceinline__ int owner(int k, int n, int c) {
  return (int)((((long long)k + 1) * c + n - 1) / n) - 1;
}

// ---------------------------------------------------------------------------
// passes over the block's rows (A, T, ... are [nr, m] slices in shared memory)
// ---------------------------------------------------------------------------

// Row pass of one IPOT iteration over the block's nr rows, as
// ipot_common.cuh::row_pass with the row count nr and the marginal n apart:
//   t = first ? 1 : (delta_i * (A_ij * T_ij)) * sigma_j  -> T_ij (and hist)
//   delta_i = 1 / (n * sum_j (A_ij * t) * sigma_j)        (when want_delta)
// hist, when not null, is a [nr, m] slice in device memory that gets each t.
__device__ __forceinline__ void row_update(const float* A, float* T, float* delta,
                                           const float* sigma, int nr, int n, int m, bool first,
                                           bool want_delta, float* hist) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < nr; i += CWARPS) {
    const float dp = first ? 0.f : delta[i];
    const float* Ar = A + (size_t)i * m;
    float* Tr = T + (size_t)i * m;
    float acc = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float a = Ar[j];
      const float t = first ? 1.f : (dp * (a * Tr[j])) * sigma[j];
      Tr[j] = t;
      if (hist) hist[(size_t)i * m + j] = t;
      acc += (a * t) * sigma[j];
    }
    acc = warp_sum(acc);
    if (want_delta && lane == 0) delta[i] = 1.f / ((float)n * acc);
  }
}

// Push this block's partial entry j (the block of rank r) into slot r of
// every rank's receive buffer recv [c][mp] (DSMEM stores).
__device__ __forceinline__ void push(cg::cluster_group& cl, float* recv, int r, int c, size_t mp,
                                     int j, float s) {
  float* slot = recv + (size_t)r * mp + j;
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    if (q < c) *cl.map_shared_rank(slot, q) = s;
}

// entry j of the column sum: the c slots of the local receive buffer added
// in rank order (after the cluster barrier that ends the pushes)
__device__ __forceinline__ float recv_sum(const float* recv, int c, size_t mp, int j) {
  float s = recv[j];
  for (int q = 1; q < c; ++q) s += recv[(size_t)q * mp + j];
  return s;
}

// The block's partial column sums sink(j, sum_i term(i, e)) over its nr rows
// (e = i * m + j): threads across COLW columns, CGROUPS row groups each summed
// in row order, then the groups in order. red: CGROUPS * m floats. The caller
// synchronises (a cluster barrier) before the sums are read.
template <class Term, class Sink>
__device__ __forceinline__ void col_partial(float* red, int nr, int m, Term term, Sink sink) {
  const int cc = threadIdx.x % COLW, g = threadIdx.x / COLW;
  for (int j = cc; j < m; j += COLW) {
    float acc = 0.f;
    for (int i = g; i < nr; i += CGROUPS) acc += term(i, (size_t)i * m + j);
    red[g * m + j] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += CTHREADS) {
    float s = red[j];
#pragma unroll
    for (int q = 1; q < CGROUPS; ++q) s += red[q * m + j];
    sink(j, s);
  }
}

// ---------------------------------------------------------------------------
// the fast path (m <= FAST_M, m % 4 == 0): a warp per row, lane l holding
// columns 4 l .. 4 l + 3 and 128 more of every row it walks (float4 reads
// and writes), so a column partial over the warp's rows accumulates in
// registers and the column pass disappears
// ---------------------------------------------------------------------------
constexpr int JPL = 8;             // columns per lane
constexpr int FAST_M = 32 * JPL;   // the widest problem of the fast path

__host__ __device__ inline bool fast_path(int m) { return m <= FAST_M && m % 4 == 0; }

// the column of lane l's entry t (t < JPL): 4 l + 128 (t / 4) + t % 4
__device__ __forceinline__ int fcol(int lane, int t) { return 4 * lane + 128 * (t >> 2) + (t & 3); }

// floats of the column-sum scratch: CGROUPS row groups (the general path) or
// CWARPS per-lane partials (the fast path)
__host__ __device__ inline size_t red_floats(int m) {
  return (size_t)CGROUPS * m > (size_t)CWARPS * FAST_M ? (size_t)CGROUPS * m
                                                     : (size_t)CWARPS * FAST_M;
}

// The block's partial column sums from per-lane accumulators (lane l of warp
// w holds its rows' sums of its columns fcol(l, t)): red [CWARPS][FAST_M], then
// sink(j, the warps' values added in warp order). Has a block barrier
// between the two; the caller synchronises before the sums are read or red
// rewritten.
template <class Sink>
__device__ __forceinline__ void lanes_to_part(const float (&acc)[JPL], float* red, int m,
                                              Sink sink) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int t2 = 0; t2 < JPL / 4; ++t2)
    *reinterpret_cast<float4*>(&red[warp * FAST_M + 4 * lane + 128 * t2]) =
        make_float4(acc[4 * t2], acc[4 * t2 + 1], acc[4 * t2 + 2], acc[4 * t2 + 3]);
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += CTHREADS) {
    float s = red[j];
#pragma unroll
    for (int w = 1; w < CWARPS; ++w) s += red[w * FAST_M + j];
    sink(j, s);
  }
}

// this lane's entries of a [m] vector in shared memory (0 beyond m)
__device__ __forceinline__ void lane_load(float (&v)[JPL], const float* x, int m) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t2 = 0; t2 < JPL / 4; ++t2) {
    const int j = 4 * lane + 128 * t2;
    const float4 y = j < m ? *reinterpret_cast<const float4*>(x + j) : make_float4(0, 0, 0, 0);
    v[4 * t2] = y.x;
    v[4 * t2 + 1] = y.y;
    v[4 * t2 + 2] = y.z;
    v[4 * t2 + 3] = y.w;
  }
}

// `iters` IPOT iterations as ipot_loop, on the fast path (fast_path(m)):
// one sweep per iteration (update T, the row sum, delta, the column
// partial), one cluster exchange. With a history (K9's replay), T_k also goes to hist + k hstride,
// delta_k to dhist[k * n + i] and sigma_{k+1} to shist[(k + 1) * m + j]; with
// final_update (K10) a last sweep applies the last iteration's update.
// recv: [2 parities][c][mp] receive buffers (recv_stride floats apart).
// Ends with a block barrier.
__device__ __forceinline__ void ipot_loop_fast(cg::cluster_group& cl, const float* A, float* T,
                                               float* delta, float* sigma, float* recv,
                                               size_t recv_stride, float* red, int nr, int n,
                                               int m, int iters, int& par, bool final_update,
                                               float* hist, size_t hstride, float* dhist,
                                               float* shist) {
  const int c = cl.num_blocks(), r = cl.block_rank();
  const size_t mp = round4(m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sg[JPL];
#pragma unroll
  for (int t = 0; t < JPL; ++t) sg[t] = fcol(lane, t) < m ? 1.f / (float)m : 0.f;
  for (int k = 0; k < iters; ++k) {
    float cacc[JPL];
#pragma unroll
    for (int t = 0; t < JPL; ++t) cacc[t] = 0.f;
    float* hk = hist ? hist + (size_t)k * hstride : nullptr;
    // two rows of the warp at a time (i and i + CWARPS), so that their
    // dependency chains (loads, the row sum's shuffles, the reciprocal)
    // overlap; each row's sums keep their order
    for (int i = warp; i < nr; i += 2 * CWARPS) {
      const int ii[2] = {i, i + CWARPS};
      float q[2][JPL], acc[2] = {0.f, 0.f};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const bool live = ii[p] < nr;   // the same for the whole warp
        const float dp = k == 0 || !live ? 0.f : delta[ii[p]];
        const float* Ar = A + (size_t)ii[p] * m;
        float* Tr = T + (size_t)ii[p] * m;
#pragma unroll
        for (int t2 = 0; t2 < JPL / 4; ++t2) {
          const int j = 4 * lane + 128 * t2;
          float* qq = q[p] + 4 * t2;
          qq[0] = qq[1] = qq[2] = qq[3] = 0.f;
          if (live && j < m) {
            const float4 a4 = *reinterpret_cast<const float4*>(Ar + j);
            const float4 x4 = k == 0 ? a4 : *reinterpret_cast<const float4*>(Tr + j);
            const float av[4] = {a4.x, a4.y, a4.z, a4.w}, x[4] = {x4.x, x4.y, x4.z, x4.w};
            float tt[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float sj = sg[4 * t2 + u];
              tt[u] = k == 0 ? 1.f : (dp * (av[u] * x[u])) * sj;
              qq[u] = av[u] * tt[u];
              acc[p] += qq[u] * sj;
            }
            const float4 t4 = make_float4(tt[0], tt[1], tt[2], tt[3]);
            *reinterpret_cast<float4*>(Tr + j) = t4;
            if (hk) *reinterpret_cast<float4*>(hk + (size_t)ii[p] * m + j) = t4;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {   // warp_sum of both rows, interleaved
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
        acc[1] += __shfl_xor_sync(0xffffffffu, acc[1], o);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (ii[p] >= nr) continue;
        const float d = 1.f / ((float)n * acc[p]);
        if (lane == 0) {
          delta[ii[p]] = d;
          if (dhist) dhist[(size_t)k * n + ii[p]] = d;
        }
#pragma unroll
        for (int t = 0; t < JPL; ++t) cacc[t] += q[p][t] * d;
      }
    }
    float* rv = recv + par * recv_stride;
    lanes_to_part(cacc, red, m, [&](int j, float s) { push(cl, rv, r, c, mp, j, s); });
    cl.sync();
    for (int j = threadIdx.x; j < m; j += CTHREADS) {
      const float s = 1.f / ((float)m * recv_sum(rv, c, mp, j));
      sigma[j] = s;
      if (shist) shist[(size_t)(k + 1) * m + j] = s;
    }
    __syncthreads();
    lane_load(sg, sigma, m);
    par ^= 1;
  }
  if (final_update) {
    for (int i = warp; i < nr; i += CWARPS) {
      const float dp = iters == 0 ? 0.f : delta[i];
      const float* Ar = A + (size_t)i * m;
      float* Tr = T + (size_t)i * m;
#pragma unroll
      for (int t = 0; t < JPL; ++t) {
        const int j = fcol(lane, t);
        if (j < m) Tr[j] = iters == 0 ? 1.f : (dp * (Ar[j] * Tr[j])) * sg[t];
      }
    }
  }
  __syncthreads();
}

// `iters` IPOT iterations of one problem whose rows are split over the
// cluster: A [nr, m] (shared memory), T [nr, m] written (T_0 = 1 implicit).
// delta [nr], sigma [m], recv [2 parities][c][mp] (recv_stride floats apart,
// mp = round4(m)) and red [CGROUPS][m] are shared memory; par is the running
// exchange parity. Ends with a block barrier; T holds the plan.
__device__ __forceinline__ void ipot_loop(cg::cluster_group& cl, const float* A, float* T,
                                          float* delta, float* sigma, float* recv,
                                          size_t recv_stride, float* red, int nr, int n, int m,
                                          int iters, int& par) {
  const int c = cl.num_blocks(), r = cl.block_rank();
  const size_t mp = round4(m);
  for (int j = threadIdx.x; j < m; j += CTHREADS) sigma[j] = 1.f / (float)m;
  __syncthreads();
  for (int k = 0; k < iters; ++k) {
    row_update(A, T, delta, sigma, nr, n, m, k == 0, true, nullptr);
    __syncthreads();
    float* rv = recv + par * recv_stride;
    col_partial(red, nr, m, [&](int i, size_t e) { return (A[e] * T[e]) * delta[i]; },
                [&](int j, float s) { push(cl, rv, r, c, mp, j, s); });
    cl.sync();
    for (int j = threadIdx.x; j < m; j += CTHREADS)
      sigma[j] = 1.f / ((float)m * recv_sum(rv, c, mp, j));
    __syncthreads();
    par ^= 1;
  }
  row_update(A, T, delta, sigma, nr, n, m, iters == 0, false, nullptr);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// f32 tile product (K10): out(i, j) = sum_k X(i, k) Y(k, j), i < M, j < N,
// k < K, in tiles of TM x TN outputs, k stages of TK, every sum over k in
// order with fmaf (the order of ipot_common.cuh's block_gemm). The loaders
// xl(i, k), yl(k, j) fetch one element each (any memory: device, local or a
// peer's shared memory); the next stage is fetched into registers while the
// current one is multiplied, then stored to the other half of a
// double-buffered stage in shared memory. Warp w covers
// rows 16 (w / 4) and columns 32 (w % 4) of the tile, its lanes 4 x 8, each
// thread 4 x 4 outputs; each k's fragments are read while the previous k's
// are multiplied. Two float4 reads (4 shared-memory cycles each per warp)
// per 16 FFMA make it bound by shared-memory reads at about half the FFMA
// rate; 8 x 8 outputs per thread would balance them but need more registers
// than 512 threads may hold (they spilled).
// K_FAST_Y: Y's k index is the contiguous one (fetch along k).
// epi(i, j, acc) consumes each output. stage: stage_floats() floats.
// ---------------------------------------------------------------------------
constexpr int TM = 64, TN = 128, TK = 16;
constexpr int XS = TM + 4, YS = TN + 4;   // padded stage rows
static_assert(CTHREADS == 512, "the tile layout assumes 16 warps");

__host__ __device__ constexpr int stage_floats() { return 2 * TK * (XS + YS); }

template <bool K_FAST_Y, class XL, class YL, class Epi>
__device__ __forceinline__ void tile_gemm(int M, int N, int K, float* stage, XL xl, YL yl,
                                          Epi epi) {
  constexpr int XN = TM * TK / CTHREADS, YN = TK * TN / CTHREADS;   // 2, 4 per thread
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 2) * 4 + (lane >> 3);   // row quad of the tile (0..15)
  const int tx = (warp & 3) * 8 + (lane & 7);     // column quad of the tile (0..31)
  for (int i0 = 0; i0 < M; i0 += TM)
    for (int j0 = 0; j0 < N; j0 += TN) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      float xr[XN], yr[YN];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int q = 0; q < XN; ++q) {
          const int e = tid + q * CTHREADS, i = i0 + e / TK, k = k0 + e % TK;
          xr[q] = (i < M && k < K) ? xl(i, k) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < YN; ++q) {
          const int e = tid + q * CTHREADS;
          const int k = k0 + (K_FAST_Y ? e % TK : e / TN);
          const int j = j0 + (K_FAST_Y ? e / TK : e % TN);
          yr[q] = (j < N && k < K) ? yl(k, j) : 0.f;
        }
      };
      auto put = [&](float* st) {
        float* Xs = st;
        float* Ys = st + TK * XS;
#pragma unroll
        for (int q = 0; q < XN; ++q) {
          const int e = tid + q * CTHREADS;
          Xs[(e % TK) * XS + e / TK] = xr[q];
        }
#pragma unroll
        for (int q = 0; q < YN; ++q) {
          const int e = tid + q * CTHREADS;
          if (K_FAST_Y) Ys[(e % TK) * YS + e / TK] = yr[q];
          else Ys[(e / TN) * YS + e % TN] = yr[q];
        }
      };
      const int KT = (K + TK - 1) / TK;
      fetch(0);
      put(stage);
      __syncthreads();
      for (int kt = 0; kt < KT; ++kt) {
        if (kt + 1 < KT) fetch((kt + 1) * TK);
        const float* Xs = stage + (kt & 1) * TK * (XS + YS);
        const float* Ys = Xs + TK * XS;
        float4 xv = *reinterpret_cast<const float4*>(&Xs[ty * 4]);
        float4 yv = *reinterpret_cast<const float4*>(&Ys[tx * 4]);
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          float4 xn = xv, yn = yv;
          if (kk + 1 < TK) {
            xn = *reinterpret_cast<const float4*>(&Xs[(kk + 1) * XS + ty * 4]);
            yn = *reinterpret_cast<const float4*>(&Ys[(kk + 1) * YS + tx * 4]);
          }
          const float x[4] = {xv.x, xv.y, xv.z, xv.w};
          const float y[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(x[r], y[q], acc[r][q]);
          xv = xn;
          yv = yn;
        }
        if (kt + 1 < KT) put(stage + ((kt + 1) & 1) * TK * (XS + YS));
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + ty * 4 + r, j = j0 + tx * 4 + q;
          if (i < M && j < N) epi(i, j, acc[r][q]);
        }
    }
}

// ---------------------------------------------------------------------------
// 1-D bulk copies (K9's history) with an mbarrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// bytes (a multiple of 16) from src (16-byte aligned) into dst (shared), the
// completion reported to bar; one thread issues it
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
inline cudaLaunchConfig_t cluster_config(int problems, int c, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr, int threads) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)problems * (unsigned)c, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One cluster of c blocks of THREADS_ threads per problem (grid = problems
// * c). Returns the cudaError_t of the launch; a cluster size outside 1..8 or
// shared memory above the per-block limit is refused as cudaErrorInvalidValue.
template <int THREADS_ = CTHREADS, class... Params, class... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int problems, int c, size_t smem,
                                   cudaStream_t stream, Args... args) {
  if (c < 1 || c > MAX_CLUSTER || problems < 1 || smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(problems, c, smem, stream, &attr, THREADS_);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for this kernel at c and smem (negative: the
// cudaError_t of the query, negated)
template <int THREADS_ = CTHREADS, class... Params>
inline int active_clusters(void (*kernel)(Params...), int c, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, c, smem, 0, &attr, THREADS_);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // namespace cluster
}  // namespace madeleine_ipot
