// One hand-written bf16 tensor-core GEMM for the train kernels (K6, K7).
//
//   C[m, n] (+)= act(sum_k A(m, k) * B(n, k) + bias[n])
//
// A and B are bf16 with f32 accumulation through mma.sync m16n8k16. Each
// operand is either "k-contiguous" (element (r, k) at P[r * ld + k]) or
// "r-contiguous" (at P[k * ld + r]); the template picks the layout, so one
// kernel covers the forward products X.W^T (both k-contiguous), the input
// gradients dZ.W (B r-contiguous) and the weight gradients dZ^T.H (both
// r-contiguous, the reduction running over all tokens).
//
// Design: 128 x 128 output tile per block, 8 warps of 64 x 32, k tiles of 32
// in a 3-stage cp.async ring in shared memory. Each tile keeps its operand's
// own layout in shared memory (rows padded so that ldmatrix reads are free of
// bank conflicts); fragments come from ldmatrix, with .trans for an
// r-contiguous operand, so no thread transposes anything.
//
// Batches run on blockIdx.z (per-batch strides of A, B, C and bias). Split-K
// (splits > 1) cuts the k range into `splits` pieces whose partial tiles go
// to C + (batch * splits + split) * strideC; `splitk_reduce` then sums them in
// split order. No atomics anywhere: equal inputs give bitwise-equal outputs.
//
// Requirements (checked by the host launcher): the contiguous dimension of
// each operand is a multiple of 8 and 16-byte aligned; k-contiguous operands
// need K % 8 == 0; r-contiguous A needs M % 8 == 0, r-contiguous B N % 8 == 0;
// C's row stride and batch stride are even.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace madeleine {

typedef __nv_bfloat16 bf16;

constexpr int G_BM = 128, G_BN = 128, G_BK = 32;
constexpr int G_STAGES = 3;
constexpr int G_SK = G_BK + 8;   // row stride (bf16) of a k-contiguous tile [128][32]: 80 B
constexpr int G_SR = G_BM + 8;   // row stride (bf16) of an r-contiguous tile [32][128]: 272 B
constexpr int G_THREADS = 256;

enum GemmAct { ACT_NONE = 0, ACT_GATES = 1 };

struct GemmArgs {
  const bf16* A;
  const bf16* B;
  void* C;
  const float* bias;   // [N] per batch, or null
  long long lda, ldb, ldc;
  long long strideA, strideB, strideC, strideBias;  // per batch (blockIdx.z)
  int M, N, K;
  int splits;    // split-K pieces (1 = none)
  int beta;      // 1: C += result (f32 output, no split)
  int act;       // ACT_GATES: tanh for n < act_split, sigmoid from there
  int act_split;
};

template <bool KC>
__host__ __device__ constexpr int g_tile_elems() { return KC ? G_BM * G_SK : G_BK * G_SR; }

template <bool AKC, bool BKC>
__host__ __device__ constexpr int g_smem_bytes() {
  return G_STAGES * (g_tile_elems<AKC>() + g_tile_elems<BKC>()) * (int)sizeof(bf16);
}

__device__ __forceinline__ void g_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t g_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <bool TRANS>
__device__ __forceinline__ void g_ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// 16-byte global -> shared copy; zero-fills when !pred (src is then unread).
__device__ __forceinline__ void g_cp16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void g_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void g_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One operand tile (128 rows x 32 k) of stage S: 2 cp.async of 16 B per thread.
template <bool KC>
__device__ __forceinline__ void g_load(bf16* S, const bf16* __restrict__ P, long long ld, int r0,
                                       int rlim, int k0, int klim, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * G_THREADS;
    if (KC) {
      const int r = idx >> 2, kv = (idx & 3) * 8;
      const bool ok = r0 + r < rlim && k0 + kv < klim;
      g_cp16(g_smem_addr(S + r * G_SK + kv), ok ? P + (long long)(r0 + r) * ld + k0 + kv : P,
             ok);
    } else {
      const int kr = idx >> 4, rv = (idx & 15) * 8;
      const bool ok = k0 + kr < klim && r0 + rv < rlim;
      g_cp16(g_smem_addr(S + kr * G_SR + rv), ok ? P + (long long)(k0 + kr) * ld + r0 + rv : P,
             ok);
    }
  }
}

// A fragments (16 rows from r0, k16 step ks) of mma.m16n8k16.
template <bool KC>
__device__ __forceinline__ void g_frag_a(uint32_t (&a)[4], const bf16* S, int r0, int ks,
                                         int lane) {
  const int i = lane >> 3, j = lane & 7;
  if (KC)
    g_ldsm_x4<false>(a, g_smem_addr(S + (r0 + j + (i & 1) * 8) * G_SK + ks + (i >> 1) * 8));
  else
    g_ldsm_x4<true>(a, g_smem_addr(S + (ks + j + (i >> 1) * 8) * G_SR + r0 + (i & 1) * 8));
}

// B fragments of two n8 tiles (16 columns from c0): {b0, b1} of the first, then the second.
template <bool KC>
__device__ __forceinline__ void g_frag_b(uint32_t (&b)[4], const bf16* S, int c0, int ks,
                                         int lane) {
  const int i = lane >> 3, j = lane & 7;
  if (KC)
    g_ldsm_x4<false>(b, g_smem_addr(S + (c0 + j + (i >> 1) * 8) * G_SK + ks + (i & 1) * 8));
  else
    g_ldsm_x4<true>(b, g_smem_addr(S + (ks + j + (i & 1) * 8) * G_SR + c0 + (i >> 1) * 8));
}

__device__ __forceinline__ void g_out2(float* p, float v0, float v1, bool both, int beta) {
  if (both) {
    float2 v = make_float2(v0, v1);
    if (beta) {
      const float2 o = *reinterpret_cast<const float2*>(p);
      v.x += o.x;
      v.y += o.y;
    }
    *reinterpret_cast<float2*>(p) = v;
  } else {
    *p = beta ? *p + v0 : v0;
  }
}

__device__ __forceinline__ void g_out2(bf16* p, float v0, float v1, bool both, int) {
  if (both)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  else
    *p = __float2bfloat16(v0);
}

template <bool AKC, bool BKC, typename OutT>
__global__ void __launch_bounds__(G_THREADS, 2) gemm_bf16_kernel(GemmArgs g) {
  extern __shared__ __align__(16) unsigned char g_smem[];
  bf16* As = reinterpret_cast<bf16*>(g_smem);
  bf16* Bs = As + G_STAGES * g_tile_elems<AKC>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int batch = blockIdx.z / g.splits, split = blockIdx.z % g.splits;
  const int m0 = blockIdx.y * G_BM, n0 = blockIdx.x * G_BN;
  const bf16* A = g.A + batch * g.strideA;
  const bf16* B = g.B + batch * g.strideB;
  const int kchunk = ((g.K + g.splits - 1) / g.splits + G_BK - 1) / G_BK * G_BK;
  const int kbeg = split * kchunk;
  const int kend = min(g.K, kbeg + kchunk);
  const int nk = kend > kbeg ? (kend - kbeg + G_BK - 1) / G_BK : 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[i][j][l] = 0.f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < nk) {
      g_load<AKC>(As + s * g_tile_elems<AKC>(), A, g.lda, m0, g.M, kbeg + s * G_BK, kend, tid);
      g_load<BKC>(Bs + s * g_tile_elems<BKC>(), B, g.ldb, n0, g.N, kbeg + s * G_BK, kend, tid);
    }
    g_commit();
  }
  for (int it = 0; it < nk; ++it) {
    g_wait<G_STAGES - 2>();
    __syncthreads();
    const int nxt = it + G_STAGES - 1;
    if (nxt < nk) {
      const int st = nxt % G_STAGES;
      g_load<AKC>(As + st * g_tile_elems<AKC>(), A, g.lda, m0, g.M, kbeg + nxt * G_BK, kend,
                  tid);
      g_load<BKC>(Bs + st * g_tile_elems<BKC>(), B, g.ldb, n0, g.N, kbeg + nxt * G_BK, kend,
                  tid);
    }
    g_commit();
    const bf16* as = As + (it % G_STAGES) * g_tile_elems<AKC>();
    const bf16* bs = Bs + (it % G_STAGES) * g_tile_elems<BKC>();
#pragma unroll
    for (int ks = 0; ks < G_BK; ks += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) g_frag_a<AKC>(a[mt], as, wm * 64 + mt * 16, ks, lane);
#pragma unroll
      for (int p = 0; p < 2; ++p) g_frag_b<BKC>(b[p], bs, wn * 32 + p * 16, ks, lane);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          g_mma(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  g_wait<0>();

  OutT* C = reinterpret_cast<OutT*>(g.C) + (long long)blockIdx.z * g.strideC;
  const float* bias = g.bias ? g.bias + batch * g.strideBias : nullptr;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mt * 16 + gq + h * 8;
        const int n = n0 + wn * 32 + nt * 8 + q * 2;
        if (m >= g.M || n >= g.N) continue;
        float v[2] = {acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (bias && n + j < g.N) v[j] += bias[n + j];
          if (g.act == ACT_GATES)
            v[j] = n + j < g.act_split ? tanhf(v[j]) : 1.f / (1.f + expf(-v[j]));
        }
        g_out2(C + (long long)m * g.ldc + n, v[0], v[1], n + 1 < g.N, g.beta);
      }
}

// out[batch][i] = sum over s of part[batch * splits + s][i], in split order.
__global__ void splitk_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     long long n, int splits, int batches) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * batches) return;
  const long long bt = i / n, j = i - bt * n;
  const float* p = part + bt * splits * n + j;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += p[(long long)k * n];
  out[i] = s;
}

// Split count for a weight-gradient product: about two waves of 132 SMs.
inline int splitk_count(int M, int N, int K, int batches) {
  const long long tiles = (long long)((M + G_BM - 1) / G_BM) * ((N + G_BN - 1) / G_BN) * batches;
  long long s = (264 + tiles - 1) / tiles;
  const long long kmax = (K + 4 * G_BK - 1) / (4 * G_BK);  // at least 4 k tiles each
  if (s > kmax) s = kmax;
  if (s > 64) s = 64;
  return s < 1 ? 1 : (int)s;
}

template <bool AKC, bool BKC, typename OutT>
inline cudaError_t launch_gemm(const GemmArgs& g, int batches, cudaStream_t stream) {
  const bool ok = (AKC ? g.K % 8 == 0 && g.lda % 8 == 0 : g.M % 8 == 0 && g.lda % 8 == 0) &&
                  (BKC ? g.K % 8 == 0 && g.ldb % 8 == 0 : g.N % 8 == 0 && g.ldb % 8 == 0) &&
                  (reinterpret_cast<uintptr_t>(g.A) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(g.B) % 16 == 0) && g.strideA % 8 == 0 &&
                  g.strideB % 8 == 0 && g.ldc % 2 == 0 && g.strideC % 2 == 0 &&
                  (g.splits == 1 || (g.beta == 0 && !g.bias));
  if (!ok) return cudaErrorInvalidValue;
  constexpr int smem = g_smem_bytes<AKC, BKC>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16_kernel<AKC, BKC, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((g.N + G_BN - 1) / G_BN, (g.M + G_BM - 1) / G_BM, batches * g.splits);
  gemm_bf16_kernel<AKC, BKC, OutT><<<grid, G_THREADS, smem, stream>>>(g);
  return cudaGetLastError();
}

// Weight gradient out[batch] [M, N] f32 = sum over K of A(m, k) B(n, k),
// both operands r-contiguous, split over K into `work` and reduced in order.
inline cudaError_t launch_wgrad(GemmArgs g, int batches, float* out, float* work,
                                cudaStream_t stream) {
  g.splits = splitk_count(g.M, g.N, g.K, batches);
  g.C = work;
  g.ldc = g.N;
  g.strideC = (long long)g.M * g.N;
  g.beta = 0;
  g.bias = nullptr;
  g.act = ACT_NONE;
  cudaError_t err = launch_gemm<false, false, float>(g, batches, stream);
  if (err != cudaSuccess) return err;
  const long long n = (long long)g.M * g.N;
  splitk_reduce_kernel<<<(unsigned)((n * batches + 255) / 256), 256, 0, stream>>>(
      work, out, n, g.splits, batches);
  return cudaGetLastError();
}

// Floats of split-K workspace launch_wgrad needs for these shapes.
inline long long wgrad_work_floats(int M, int N, int K, int batches) {
  return (long long)splitk_count(M, N, K, batches) * batches * M * N;
}

}  // namespace madeleine
