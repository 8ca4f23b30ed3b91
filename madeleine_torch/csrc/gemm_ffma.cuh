// The products of the per-op kernels 15-18 with f32 operands (the JAX
// package's parity route, --precision float32, on the per-op lane) on the
// SIMT tile product of gemm_f32.cuh: full f32, FFMA, no tensor cores, every
// sum over k of a piece in order from 0 with fmaf. It was first written for
// K6 and K7 with f32 operands, which now run on gemm_tf32.cuh's split-TF32
// wgmma GEMM.
//
// One kernel template, one 256-thread block per 128 x 128 output tile, two
// blocks per SM; grid (column tiles, row tiles, batches x splits), column
// tiles fastest so that the blocks in flight share their row tile of X. The
// forms the launch sequences of train_rows.cuh need (Gemm::FFMA there):
//   linear  Z = X W^T + bias            X, W K-major (the activations, the
//                                       weights as stored, [out, in])
//   dgrad   C (+)= A B                  A K-major, B MN-major (the weights as
//                                       stored), batched, beta 1 accumulates
//   wgrad   out = A^T B over tokens     both token-major (MN-major); the
//                                       tokens split into pieces of whole
//                                       16-token stages (`splits`), each
//                                       piece's partial into a workspace,
//                                       the partials then summed in piece
//                                       order (gemm_bf16.cuh's
//                                       splitk_reduce_kernel)
//   gates   K6's gate product with the gate itself in the epilogue (EPI_GATES
//           below), on the permuted [Wa; Wb] the bf16 route uses.
// Every offset is 64-bit: at [65, 8192] the gate products' outputs hold
// 2.18e9 elements.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"   // splitk_reduce_kernel
#include "gemm_f32.cuh"
#include "philox.cuh"

namespace madeleine {
namespace ff {

namespace g32 = madeleine_gemm_f32;

enum Epi { EPI_STORE = 0, EPI_GATES = 1 };

// A batched product out_z(i, j) = sum_k X_z(i, k) Y_z(k, j), z = batch *
// splits + split; X_z(i, k) = X[z_b xb + i xsx + k xsk] for i < xrows, Y_z(k,
// j) = Y[z_b yb + j ysx + k ysk] for j < yrows, k within the split's piece.
struct Args {
  const float* X;
  long long xsx, xsk, xb;
  int xrows;
  const float* Y;
  long long ysx, ysk, yb;
  int yrows;
  int K, kchunk, splits;
  float* C;                 // out_z(i, j) at C + z cz + i ldc + j
  long long ldc, cz;
  const float* bias;        // [yrows] of batch b at bias + b bb, or null
  long long bb;
  int beta;                 // EPI_STORE: C += out
  // EPI_GATES: batch h is head h; the pre-dropout activations a_pre, b_pre
  // (skipped when null; head h's columns of row i at i ldg + h hs), the
  // logit partials lpart [xrows, nh, f / 64] (skipped when null), wc [nh,
  // f], and what keys the gate dropout
  float *ap, *bp, *lpart;
  long long ldg, hs;
  const float* wc;
  int nh, f, t, row_offset;
  Dropout d;
};

__device__ __forceinline__ float sigmoid_exact(float v) { return 1.f / (1.f + expf(-v)); }

// The gate epilogue of one tile (batch h = head, column tile `chunk` of the
// permuted 2f columns: 64 tanh columns, then the sigmoid columns of the same
// 64 gate columns j = 64 chunk + 4 tx + c, so thread (ty, tx) holds a and g
// of its four j in acc[r][0:4] and acc[r][4:8]). Per row: a = tanh, g =
// sigmoid (exact), their dropout (keep4 at column group 16 chunk + tx,
// streams 3 + 2h and 4 + 2h), a_pre and b_pre stored, and the partial logit
// of the tile's 64 j: each thread sums its four j in order, then the 16
// threads of the row in a fixed xor order (1, 2, 4, 8), written by tx = 0.
__device__ __forceinline__ void epilogue_gates(const Args& a, const float (&acc)[8][8], int h,
                                               int i0, int j0) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int chunk = j0 / 128, jg = chunk * 64 + 4 * tx;   // first gate column of the thread
  const float* bab = a.bias + (long long)h * a.bb + j0;
  float ba[4], bg[4], wc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ba[c] = bab[4 * tx + c];
    bg[c] = bab[64 + 4 * tx + c];
    wc[c] = a.wc[(long long)h * a.f + jg + c];
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + 64 * (r >> 2) + 4 * ty + (r & 3);   // may be >= xrows
    float av[4], gv[4], ka[4], kb[4];
    keep4(a.d, 16 * chunk + tx, i % a.t, i / a.t + a.row_offset, 3 + 2 * h, ka);
    keep4(a.d, 16 * chunk + tx, i % a.t, i / a.t + a.row_offset, 4 + 2 * h, kb);
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      av[c] = tanhf(acc[r][c] + ba[c]);
      gv[c] = sigmoid_exact(acc[r][4 + c] + bg[c]);
      part += (av[c] * ka[c]) * (gv[c] * kb[c]) * wc[c];
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (i >= a.xrows) continue;
    if (a.ap) {
      *reinterpret_cast<float4*>(a.ap + (long long)i * a.ldg + h * a.hs + jg) =
          make_float4(av[0], av[1], av[2], av[3]);
      *reinterpret_cast<float4*>(a.bp + (long long)i * a.ldg + h * a.hs + jg) =
          make_float4(gv[0], gv[1], gv[2], gv[3]);
    }
    if (tx == 0 && a.lpart) a.lpart[((long long)i * a.nh + h) * (a.f / 64) + chunk] = part;
  }
}

template <bool XK, bool YK, int EPI>
__global__ void __launch_bounds__(g32::THREADS, 2) tile_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int z = blockIdx.z, batch = z / a.splits, split = z % a.splits;
  const long long k0 = (long long)split * a.kchunk;
  const int K = (int)(a.K - k0 < a.kchunk ? a.K - k0 : a.kchunk);
  const g32::Operand X{a.X + batch * a.xb + k0 * a.xsk, a.xsx, a.xsk, a.xrows};
  const g32::Operand Y{a.Y + batch * a.yb + k0 * a.ysk, a.ysx, a.ysk, a.yrows};
  const int i0 = blockIdx.y * g32::TILE, j0 = blockIdx.x * g32::TILE;
  auto nothing = [] {};
  if constexpr (EPI == EPI_GATES) {
    float acc[8][8];
    g32::tile_accumulate<XK, YK>(X, Y, K, i0, j0, smem, nothing, acc);
    epilogue_gates(a, acc, batch, i0, j0);
  } else {
    float* C = a.C + (long long)z * a.cz;
    const float* bias = a.bias ? a.bias + batch * a.bb : nullptr;
    const bool vec = a.ldc % 4 == 0 && (reinterpret_cast<uintptr_t>(C) & 15) == 0;
    g32::tile_product<XK, YK>(X, Y, K, i0, j0, smem, nothing,
                              [&](int i, int j, const float (&v)[4]) {
      float* o = C + (long long)i * a.ldc + j;
      float r[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) r[c] = bias && j + c < a.yrows ? v[c] + bias[j + c] : v[c];
      if (vec && j + 3 < a.yrows) {
        float4* o4 = reinterpret_cast<float4*>(o);
        if (a.beta) {
          const float4 p = *o4;
          *o4 = make_float4(p.x + r[0], p.y + r[1], p.z + r[2], p.w + r[3]);
        } else {
          *o4 = make_float4(r[0], r[1], r[2], r[3]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < a.yrows) o[c] = a.beta ? o[c] + r[c] : r[c];
      }
    });
  }
}

template <bool XK, bool YK, int EPI>
inline cudaError_t launch(const Args& a, int batches, cudaStream_t st) {
  if (a.xrows < 1 || a.yrows < 1 || a.K < 1 || batches < 1 || a.splits < 1) return cudaSuccess;
  const dim3 grid((unsigned)g32::tiles(a.yrows), (unsigned)g32::tiles(a.xrows),
                  (unsigned)(batches * a.splits));
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tile_kernel<XK, YK, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)g32::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  tile_kernel<XK, YK, EPI><<<grid, g32::THREADS, g32::SMEM_BYTES, st>>>(a);
  return cudaGetLastError();
}

// Blocks a launch should offer: two per SM of an H100 (132 SMs).
constexpr int SPLIT_TARGET_BLOCKS = 264;
constexpr int SPLIT_MIN_TOKENS = 1024;   // the shortest piece of a split weight gradient

// The piece length of a weight gradient [Mo, No] (x batches) over `tokens`:
// as many pieces as keep the launch near SPLIT_TARGET_BLOCKS blocks, each at
// least SPLIT_MIN_TOKENS tokens, a whole number of 16-token stages
// (ops/encoder_train.py::ffma_wgrad_chunk mirrors it).
inline int wgrad_chunk(int Mo, int No, int tokens, int batches) {
  const long long tiles = (long long)g32::tiles(Mo) * g32::tiles(No) * batches;
  long long s = (SPLIT_TARGET_BLOCKS + tiles - 1) / tiles;
  const long long smax = (tokens + SPLIT_MIN_TOKENS - 1) / SPLIT_MIN_TOKENS;
  if (s > smax) s = smax;
  if (s < 1) s = 1;
  long long chunk = (tokens + s - 1) / s;
  chunk = (chunk + g32::BK - 1) / g32::BK * g32::BK;
  return (int)chunk;
}

inline int wgrad_splits(int Mo, int No, int tokens, int batches) {
  const int chunk = wgrad_chunk(Mo, No, tokens, batches);
  return (tokens + chunk - 1) / chunk;
}

// Floats of split workspace `wgrad` needs (0 with one piece).
inline long long wgrad_work_floats(int Mo, int No, int tokens, int batches) {
  const int s = wgrad_splits(Mo, No, tokens, batches);
  return s > 1 ? (long long)s * batches * Mo * No : 0;
}

// The f32 gate product with the gate in its epilogue, every head in one
// launch: batch h reads y [M, nh e] at column h e and the permuted [Wa;
// Wb]_h (wab [nh, 2f, e], bab [nh, 2f]) at row h 2f; writes, where set,
// a_pre and b_pre (pre-dropout; head h's f columns of row i at i ldg + h
// hs) and the logit partials lpart [M, nh, f / 64]. The per-op kernel 17
// with f32 operands writes the partials, kernel 18's recompute the
// activations alone, per head [a_pre | b_pre] in one [M, nh 2f] buffer.
inline cudaError_t gates(const float* y, const float* wab, const float* bab, const float* wc,
                         float* ap, float* bp, long long ldg, long long hs, float* lpart, int M,
                         int nh, int e, int f, int t, int row_offset, Dropout d,
                         cudaStream_t st) {
  Args g{};
  g.X = y; g.xsx = (long long)nh * e; g.xsk = 1; g.xb = e; g.xrows = M;
  g.Y = wab; g.ysx = e; g.ysk = 1; g.yb = 2LL * f * e; g.yrows = 2 * f;
  g.K = e; g.kchunk = e; g.splits = 1;
  g.bias = bab; g.bb = 2LL * f;
  g.ap = ap; g.bp = bp; g.ldg = ldg; g.hs = hs; g.lpart = lpart; g.wc = wc;
  g.nh = nh; g.f = f; g.t = t; g.row_offset = row_offset;
  g.d = d;
  return launch<true, true, EPI_GATES>(g, nh, st);
}

// Z [M, N] = X [M, K] W [N, K]^T + bias [N].
inline cudaError_t linear(const float* X, const float* W, const float* bias, float* Z, int M,
                          int N, int K, cudaStream_t st) {
  Args a{};
  a.X = X; a.xsx = K; a.xsk = 1; a.xrows = M;
  a.Y = W; a.ysx = K; a.ysk = 1; a.yrows = N;
  a.K = K; a.kchunk = K; a.splits = 1;
  a.C = Z; a.ldc = N;
  a.bias = bias;
  return launch<true, true, EPI_STORE>(a, 1, st);
}

// C [tokens, N] (+)= A [tokens, K] . B [K, N], batched as train_rows.cuh's
// dgrad: batch z's A columns at z strideA, its B at z strideB, its C columns
// at z strideC.
inline cudaError_t dgrad(const float* A, long long lda, long long strideA, const float* B,
                         long long ldb, long long strideB, float* C, long long ldc,
                         long long strideC, int tokens, int N, int K, int batches, int beta,
                         cudaStream_t st) {
  Args a{};
  a.X = A; a.xsx = lda; a.xsk = 1; a.xb = strideA; a.xrows = tokens;
  a.Y = B; a.ysx = 1; a.ysk = ldb; a.yb = strideB; a.yrows = N;
  a.K = K; a.kchunk = K; a.splits = 1;
  a.C = C; a.ldc = ldc; a.cz = strideC;
  a.beta = beta;
  return launch<true, false, EPI_STORE>(a, batches, st);
}

// out [batches, Mo, No] = sum over tokens of A(tok, m) B(tok, n), both
// token-major (batch z's columns at z strideA, z strideB); the pieces'
// partials into work, summed in piece order.
inline cudaError_t wgrad(const float* A, long long lda, long long strideA, const float* B,
                         long long ldb, long long strideB, int Mo, int No, int tokens,
                         int batches, float* out, float* work, cudaStream_t st) {
  Args a{};
  a.X = A; a.xsx = 1; a.xsk = lda; a.xb = strideA; a.xrows = Mo;
  a.Y = B; a.ysx = 1; a.ysk = ldb; a.yb = strideB; a.yrows = No;
  a.K = tokens;
  a.kchunk = wgrad_chunk(Mo, No, tokens, batches);
  a.splits = (tokens + a.kchunk - 1) / a.kchunk;
  const long long n = (long long)Mo * No;
  a.C = a.splits > 1 ? work : out;
  a.ldc = No; a.cz = n;
  cudaError_t err = launch<false, false, EPI_STORE>(a, batches, st);
  if (err != cudaSuccess || a.splits == 1) return err;
  splitk_reduce_kernel<<<(unsigned)((n * batches + 255) / 256), 256, 0, st>>>(work, out, n,
                                                                             a.splits, batches);
  return cudaGetLastError();
}

}  // namespace ff
}  // namespace madeleine
