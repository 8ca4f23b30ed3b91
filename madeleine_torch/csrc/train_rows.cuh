// Row kernels and launch sequences shared by the train kernels: the
// whole-encoder forward and backward (K6, K7) and the per-op lane's
// pre-attention MLP (kernels 15, 16), gate logits (17, 18) and token
// projector (19, 20). Each is the device code of one piece of the model;
// K6/K7 chain all of them, the per-op kernels one each.
//
// Row kernels put one 4-column group of a row on each thread; the backward
// ones loop over 64-row tiles (ROW_TILE) and write per-tile column partials
// that colsum_reduce sums in tile order. Nothing uses atomics: two launches
// on the same inputs give bitwise-equal results. The activations, residuals
// and cotangents of K6 / K7 are of the call's type T: bf16 on the bf16 route
// (every product on the wgmma GEMM), f32 on the f32 route (every product on
// gemm_tf32.cuh's split-TF32 wgmma GEMM, Gemm::TF32; the per-op kernels
// 15-18 with f32 operands on gemm_ffma.cuh's FFMA tiles, Gemm::FFMA), where
// nothing is rounded between layers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"
#include "gemm_ffma.cuh"
#include "gemm_tf32.cuh"
#include "gemm_wgmma.cuh"
#include "train_common.cuh"

#define TRAIN_CHECK(x)                         \
  do {                                         \
    cudaError_t err_ = (x);                    \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

namespace madeleine {

// One row per block, W/4 threads, 4 columns each: LayerNorm + GELU + dropout.
// Z [M, W] f32 pre-LN rows (bias included). Writes, where the pointer is
// set, rstd[r * 3 + layer], U (u in T) and H (the output in T); with y32
// also the f32 output back into Z.
template <typename T>
__global__ void ln_gelu_fwd(float* __restrict__ Z, const float* __restrict__ s,
                            const float* __restrict__ sh, T* __restrict__ U,
                            float* __restrict__ rstd, T* __restrict__ H, int W, int t,
                            int row_offset, int layer, Dropout d, int y32) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const int c = threadIdx.x * 4, nw = blockDim.x >> 5;
  float z[4];
  load4(Z + r * W + c, z);
  const float mean = group_sum(z[0] + z[1] + z[2] + z[3], red, 0, nw) / W;
  float dv = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) dv += (z[j] - mean) * (z[j] - mean);
  const float var = group_sum(dv, red, 0, nw) / W;
  const float rs = rsqrtf(var + TRAIN_LN_EPS);
  float k[4];
  keep4(d, threadIdx.x, (int)(r % t), (int)(r / t) + row_offset, layer, k);
  float u[4], h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = (z[j] - mean) * rs;
    const float v = u[j] * s[c + j] + sh[c + j];
    h[j] = v * gauss_cdf(v) * k[j];
  }
  if (U) store4(U + r * W + c, u);
  if (H) store4(H + r * W + c, h);
  if (y32) store4(Z + r * W + c, h);
  if (rstd && threadIdx.x == 0) rstd[r * 3 + layer] = rs;
}

// One row per block, nh*f/4 threads (f % 128 == 0): gate dropout and logits.
// G [M, nh*2f] f32 holds per head [tanh branch | sigmoid branch]; writes
// l [M, nh] (plus bias[r] where bias is set) and, where set, ap / bp
// [M, nh*f] bf16 (pre-dropout).
__global__ void gate_logits_fwd(const float* __restrict__ G, const float* __restrict__ wc,
                                const float* __restrict__ bc, const float* __restrict__ bias,
                                float* __restrict__ l, bf16* __restrict__ ap,
                                bf16* __restrict__ bp, int nh, int f, int t, int row_offset,
                                Dropout d) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const int tpb = f / 4, h = threadIdx.x / tpb, c4 = threadIdx.x % tpb, j0 = c4 * 4;
  const int tok = (int)(r % t), row = (int)(r / t) + row_offset;
  float a[4], g[4], ka[4], kb[4], w[4];
  load4(G + r * nh * 2 * f + h * 2 * f + j0, a);
  load4(G + r * nh * 2 * f + h * 2 * f + f + j0, g);
  load4(wc + h * f + j0, w);
  keep4(d, c4, tok, row, 3 + 2 * h, ka);
  keep4(d, c4, tok, row, 4 + 2 * h, kb);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc += (a[j] * ka[j]) * (g[j] * kb[j]) * w[j];
  if (ap) store4(ap + r * nh * f + h * f + j0, a);
  if (bp) store4(bp + r * nh * f + h * f + j0, g);
  const int wph = tpb / 32;
  const float sum = group_sum(acc, red, h * wph, wph);
  if (c4 == 0) l[r * nh + h] = sum + bc[h] + (bias ? bias[r] : 0.f);
}

// One thread per (row, head): l = the partials of its f / 64 column chunks
// summed in chunk order + bc[h] + bias[row].
__global__ void gate_logits_sum(const float* __restrict__ lpart, const float* __restrict__ bc,
                                const float* __restrict__ bias, float* __restrict__ l,
                                long long M, int nh, int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * nh) return;
  const float* pp = lpart + i * chunks;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += pp[c];
  l[i] = s + bc[i % nh] + (bias ? bias[i / nh] : 0.f);
}

// Gate adjoint. Block = 64-row tile, nh*f/4 threads. The pre-dropout gate
// activations of row r, head h are AP / BP + r * ldg + h * hs (saved
// residuals, or the f32 recomputed products). Writes DZG [M, nh*2f] in DT
// (per head [dza | dzb]) and per-tile column partials
// part[tile, 0 : nh*f] = dwc, part[tile, nh*f + h*2f + j] = dba / dbb.
template <typename GT, typename DT = bf16>
__global__ void gate_bwd(const GT* __restrict__ AP, const GT* __restrict__ BP, long long ldg,
                         int hs, const float* __restrict__ DL, const float* __restrict__ wc,
                         DT* __restrict__ DZG, float* __restrict__ part, long long ld_part,
                         int M, int t, int nh, int f, int row_offset, Dropout d) {
  const int tpb = f / 4, h = threadIdx.x / tpb, c4 = threadIdx.x % tpb, j0 = c4 * 4;
  float w[4], dwc[4] = {0.f, 0.f, 0.f, 0.f}, dba[4] = {0.f, 0.f, 0.f, 0.f},
              dbb[4] = {0.f, 0.f, 0.f, 0.f};
  load4(wc + h * f + j0, w);
  const long long r0 = (long long)blockIdx.x * ROW_TILE;
  for (int i = 0; i < ROW_TILE; ++i) {
    const long long r = r0 + i;
    if (r >= M) break;
    const int tok = (int)(r % t), row = (int)(r / t) + row_offset;
    float ap[4], bp[4], ka[4], kb[4], za[4], zb[4];
    load4(AP + r * ldg + h * hs + j0, ap);
    load4(BP + r * ldg + h * hs + j0, bp);
    keep4(d, c4, tok, row, 3 + 2 * h, ka);
    keep4(d, c4, tok, row, 4 + 2 * h, kb);
    const float dl = DL[r * nh + h];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = ap[j] * ka[j], bv = bp[j] * kb[j];
      dwc[j] += (a * bv) * dl;
      const float dg = dl * w[j];
      za[j] = dg * bv * ka[j] * (1.f - ap[j] * ap[j]);
      zb[j] = dg * a * kb[j] * bp[j] * (1.f - bp[j]);
      dba[j] += za[j];
      dbb[j] += zb[j];
    }
    store4(DZG + r * nh * 2 * f + h * 2 * f + j0, za);
    store4(DZG + r * nh * 2 * f + h * 2 * f + f + j0, zb);
  }
  float* pt = part + blockIdx.x * ld_part;
  store4(pt + h * f + j0, dwc);
  store4(pt + nh * f + h * 2 * f + j0, dba);
  store4(pt + nh * f + h * 2 * f + f + j0, dbb);
}

// One LN / GELU / dropout layer adjoint. Block = 64-row tile, W/4 threads.
// din [M, W] (f32, or bf16 for a cotangent that arrives in the compute
// dtype) is the cotangent at the layer's output; U is u in T; writes DZ
// [M, W] in T (the pre-LN cotangent, operand of both gradient products) and
// part[tile, 0:W | W:2W | 2W:3W] = ds, dt, db column partials.
template <typename DT, typename T = bf16>
__global__ void layer_bwd(const DT* __restrict__ din, const T* __restrict__ U,
                          const float* __restrict__ rstd, const float* __restrict__ s,
                          const float* __restrict__ sh, T* __restrict__ DZ,
                          float* __restrict__ part, long long ld_part, int M, int W, int t,
                          int row_offset, int layer, Dropout d) {
  __shared__ float red[32];
  const int c = threadIdx.x * 4, nw = blockDim.x >> 5;
  float sv[4], tv[4], ds[4] = {0.f, 0.f, 0.f, 0.f}, dt[4] = {0.f, 0.f, 0.f, 0.f},
                      db[4] = {0.f, 0.f, 0.f, 0.f};
  load4(s + c, sv);
  load4(sh + c, tv);
  const long long r0 = (long long)blockIdx.x * ROW_TILE;
  for (int i = 0; i < ROW_TILE; ++i) {
    const long long r = r0 + i;
    if (r >= M) break;  // uniform over the block
    float dv[4], u[4], k[4], du[4];
    load4(din + r * W + c, dv);
    load4(U + r * W + c, u);
    keep4(d, threadIdx.x, (int)(r % t), (int)(r / t) + row_offset, layer, k);
    float sdu = 0.f, sduu = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = u[j] * sv[j] + tv[j];
      dv[j] = dv[j] * k[j] * (gauss_cdf(v) + v * gauss_pdf(v));
      ds[j] += dv[j] * u[j];
      dt[j] += dv[j];
      du[j] = dv[j] * sv[j];
      sdu += du[j];
      sduu += du[j] * u[j];
    }
    const float mdu = group_sum(sdu, red, 0, nw) / W;
    const float mduu = group_sum(sduu, red, 0, nw) / W;
    const float rs = rstd[r * 3 + layer];
    float dz[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dz[j] = (du[j] - mdu - u[j] * mduu) * rs;
      db[j] += dz[j];
    }
    store4(DZ + r * W + c, dz);
  }
  float* pt = part + blockIdx.x * ld_part;
  store4(pt + c, ds);
  store4(pt + W + c, dt);
  store4(pt + 2 * W + c, db);
}

// Column partials of a [M, N] matrix over 64-row tiles, N/4 threads.
template <typename T>
__global__ void colsum_rows(const T* __restrict__ X, float* __restrict__ part,
                            long long ld_part, int M, int N) {
  const int c = threadIdx.x * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const long long r0 = (long long)blockIdx.x * ROW_TILE;
  for (int i = 0; i < ROW_TILE && r0 + i < M; ++i) {
    float v[4];
    load4(X + (r0 + i) * N + c, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += v[j];
  }
  store4(part + blockIdx.x * ld_part + c, acc);
}

inline int row_tiles(int M) { return (M + ROW_TILE - 1) / ROW_TILE; }

// The GEMM behind the launch sequences below, chosen at each call site:
// every bf16 kernel on a path (K6, K7 and the per-op kernels 15-20) runs its
// products on the TMA + wgmma GEMM of gemm_wgmma.cuh; the first designs of
// 15-18 and 20, kept as checks, on the mma.sync GEMM of gemm_bf16.cuh; K6
// and K7 with f32 operands on the split-TF32 wgmma GEMM of gemm_tf32.cuh;
// kernels 15-18 with f32 operands on the FFMA tiles of gemm_ffma.cuh
// (operands of type T: bf16 for the first two, float for TF32 and FFMA).
// TF32 takes its weight operands pre-split (t32::split_weights): linear_f32's
// W as stored, dgrad's B transposed; the other arguments stay as the other
// engines read them, dgrad's ldb and strideB describing the weights as
// stored (TF32 ignores them).
enum class Gemm { MMA_SYNC, WGMMA, FFMA, TF32 };

// Weight gradient [Mo, No] = sum over tokens of A(tok, m) B(tok, n), both
// row-major token-by-column operands (lda, ldb), batched over `batches`
// (batch z's columns start at z strideA, z strideB).
template <Gemm G, typename T>
inline cudaError_t wgrad(const T* A, long long lda, long long strideA, const T* B,
                         long long ldb, long long strideB, int Mo, int No, int tokens,
                         int batches, float* out, float* work, cudaStream_t st) {
  if constexpr (G == Gemm::FFMA) {
    return ff::wgrad(A, lda, strideA, B, ldb, strideB, Mo, No, tokens, batches, out, work, st);
  } else if constexpr (G == Gemm::TF32) {
    return t32::wgrad(A, lda, strideA, B, ldb, strideB, Mo, No, tokens, batches, out, work, st);
  } else if constexpr (G == Gemm::WGMMA) {
    const WgOperand a{A, lda, tokens, strideA * (batches - 1) + Mo, (int)strideA, 0};
    const WgOperand b{B, ldb, tokens, strideB * (batches - 1) + No, (int)strideB, 0};
    return wg_wgrad(a, b, Mo, No, tokens, batches, out, work, st);
  } else {
    GemmArgs g{};
    g.A = A; g.lda = lda; g.strideA = strideA;
    g.B = B; g.ldb = ldb; g.strideB = strideB;
    g.M = Mo; g.N = No; g.K = tokens;
    return launch_wgrad(g, batches, out, work, st);
  }
}

// Floats of split-K workspace `wgrad<G>` needs for these shapes.
template <Gemm G>
inline long long wgrad_work(int Mo, int No, int tokens, int batches) {
  if constexpr (G == Gemm::FFMA)
    return ff::wgrad_work_floats(Mo, No, tokens, batches);
  else if constexpr (G == Gemm::TF32)
    return t32::wgrad_work_floats(Mo, No, tokens, batches);
  else if constexpr (G == Gemm::WGMMA)
    return wg_wgrad_work_floats(Mo, No, tokens, batches);
  else
    return wgrad_work_floats(Mo, No, tokens, batches);
}

// Input gradient C [tokens, N] (+)= A [tokens, K] . B [K, N], batched (batch
// z's A columns start at z strideA, its B at B + z strideB, a whole number of
// B's rows, its C columns at z strideC); f32 C (beta 1 accumulates), or bf16
// C (no accumulation; FFMA and TF32: f32 C only; TF32: B pre-split
// transposed, [batches N, K] hi then lo).
template <Gemm G, typename OutT = float, typename T>
inline cudaError_t dgrad(const T* A, long long lda, long long strideA, const T* B,
                         long long ldb, long long strideB, OutT* C, long long ldc,
                         long long strideC, int tokens, int N, int K, int batches, int beta,
                         cudaStream_t st) {
  if constexpr (G == Gemm::FFMA) {
    return ff::dgrad(A, lda, strideA, B, ldb, strideB, C, ldc, strideC, tokens, N, K, batches,
                     beta, st);
  } else if constexpr (G == Gemm::TF32) {
    return t32::dgrad(A, lda, strideA, B, C, ldc, strideC, tokens, N, K, batches, beta, st);
  } else if constexpr (G == Gemm::WGMMA) {
    if (strideB % ldb) return cudaErrorInvalidValue;
    const int brows = (int)(strideB / ldb);
    const WgOperand a{A, lda, tokens, strideA * (batches - 1) + K, 0, (int)strideA};
    const WgOperand b{B, ldb, (long long)brows * (batches - 1) + K, N, 0, brows};
    wg::Params p = wg_params(C, ldc, nullptr, tokens, N, K);
    p.strideC = strideC;
    p.batches = batches;
    p.beta = beta;
    constexpr int epi = sizeof(OutT) == 4 ? wg::EPI_F32 : wg::EPI_BF16;
    return wg_gemm<false, true, epi>(a, b, p, st);
  } else {
    GemmArgs g{};
    g.A = A; g.lda = lda; g.strideA = strideA;
    g.B = B; g.ldb = ldb; g.strideB = strideB;
    g.C = C; g.ldc = ldc; g.strideC = strideC;
    g.M = tokens; g.N = N; g.K = K;
    g.splits = 1;
    g.beta = beta;
    return launch_gemm<true, false, OutT>(g, batches, st);
  }
}

// Z [M, N] f32 = X [M, K] W [N, K]^T + bias [N] (TF32: W pre-split as stored).
template <Gemm G, typename T>
inline cudaError_t linear_f32(const T* X, const T* W, const float* bias, float* Z, int M,
                              int N, int K, cudaStream_t st) {
  if constexpr (G == Gemm::FFMA) {
    return ff::linear(X, W, bias, Z, M, N, K, st);
  } else if constexpr (G == Gemm::TF32) {
    return t32::linear(X, W, bias, Z, M, N, K, st);
  } else if constexpr (G == Gemm::WGMMA) {
    const WgOperand a{X, K, M, K, 0, 0}, b{W, K, N, K, 0, 0};
    return wg_gemm<false, false, wg::EPI_F32>(a, b, wg_params(Z, N, bias, M, N, K), st);
  } else {
    GemmArgs g{};
    g.A = X; g.lda = K;
    g.B = W; g.ldb = K;
    g.C = Z; g.ldc = N;
    g.bias = bias;
    g.M = M; g.N = N; g.K = K;
    g.splits = 1;
    return launch_gemm<true, true, float>(g, 1, st);
  }
}

// The three pre-attention layers, Linear -> LayerNorm -> GELU -> dropout
// (ops/preattn.py::_layer_fwd three times): Z = A W^T + bias, then the row
// kernel. H[0], H[1] (the inputs of layers 2 and 3, in T) must be set;
// U[i], rstd and H[2] may be null. With y32, layer 3 also leaves its f32
// output in Z.
template <typename T>
struct StackFwdT {
  const T* x;
  const T* w[3];
  const float *b[3], *s[3], *sh[3];
  float* Z;       // [M, max(hd, E)] f32 scratch
  T* U[3];
  float* rstd;    // [M, 3]
  T* H[3];
  int M, t, d_in, hd, E, row_offset, y32;
  Dropout d;
};
using StackFwd = StackFwdT<bf16>;

template <Gemm G, typename T>
inline cudaError_t stack_fwd(const StackFwdT<T>& a, cudaStream_t st) {
  const T* Ain[3] = {a.x, a.H[0], a.H[1]};
  const int Kl[3] = {a.d_in, a.hd, a.hd}, Nl[3] = {a.hd, a.hd, a.E};
  for (int i = 0; i < 3; ++i) {
    TRAIN_CHECK(linear_f32<G>(Ain[i], a.w[i], a.b[i], a.Z, a.M, Nl[i], Kl[i], st));
    ln_gelu_fwd<T><<<a.M, Nl[i] / 4, 0, st>>>(a.Z, a.s[i], a.sh[i], a.U[i], a.rstd, a.H[i],
                                               Nl[i], a.t, a.row_offset, i, a.d,
                                               i == 2 && a.y32);
    TRAIN_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

// The adjoint of the three layers (ops/preattn.py::_layer_bwd three times)
// from the cotangent din3 [M, E] at layer 3's output: the weight, bias and
// LN gradients in f32 and, where dx is set, the input gradient dx [M, d_in]
// in T. Reads the layer inputs x, h1, h2 and each layer's u and rstd.
template <typename T>
struct StackBwdT {
  const T *x, *h1, *h2;
  const T *u[3];
  const float* rstd;
  const T *w1, *w2, *w3;
  const float *s[3], *sh[3];
  float *dw[3], *db[3], *ds[3], *dt[3];
  T* DZ3;         // [M, E] scratch
  T* DZ12;        // [M, hd] scratch
  float* DH;      // [M, hd] scratch
  float* work;    // split-K partials
  float* part;    // column partials, row stride ldp >= 3 * max(hd, E)
  long long ldp;
  T* dx;          // null: no input gradient
  int M, t, d_in, hd, E, row_offset;
  Dropout d;
};
using StackBwd = StackBwdT<bf16>;

// Floats of split-K workspace stack_bwd<G> needs.
template <Gemm G>
inline long long stack_bwd_work(int M, int d_in, int hd, int E) {
  long long w = wgrad_work<G>(E, hd, M, 1);
  const long long cand[2] = {wgrad_work<G>(hd, hd, M, 1), wgrad_work<G>(hd, d_in, M, 1)};
  for (long long c : cand) w = c > w ? c : w;
  return w;
}

// One layer: the row adjoint, its three column sums, and the weight
// gradient against the layer's input hin.
template <Gemm G, typename DT, typename T>
inline cudaError_t layer_adjoint(const StackBwdT<T>& a, int i, const DT* din, int W, T* DZ,
                                 const T* hin, int K, cudaStream_t st) {
  const int ntr = row_tiles(a.M);
  layer_bwd<DT, T><<<ntr, W / 4, 0, st>>>(din, a.u[i], a.rstd, a.s[i], a.sh[i], DZ, a.part,
                                          a.ldp, a.M, W, a.t, a.row_offset, i, a.d);
  TRAIN_CHECK(cudaGetLastError());
  TRAIN_CHECK(colsum_reduce(a.part, a.ldp, 0, W, ntr, a.ds[i], st));
  TRAIN_CHECK(colsum_reduce(a.part, a.ldp, W, W, ntr, a.dt[i], st));
  TRAIN_CHECK(colsum_reduce(a.part, a.ldp, 2 * W, W, ntr, a.db[i], st));
  return wgrad<G>(DZ, W, 0, hin, K, 0, W, K, a.M, 1, a.dw[i], a.work, st);
}

template <Gemm G, typename DT, typename T>
inline cudaError_t stack_bwd(const StackBwdT<T>& a, const DT* din3, cudaStream_t st) {
  // layer 3
  TRAIN_CHECK(layer_adjoint<G>(a, 2, din3, a.E, a.DZ3, a.h2, a.hd, st));
  TRAIN_CHECK(dgrad<G>(a.DZ3, a.E, 0, a.w3, a.hd, 0, a.DH, a.hd, 0, a.M, a.hd, a.E, 1, 0, st));
  // layer 2
  TRAIN_CHECK(layer_adjoint<G>(a, 1, (const float*)a.DH, a.hd, a.DZ12, a.h1, a.hd, st));
  TRAIN_CHECK(dgrad<G>(a.DZ12, a.hd, 0, a.w2, a.hd, 0, a.DH, a.hd, 0, a.M, a.hd, a.hd, 1, 0,
                       st));
  // layer 1, and its input gradient only when the caller asks for it
  TRAIN_CHECK(layer_adjoint<G>(a, 0, (const float*)a.DH, a.hd, a.DZ12, a.x, a.d_in, st));
  if (a.dx)
    TRAIN_CHECK((dgrad<G, T>(a.DZ12, a.hd, 0, a.w1, a.d_in, 0, a.dx, a.d_in, 0, a.M, a.d_in,
                             a.hd, 1, 0, st)));
  return cudaSuccess;
}

// Gate products of every head in one batched launch (the first designs of
// the per-op kernels 17 and 18, kept as checks; K6 and kernel 17 fuse the
// logits into their gate product, kernel 18 the gate adjoint into its
// recompute):
// G_h = act(y_h Wab_h^T + bab_h), tanh on the first f columns, sigmoid on
// the next f. Y [M, nh*e] bf16, wab [nh, 2f, e] bf16, bab [nh, 2f] f32,
// G [M, nh*2f] f32.
inline cudaError_t gate_products(const bf16* Y, const bf16* wab, const float* bab, float* G,
                                 int M, int nh, int e, int f, cudaStream_t st) {
  GemmArgs g{};
  g.A = Y; g.lda = (long long)nh * e; g.strideA = e;
  g.B = wab; g.ldb = e; g.strideB = 2LL * f * e;
  g.C = G; g.ldc = 2LL * nh * f; g.strideC = 2LL * f;
  g.bias = bab; g.strideBias = 2LL * f;
  g.M = M; g.N = 2 * f; g.K = e;
  g.splits = 1;
  g.act = ACT_GATES; g.act_split = f;
  return launch_gemm<true, true, float>(g, nh, st);
}

// The token projector's parameter gradients: dWt = dtok^T Y, dbt = column
// sums of dtok (per-tile partials with row stride ldp >= dout).
template <Gemm G, typename T>
inline cudaError_t tok_wgrad(const T* dtok, const T* Y, float* dwt, float* dbt,
                             float* work, float* part, long long ldp, int M, int E, int dout,
                             cudaStream_t st) {
  TRAIN_CHECK(wgrad<G>(dtok, dout, 0, Y, E, 0, dout, E, M, 1, dwt, work, st));
  const int ntr = row_tiles(M);
  colsum_rows<T><<<ntr, dout / 4, 0, st>>>(dtok, part, ldp, M, dout);
  TRAIN_CHECK(cudaGetLastError());
  return colsum_reduce(part, ldp, 0, dout, ntr, dbt, st);
}

}  // namespace madeleine
