// Row kernels and launch sequences shared by the train kernels: the
// whole-encoder forward and backward (K6, K7) and the per-op lane's
// pre-attention MLP (kernels 15, 16), gate logits (17, 18) and token
// projector (19, 20). Each is the device code of one piece of the model;
// K6/K7 chain all of them, the per-op kernels one each.
//
// Row kernels put one 4-column group of a row on each thread; the backward
// ones loop over 64-row tiles (ROW_TILE) and write per-tile column partials
// that colsum_reduce sums in tile order. Nothing uses atomics: two launches
// on the same inputs give bitwise-equal results.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"
#include "train_common.cuh"

#define TRAIN_CHECK(x)                         \
  do {                                         \
    cudaError_t err_ = (x);                    \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

namespace madeleine {

// One row per block, W/4 threads, 4 columns each: LayerNorm + GELU + dropout.
// Z [M, W] f32 pre-LN rows (bias included). Writes rstd[r * 3 + layer] and,
// where the pointer is set, U (bf16 u) and H (bf16 output); with y32 also
// the f32 output back into Z.
__global__ void ln_gelu_fwd(float* __restrict__ Z, const float* __restrict__ s,
                            const float* __restrict__ sh, bf16* __restrict__ U,
                            float* __restrict__ rstd, bf16* __restrict__ H, int W, int t,
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
  if (threadIdx.x == 0) rstd[r * 3 + layer] = rs;
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

// Gate adjoint. Block = 64-row tile, nh*f/4 threads. The pre-dropout gate
// activations of row r, head h are AP / BP + r * ldg + h * hs (bf16 saved
// residuals, or the f32 recomputed products). Writes DZG [M, nh*2f] bf16
// (per head [dza | dzb]) and per-tile column partials
// part[tile, 0 : nh*f] = dwc, part[tile, nh*f + h*2f + j] = dba / dbb.
template <typename GT>
__global__ void gate_bwd(const GT* __restrict__ AP, const GT* __restrict__ BP, long long ldg,
                         int hs, const float* __restrict__ DL, const float* __restrict__ wc,
                         bf16* __restrict__ DZG, float* __restrict__ part, long long ld_part,
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
// dtype) is the cotangent at the layer's output; writes DZ [M, W] bf16 (the
// pre-LN cotangent, operand of both gradient products) and
// part[tile, 0:W | W:2W | 2W:3W] = ds, dt, db column partials.
template <typename DT>
__global__ void layer_bwd(const DT* __restrict__ din, const bf16* __restrict__ U,
                          const float* __restrict__ rstd, const float* __restrict__ s,
                          const float* __restrict__ sh, bf16* __restrict__ DZ,
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

// Column partials of a bf16 [M, N] matrix over 64-row tiles, N/4 threads.
__global__ void colsum_rows(const bf16* __restrict__ X, float* __restrict__ part,
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

// Weight gradient [Mo, No] = sum over tokens of A(tok, m) B(tok, n), both
// row-major token-by-column operands (lda, ldb), batched over `batches`.
inline cudaError_t wgrad(const bf16* A, long long lda, long long strideA, const bf16* B,
                         long long ldb, long long strideB, int Mo, int No, int tokens,
                         int batches, float* out, float* work, cudaStream_t st) {
  GemmArgs g{};
  g.A = A; g.lda = lda; g.strideA = strideA;
  g.B = B; g.ldb = ldb; g.strideB = strideB;
  g.M = Mo; g.N = No; g.K = tokens;
  return launch_wgrad(g, batches, out, work, st);
}

// Input gradient C [tokens, N] (+)= A [tokens, K] . B [K, N], batched; f32
// C (beta 1 accumulates), or bf16 C (no accumulation).
template <typename OutT = float>
inline cudaError_t dgrad(const bf16* A, long long lda, long long strideA, const bf16* B,
                         long long ldb, long long strideB, OutT* C, long long ldc,
                         long long strideC, int tokens, int N, int K, int batches, int beta,
                         cudaStream_t st) {
  GemmArgs g{};
  g.A = A; g.lda = lda; g.strideA = strideA;
  g.B = B; g.ldb = ldb; g.strideB = strideB;
  g.C = C; g.ldc = ldc; g.strideC = strideC;
  g.M = tokens; g.N = N; g.K = K;
  g.splits = 1;
  g.beta = beta;
  return launch_gemm<true, false, OutT>(g, batches, st);
}

// The three pre-attention layers, Linear -> LayerNorm -> GELU -> dropout
// (ops/preattn.py::_layer_fwd three times): Z = A W^T + bias, then the row
// kernel. H[0], H[1] (the bf16 inputs of layers 2 and 3) must be set; U[i]
// and H[2] may be null. With y32, layer 3 also leaves its f32 output in Z.
struct StackFwd {
  const bf16* x;
  const bf16* w[3];
  const float *b[3], *s[3], *sh[3];
  float* Z;       // [M, max(hd, E)] f32 scratch
  bf16* U[3];
  float* rstd;    // [M, 3]
  bf16* H[3];
  int M, t, d_in, hd, E, row_offset, y32;
  Dropout d;
};

inline cudaError_t stack_fwd(const StackFwd& a, cudaStream_t st) {
  const bf16* Ain[3] = {a.x, a.H[0], a.H[1]};
  const int Kl[3] = {a.d_in, a.hd, a.hd}, Nl[3] = {a.hd, a.hd, a.E};
  for (int i = 0; i < 3; ++i) {
    GemmArgs g{};
    g.A = Ain[i]; g.lda = Kl[i];
    g.B = a.w[i]; g.ldb = Kl[i];
    g.C = a.Z; g.ldc = Nl[i];
    g.bias = a.b[i];
    g.M = a.M; g.N = Nl[i]; g.K = Kl[i];
    g.splits = 1;
    TRAIN_CHECK((launch_gemm<true, true, float>(g, 1, st)));
    ln_gelu_fwd<<<a.M, Nl[i] / 4, 0, st>>>(a.Z, a.s[i], a.sh[i], a.U[i], a.rstd, a.H[i],
                                            Nl[i], a.t, a.row_offset, i, a.d,
                                            i == 2 && a.y32);
    TRAIN_CHECK(cudaGetLastError());
  }
  return cudaSuccess;
}

// The adjoint of the three layers (ops/preattn.py::_layer_bwd three times)
// from the cotangent din3 [M, E] at layer 3's output: the weight, bias and
// LN gradients in f32 and, where dx is set, the input gradient dx [M, d_in]
// bf16. Reads the layer inputs x, h1, h2 and each layer's u and rstd.
struct StackBwd {
  const bf16 *x, *h1, *h2;
  const bf16 *u[3];
  const float* rstd;
  const bf16 *w1, *w2, *w3;
  const float *s[3], *sh[3];
  float *dw[3], *db[3], *ds[3], *dt[3];
  bf16* DZ3;      // [M, E] scratch
  bf16* DZ12;     // [M, hd] scratch
  float* DH;      // [M, hd] scratch
  float* work;    // split-K partials
  float* part;    // column partials, row stride ldp >= 3 * max(hd, E)
  long long ldp;
  bf16* dx;       // null: no input gradient
  int M, t, d_in, hd, E, row_offset;
  Dropout d;
};

// One layer: the row adjoint, its three column sums, and the weight
// gradient against the layer's input hin.
template <typename DT>
inline cudaError_t layer_adjoint(const StackBwd& a, int i, const DT* din, int W, bf16* DZ,
                                 const bf16* hin, int K, cudaStream_t st) {
  const int ntr = row_tiles(a.M);
  layer_bwd<DT><<<ntr, W / 4, 0, st>>>(din, a.u[i], a.rstd, a.s[i], a.sh[i], DZ, a.part, a.ldp,
                                       a.M, W, a.t, a.row_offset, i, a.d);
  TRAIN_CHECK(cudaGetLastError());
  TRAIN_CHECK(colsum_reduce(a.part, a.ldp, 0, W, ntr, a.ds[i], st));
  TRAIN_CHECK(colsum_reduce(a.part, a.ldp, W, W, ntr, a.dt[i], st));
  TRAIN_CHECK(colsum_reduce(a.part, a.ldp, 2 * W, W, ntr, a.db[i], st));
  return wgrad(DZ, W, 0, hin, K, 0, W, K, a.M, 1, a.dw[i], a.work, st);
}

template <typename DT>
inline cudaError_t stack_bwd(const StackBwd& a, const DT* din3, cudaStream_t st) {
  // layer 3
  TRAIN_CHECK(layer_adjoint(a, 2, din3, a.E, a.DZ3, a.h2, a.hd, st));
  TRAIN_CHECK(dgrad(a.DZ3, a.E, 0, a.w3, a.hd, 0, a.DH, a.hd, 0, a.M, a.hd, a.E, 1, 0, st));
  // layer 2
  TRAIN_CHECK(layer_adjoint(a, 1, (const float*)a.DH, a.hd, a.DZ12, a.h1, a.hd, st));
  TRAIN_CHECK(dgrad(a.DZ12, a.hd, 0, a.w2, a.hd, 0, a.DH, a.hd, 0, a.M, a.hd, a.hd, 1, 0, st));
  // layer 1, and its input gradient only when the caller asks for it
  TRAIN_CHECK(layer_adjoint(a, 0, (const float*)a.DH, a.hd, a.DZ12, a.x, a.d_in, st));
  if (a.dx)
    TRAIN_CHECK(dgrad<bf16>(a.DZ12, a.hd, 0, a.w1, a.d_in, 0, a.dx, a.d_in, 0, a.M, a.d_in,
                            a.hd, 1, 0, st));
  return cudaSuccess;
}

// Gate products of every head in one batched launch:
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

// Token projector: tok [M, dout] bf16 = Y [M, E] Wt^T + bt.
inline cudaError_t tok_product(const bf16* Y, const bf16* wt, const float* bt, bf16* tok, int M,
                               int E, int dout, cudaStream_t st) {
  GemmArgs g{};
  g.A = Y; g.lda = E;
  g.B = wt; g.ldb = E;
  g.C = tok; g.ldc = dout;
  g.bias = bt;
  g.M = M; g.N = dout; g.K = E;
  g.splits = 1;
  return launch_gemm<true, true, bf16>(g, 1, st);
}

// The token projector's parameter gradients: dWt = dtok^T Y, dbt = column
// sums of dtok (per-tile partials with row stride ldp >= dout).
inline cudaError_t tok_wgrad(const bf16* dtok, const bf16* Y, float* dwt, float* dbt,
                             float* work, float* part, long long ldp, int M, int E, int dout,
                             cudaStream_t st) {
  TRAIN_CHECK(wgrad(dtok, dout, 0, Y, E, 0, dout, E, M, 1, dwt, work, st));
  const int ntr = row_tiles(M);
  colsum_rows<<<ntr, dout / 4, 0, st>>>(dtok, part, ldp, M, dout);
  TRAIN_CHECK(cudaGetLastError());
  return colsum_reduce(part, ldp, 0, dout, ntr, dbt, st);
}

}  // namespace madeleine
