// Pre-attention MLP for training, bf16 or f32 operands: forward (kernel 15)
// and backward (kernel 16) of the per-op lane (the f32 entry points at the
// end of this file).
//
// Replaces madeleine_tpu/ops/preattn.py::_fwd_kernel and ::_bwd_kernel. Per
// token row of x [b*t, d_in]:
//   3 x [Linear -> LayerNorm (f32 statistics over the whole row) -> GELU
//        (exact erf) -> dropout]                                -> y [E] bf16
// with bf16 operands, f32 accumulation and f32 bias / LN / GELU, each
// layer's output rounded to bf16 before the next product. Dropout masks are
// Philox bits keyed by (seed, global row, token, layer 0..2, column), the
// keys of K6/K7, so a row's masks here equal the whole-encoder op's. The
// backward keeps the TPU op's residuals, (x, seed) and nothing else: it
// recomputes the stack (writing each layer's u, rstd and bf16 output), then
// runs the three layer adjoints from the cotangent dy [b*t, E] bf16 and
// emits the 12 weight, bias and LN gradients in f32 and, when the caller
// passes a dx buffer (x carries the learned stain-encoding columns), dx.
//
// What bounds it on an H100: 3.4 M multiply-adds per token forward at the
// published widths (512 -> 512 -> 512 -> 2048) and about 3x that backward
// (the recompute, a weight gradient for every product and an input
// gradient for layers 3 and 2, and 1 with dx), against 5 KB of traffic per
// token: the dense bf16 rate bounds both.
//
// Design (kernels 15 and 16, redesigned for Hopper): every product on the
// TMA + wgmma GEMM of gemm_wgmma.cuh, as K7's (about 210 TFLOP/s on the
// mma.sync GEMM, 340-440 on wgmma). The forward and the backward's recompute
// are one sequence (recompute): per layer Z = A W^T + bias in f32, then a
// warp-per-row LayerNorm / GELU / dropout kernel with 16-byte loads
// (ln_gelu_rows_train, after K1's ln_gelu_rows in encode_fused.cu) that
// writes only what its caller reads: the forward h1, h2 and layer 3's bf16
// output y; the backward's recompute u1-u3, rstd, h1, h2. The backward then
// runs K7's layer adjoints (train_rows.cuh::stack_bwd<Gemm::WGMMA>).
// Gradients of parameters are split-K partials and per-tile column partials
// summed in a fixed order: no atomics, launches are bitwise reproducible.
// The first designs (the same sequences on the mma.sync GEMM of
// gemm_bf16.cuh, with K6's row-per-block ln_gelu_fwd) stay as the
// check-only entry points preattn_forward_rowblock and
// preattn_backward_rowblock.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "train_rows.cuh"

namespace {

using madeleine::bf16;
using madeleine::Dropout;

struct Dims {
  int b, t, d_in, hd, E, M, row_offset;
  Dropout d;
};

// dims: b, t, d_in, hidden, E, seed, row_offset, thr (preattn_forward).
bool fits(const long long* dims) { return madeleine::rows_fit(dims[0], dims[1], dims[6]); }

Dims dims_of(const long long* dims, const float* scales) {
  Dims D;
  D.b = (int)dims[0]; D.t = (int)dims[1]; D.d_in = (int)dims[2]; D.hd = (int)dims[3];
  D.E = (int)dims[4];
  D.M = D.b * D.t;
  D.row_offset = (int)dims[6];
  D.d = Dropout{(uint32_t)dims[5], (uint32_t)dims[7], scales[0]};
  return D;
}

// The stack's operands from p[first]: w1, b1, s1, t1, w2, ..., t3.
template <typename T>
void stack_weights(madeleine::StackFwdT<T>& a, void** p, int first) {
  for (int i = 0; i < 3; ++i) {
    a.w[i] = (const T*)p[first + 4 * i];
    a.b[i] = (const float*)p[first + 4 * i + 1];
    a.s[i] = (const float*)p[first + 4 * i + 2];
    a.sh[i] = (const float*)p[first + 4 * i + 3];
  }
}

// The forward's pointers (the layout of preattn_forward's p), T the
// operands' type.
template <typename T>
void forward_args(void** p, const Dims& D, madeleine::StackFwdT<T>& a) {
  a = madeleine::StackFwdT<T>{};
  a.x = (const T*)p[0];
  stack_weights(a, p, 1);
  a.Z = (float*)p[14];
  a.rstd = (float*)p[15];
  a.H[0] = (T*)p[16]; a.H[1] = (T*)p[17]; a.H[2] = (T*)p[13];
  a.M = D.M; a.t = D.t; a.d_in = D.d_in; a.hd = D.hd; a.E = D.E;
  a.row_offset = D.row_offset;
  a.d = D.d;
}

// Warp-per-row LayerNorm + GELU + dropout of kernels 15 and 16: 8 rows per
// 256-thread block, lane l holding the 16-byte column groups v 32 + l
// (v < V) of its row of W = 128 V columns, the statistics by warp shuffles
// (mean, then the squared deviations from it, as ln_gelu_fwd). Z [M, W]
// f32 pre-LN rows (bias included); writes, where set, U (bf16 u),
// rstd[r 3 + layer] and H (the bf16 output).
template <int V>
__global__ void __launch_bounds__(256)
ln_gelu_rows_train(const float* __restrict__ Z, const float* __restrict__ s,
                   const float* __restrict__ sh, bf16* __restrict__ U, float* __restrict__ rstd,
                   bf16* __restrict__ H, int M, int t, int row_offset, int layer, Dropout d) {
  constexpr int W = 128 * V;
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= M) return;
  const int lane = threadIdx.x & 31;
  float z[V][4];
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    madeleine::load4(Z + r * W + (v * 32 + lane) * 4, z[v]);
    sum += (z[v][0] + z[v][1]) + (z[v][2] + z[v][3]);
  }
  const float mean = madeleine::warp_sum(sum) / W;
  float dev = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int j = 0; j < 4; ++j) dev += (z[v][j] - mean) * (z[v][j] - mean);
  const float rs = rsqrtf(madeleine::warp_sum(dev) / W + madeleine::TRAIN_LN_EPS);
  const int tok = (int)(r % t), row = (int)(r / t) + row_offset;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c4 = v * 32 + lane, c = c4 * 4;
    float sc[4], shv[4], k[4], u[4], h[4];
    madeleine::load4(s + c, sc);
    madeleine::load4(sh + c, shv);
    madeleine::keep4(d, c4, tok, row, layer, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u[j] = (z[v][j] - mean) * rs;
      const float x = u[j] * sc[j] + shv[j];
      h[j] = x * madeleine::gauss_cdf(x) * k[j];
    }
    if (U) madeleine::store4(U + r * W + c, u);
    if (H) madeleine::store4(H + r * W + c, h);
  }
  if (rstd && lane == 0) rstd[r * 3 + layer] = rs;
}

constexpr int MAX_V = 32;   // widths up to 4096 (ops/preattn.py::_check)

// ln_gelu_rows_train for W = 128 v (1 <= v <= MAX_V).
template <int V = 1>
cudaError_t launch_ln_rows(int v, const float* Z, const float* s, const float* sh, bf16* U,
                           float* rstd, bf16* H, int M, int t, int row_offset, int layer,
                           Dropout d, cudaStream_t st) {
  if (v == V) {
    ln_gelu_rows_train<V><<<(M + 7) / 8, 256, 0, st>>>(Z, s, sh, U, rstd, H, M, t, row_offset,
                                                        layer, d);
    return cudaGetLastError();
  }
  if constexpr (V < MAX_V)
    return launch_ln_rows<V + 1>(v, Z, s, sh, U, rstd, H, M, t, row_offset, layer, d, st);
  else
    return cudaErrorInvalidValue;
}

// The three layers of kernel 15 and of kernel 16's recompute: each product
// on the wgmma GEMM into Z, then its row kernel. H[0], H[1] must be set;
// writes them and, where set, U[0..2], rstd and H[2] (layer 3's output).
cudaError_t recompute(const madeleine::StackFwd& a, cudaStream_t st) {
  const bf16* Ain[3] = {a.x, a.H[0], a.H[1]};
  const int Kl[3] = {a.d_in, a.hd, a.hd}, Nl[3] = {a.hd, a.hd, a.E};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = madeleine::linear_f32<madeleine::Gemm::WGMMA>(Ain[i], a.w[i], a.b[i], a.Z,
                                                                    a.M, Nl[i], Kl[i], st);
    if (err == cudaSuccess)
      err = launch_ln_rows(Nl[i] / 128, a.Z, a.s[i], a.sh[i], a.U[i], a.rstd, a.H[i], a.M, a.t,
                           a.row_offset, i, a.d, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Floats of workspace a backward on the GEMM G needs: [split-K partials,
// column partials].
template <madeleine::Gemm G>
void workspace(const long long* dims, long long* out) {
  out[0] = out[1] = 0;   // a call past the row limits is refused: it needs none
  if (!fits(dims)) return;
  const float one = 1.f;
  const Dims D = dims_of(dims, &one);
  out[0] = madeleine::stack_bwd_work<G>(D.M, D.d_in, D.hd, D.E);
  out[1] = (long long)madeleine::row_tiles(D.M) * 3 * (D.E > D.hd ? D.E : D.hd);
}

// The backward's pointers (the layout of preattn_backward's p): the
// recompute's StackFwdT and the adjoint's StackBwdT, T the operands' type.
template <typename T>
void backward_args(void** p, const Dims& D, madeleine::StackFwdT<T>& f,
                   madeleine::StackBwdT<T>& a) {
  f = madeleine::StackFwdT<T>{};
  f.x = (const T*)p[0];
  stack_weights(f, p, 2);
  f.Z = (float*)p[26];
  f.U[0] = (T*)p[27]; f.U[1] = (T*)p[28]; f.U[2] = (T*)p[29];
  f.rstd = (float*)p[30];
  f.H[0] = (T*)p[31]; f.H[1] = (T*)p[32]; f.H[2] = nullptr;
  f.M = D.M; f.t = D.t; f.d_in = D.d_in; f.hd = D.hd; f.E = D.E;
  f.row_offset = D.row_offset;
  f.d = D.d;
  a = madeleine::StackBwdT<T>{};
  a.x = f.x; a.h1 = f.H[0]; a.h2 = f.H[1];
  a.u[0] = f.U[0]; a.u[1] = f.U[1]; a.u[2] = f.U[2];
  a.rstd = f.rstd;
  a.w1 = f.w[0]; a.w2 = f.w[1]; a.w3 = f.w[2];
  for (int i = 0; i < 3; ++i) {
    a.s[i] = f.s[i];
    a.sh[i] = f.sh[i];
    a.dw[i] = (float*)p[14 + 4 * i];
    a.db[i] = (float*)p[15 + 4 * i];
    a.ds[i] = (float*)p[16 + 4 * i];
    a.dt[i] = (float*)p[17 + 4 * i];
  }
  a.DZ3 = (T*)p[33];
  a.DH = (float*)p[34];
  a.DZ12 = (T*)p[35];
  a.work = (float*)p[36];
  a.part = (float*)p[37];
  a.ldp = 3LL * (D.E > D.hd ? D.E : D.hd);
  a.dx = (T*)p[38];
  a.M = D.M; a.t = D.t; a.d_in = D.d_in; a.hd = D.hd; a.E = D.E;
  a.row_offset = D.row_offset;
  a.d = D.d;
}

}  // namespace

// dims: b, t, d_in, hidden, E, seed, row_offset, thr. scales: the keep
// scale. p: x, w1, b1, s1, t1, w2, b2, s2, t2, w3, b3, s3, t3, y [M, E] bf16,
// then scratch Z [M, max(hidden, E)] f32, rstd [M, 3] f32 or null, H1, H2
// [M, hidden] bf16. Returns a cudaError_t (cudaErrorInvalidValue where the
// wgmma GEMM refuses an operand).
extern "C" int preattn_forward(void** p, const long long* dims, const float* scales,
                               void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  madeleine::StackFwd a;
  forward_args(p, dims_of(dims, scales), a);
  return (int)recompute(a, static_cast<cudaStream_t>(stream_));
}

// The first design of the forward, kept as a check (no path calls it): the
// same layers on the mma.sync GEMM with K6's row kernel. p as
// preattn_forward's, rstd set.
extern "C" int preattn_forward_rowblock(void** p, const long long* dims, const float* scales,
                                        void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  madeleine::StackFwd a;
  forward_args(p, dims_of(dims, scales), a);
  return (int)madeleine::stack_fwd<madeleine::Gemm::MMA_SYNC>(a, st);
}

// Floats of workspace the backward needs: [split-K partials, column partials].
extern "C" void preattn_bwd_workspace(const long long* dims, long long* out) {
  workspace<madeleine::Gemm::WGMMA>(dims, out);
}

// dims as preattn_forward. p: x, dy [M, E] bf16, w1, b1, s1, t1, w2, ..., t3,
// the gradients dw1, db1, ds1, dt1, dw2, ..., dt3 (f32), then scratch Z,
// U1, U2 [M, hidden] bf16, U3 [M, E] bf16, rstd, H1, H2, DZ3 [M, E] bf16,
// DH [M, hidden] f32, DZ12 [M, hidden] bf16, the two workspaces of
// preattn_bwd_workspace, and dx [M, d_in] bf16 or null. Returns a cudaError_t
// (cudaErrorInvalidValue where the wgmma GEMM refuses an operand).
extern "C" int preattn_backward(void** p, const long long* dims, const float* scales,
                                void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  madeleine::StackFwd f;
  madeleine::StackBwd a;
  backward_args(p, D, f, a);
  cudaError_t err = recompute(f, st);
  if (err != cudaSuccess) return (int)err;
  return (int)madeleine::stack_bwd<madeleine::Gemm::WGMMA>(a, (const bf16*)p[1], st);
}

// The first design of the backward, kept as a check (no path calls it):
// the same sequence on the mma.sync GEMM with K6's row kernel.
extern "C" void preattn_bwd_rowblock_workspace(const long long* dims, long long* out) {
  workspace<madeleine::Gemm::MMA_SYNC>(dims, out);
}

// As preattn_backward, the workspaces of preattn_bwd_rowblock_workspace.
extern "C" int preattn_backward_rowblock(void** p, const long long* dims, const float* scales,
                                         void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  madeleine::StackFwd f;
  madeleine::StackBwd a;
  backward_args(p, D, f, a);
  cudaError_t err = madeleine::stack_fwd<madeleine::Gemm::MMA_SYNC>(f, st);
  if (err != cudaSuccess) return (int)err;
  return (int)madeleine::stack_bwd<madeleine::Gemm::MMA_SYNC>(a, (const bf16*)p[1], st);
}

// ---------------------------------------------------------------------------
// f32 operands (--precision float32 on the per-op lane): the JAX package runs
// both TPU kernels at f32 with Precision.HIGHEST. The same sequences with
// every operand, activation, residual, cotangent and output in f32, nothing
// rounded between layers, every product on gemm_ffma.cuh's FFMA tiles
// (Gemm::FFMA: each output's k in order with fmaf, the weight gradients'
// token sums in pieces of at least 1024 tokens added in piece order) and
// the rows on K6 f32's row kernel (train_rows.cuh::ln_gelu_fwd<float>, one
// row per block, the statistics by group_sum), so the per-op chain repeats
// K6/K7 f32's row arithmetic (their products now run on split-TF32 wgmma,
// gemm_tf32.cuh). What bounds it on an H100: the same multiply-adds
// as the bf16 route against the 67 TFLOP/s of f32 FMA.
// ---------------------------------------------------------------------------

// p as preattn_forward's with x, w1, w2, w3, y, H1 and H2 in f32 (rstd null).
extern "C" int preattn_forward_f32(void** p, const long long* dims, const float* scales,
                                   void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  madeleine::StackFwdT<float> a;
  forward_args(p, dims_of(dims, scales), a);
  return (int)madeleine::stack_fwd<madeleine::Gemm::FFMA>(a, static_cast<cudaStream_t>(stream_));
}

extern "C" void preattn_bwd_workspace_f32(const long long* dims, long long* out) {
  workspace<madeleine::Gemm::FFMA>(dims, out);
}

// p as preattn_backward's with x, dy, the weight matrices, U1-U3, H1, H2, DZ3,
// DZ12 and dx in f32; the workspaces of preattn_bwd_workspace_f32. DZ3 may
// be Z's memory: the recompute is done with Z before the adjoint writes DZ3.
extern "C" int preattn_backward_f32(void** p, const long long* dims, const float* scales,
                                    void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  madeleine::StackFwdT<float> f;
  madeleine::StackBwdT<float> a;
  backward_args(p, dims_of(dims, scales), f, a);
  cudaError_t err = madeleine::stack_fwd<madeleine::Gemm::FFMA>(f, st);
  if (err != cudaSuccess) return (int)err;
  return (int)madeleine::stack_bwd<madeleine::Gemm::FFMA>(a, (const float*)p[1], st);
}
