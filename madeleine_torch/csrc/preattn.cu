// Pre-attention MLP for training in bf16: forward (kernel 15) and backward
// (kernel 16) of the per-op lane.
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
// Design (simple first): K6's layer stack and K7's layer adjoints
// (train_rows.cuh): the mma.sync GEMM of gemm_bf16.cuh writes each pre-LN
// product to an f32 scratch row block; a row kernel takes LayerNorm's
// statistics over the whole row (2048 columns for layer 3) and applies GELU
// and dropout. Gradients of parameters are split-K partials and per-tile
// column partials summed in a fixed order: no atomics, launches are
// bitwise reproducible.

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
void stack_weights(madeleine::StackFwd& a, void** p, int first) {
  for (int i = 0; i < 3; ++i) {
    a.w[i] = (const bf16*)p[first + 4 * i];
    a.b[i] = (const float*)p[first + 4 * i + 1];
    a.s[i] = (const float*)p[first + 4 * i + 2];
    a.sh[i] = (const float*)p[first + 4 * i + 3];
  }
}

}  // namespace

// dims: b, t, d_in, hidden, E, seed, row_offset, thr. scales: the keep
// scale. p: x, w1, b1, s1, t1, w2, b2, s2, t2, w3, b3, s3, t3, y [M, E] bf16,
// then scratch Z [M, max(hidden, E)] f32, rstd [M, 3] f32, H1, H2 [M, hidden]
// bf16. Returns a cudaError_t.
extern "C" int preattn_forward(void** p, const long long* dims, const float* scales,
                               void* stream_) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  madeleine::StackFwd a{};
  a.x = (const bf16*)p[0];
  stack_weights(a, p, 1);
  a.Z = (float*)p[14];
  a.rstd = (float*)p[15];
  a.H[0] = (bf16*)p[16]; a.H[1] = (bf16*)p[17]; a.H[2] = (bf16*)p[13];
  a.M = D.M; a.t = D.t; a.d_in = D.d_in; a.hd = D.hd; a.E = D.E;
  a.row_offset = D.row_offset;
  a.d = D.d;
  return (int)madeleine::stack_fwd<madeleine::Gemm::MMA_SYNC>(a, st);
}

// Floats of workspace the backward needs: [split-K partials, column partials].
extern "C" void preattn_bwd_workspace(const long long* dims, long long* out) {
  const float one = 1.f;
  const Dims D = dims_of(dims, &one);
  long long w = madeleine::wgrad_work_floats(D.E, D.hd, D.M, 1);
  const long long cand[2] = {madeleine::wgrad_work_floats(D.hd, D.hd, D.M, 1),
                             madeleine::wgrad_work_floats(D.hd, D.d_in, D.M, 1)};
  for (long long c : cand) w = c > w ? c : w;
  out[0] = w;
  out[1] = (long long)madeleine::row_tiles(D.M) * 3 * (D.E > D.hd ? D.E : D.hd);
}

// dims as preattn_forward. p: x, dy [M, E] bf16, w1, b1, s1, t1, w2, ..., t3,
// the gradients dw1, db1, ds1, dt1, dw2, ..., dt3 (f32), then scratch Z,
// U1, U2 [M, hidden] bf16, U3 [M, E] bf16, rstd, H1, H2, DZ3 [M, E] bf16,
// DH [M, hidden] f32, DZ12 [M, hidden] bf16, the two workspaces of
// preattn_bwd_workspace, and dx [M, d_in] bf16 or null. Returns a cudaError_t.
extern "C" int preattn_backward(void** p, const long long* dims, const float* scales,
                                void* stream_) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  const bf16* dy = (const bf16*)p[1];
  bf16 *U1 = (bf16*)p[27], *U2 = (bf16*)p[28], *U3 = (bf16*)p[29];
  float* rstd = (float*)p[30];
  bf16 *H1 = (bf16*)p[31], *H2 = (bf16*)p[32];
  // recompute the stack: every layer's u and rstd, the layer inputs h1, h2
  madeleine::StackFwd f{};
  f.x = (const bf16*)p[0];
  stack_weights(f, p, 2);
  f.Z = (float*)p[26];
  f.U[0] = U1; f.U[1] = U2; f.U[2] = U3;
  f.rstd = rstd;
  f.H[0] = H1; f.H[1] = H2; f.H[2] = nullptr;
  f.M = D.M; f.t = D.t; f.d_in = D.d_in; f.hd = D.hd; f.E = D.E;
  f.row_offset = D.row_offset;
  f.d = D.d;
  cudaError_t err = madeleine::stack_fwd<madeleine::Gemm::MMA_SYNC>(f, st);
  if (err != cudaSuccess) return (int)err;
  // the three layer adjoints from dy
  madeleine::StackBwd a{};
  a.x = f.x; a.h1 = H1; a.h2 = H2;
  a.u[0] = U1; a.u[1] = U2; a.u[2] = U3;
  a.rstd = rstd;
  a.w1 = f.w[0]; a.w2 = f.w[1]; a.w3 = f.w[2];
  for (int i = 0; i < 3; ++i) {
    a.s[i] = f.s[i];
    a.sh[i] = f.sh[i];
    a.dw[i] = (float*)p[14 + 4 * i];
    a.db[i] = (float*)p[15 + 4 * i];
    a.ds[i] = (float*)p[16 + 4 * i];
    a.dt[i] = (float*)p[17 + 4 * i];
  }
  a.DZ3 = (bf16*)p[33];
  a.DH = (float*)p[34];
  a.DZ12 = (bf16*)p[35];
  a.work = (float*)p[36];
  a.part = (float*)p[37];
  a.ldp = 3LL * (D.E > D.hd ? D.E : D.hd);
  a.dx = (bf16*)p[38];
  a.M = D.M; a.t = D.t; a.d_in = D.d_in; a.hd = D.hd; a.E = D.E;
  a.row_offset = D.row_offset;
  a.d = D.d;
  return (int)madeleine::stack_bwd<madeleine::Gemm::MMA_SYNC>(a, dy, st);
}
