// Gated attention logits for training in bf16: forward (kernel 17) and
// backward (kernel 18) of the per-op lane.
//
// Replaces madeleine_tpu/ops/gated_logits.py::_fwd_kernel and ::_bwd_kernel.
// Per token row of y [b*t, nh*e] (head-major) and head h:
//   a = drop(tanh(y_h Wa_h^T + ba_h)), g = drop(sigmoid(y_h Wb_h^T + bb_h))
//   l_h = (a g) . wc_h + bc_h                                  -> [nh] f32
// with bf16 operands and f32 accumulation, activations and logits. Dropout
// masks are Philox bits keyed by (seed, global row, token, 3 + 2h + branch,
// column), the keys of K6/K7. The backward keeps the TPU op's residuals,
// (y, seed): it recomputes the gate products in f32 and, from the logits'
// cotangent dl [b*t, nh] f32, emits dy = sum over heads and both branches of
// dz . W (f32 accumulation, one bf16 cast at the end) and dWa, dba, dWb,
// dbb, dwc in f32; dbc = the sum of dl is the caller's, as on the TPU
// (gated_logits.py:317).
//
// What bounds it on an H100: 2 * nh * e * f = 2.1 M multiply-adds per token
// forward at the published widths and 3x that backward (the recompute, the
// input and the weight gradients), against 4-8 KB of traffic per token:
// the dense bf16 rate bounds both.
//
// Design (simple first): K6's batched gate GEMM with tanh / sigmoid in the
// epilogue and its gate row kernel, K7's gate adjoint (train_rows.cuh) on
// the recomputed f32 products; the input gradient is one batched GEMM over
// the concatenated [dza | dzb] against [Wa; Wb] per head. Parameter
// gradients are split-K partials and per-tile column partials summed in a
// fixed order: no atomics, launches are bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "train_rows.cuh"

namespace {

using madeleine::bf16;
using madeleine::Dropout;

struct Dims {
  int b, t, nh, e, f, M, E, row_offset;
  Dropout d;
};

Dims dims_of(const long long* dims, const float* scales) {
  Dims D;
  D.b = (int)dims[0]; D.t = (int)dims[1]; D.nh = (int)dims[2]; D.e = (int)dims[3];
  D.f = (int)dims[4];
  D.M = D.b * D.t;
  D.E = D.nh * D.e;
  D.row_offset = (int)dims[6];
  D.d = Dropout{(uint32_t)dims[5], (uint32_t)dims[7], scales[0]};
  return D;
}

}  // namespace

// dims: b, t, nh, e, f, seed, row_offset, thr. scales: the keep scale.
// p: y [M, nh*e] bf16, wab [nh, 2f, e] bf16 (per head [Wa; Wb]), bab
// [nh, 2f] f32, wc [nh, f] f32, bc [nh] f32, logits [M, nh] f32, then
// scratch G [M, nh*2f] f32. Returns a cudaError_t.
extern "C" int gated_logits_forward(void** p, const long long* dims, const float* scales,
                                    void* stream_) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  float* G = (float*)p[6];
  cudaError_t err = madeleine::gate_products((const bf16*)p[0], (const bf16*)p[1],
                                             (const float*)p[2], G, D.M, D.nh, D.e, D.f, st);
  if (err != cudaSuccess) return (int)err;
  madeleine::gate_logits_fwd<<<D.M, D.nh * D.f / 4, 0, st>>>(
      G, (const float*)p[3], (const float*)p[4], nullptr, (float*)p[5], nullptr, nullptr, D.nh,
      D.f, D.t, D.row_offset, D.d);
  return (int)cudaGetLastError();
}

// Floats of workspace the backward needs: [split-K partials, column partials].
extern "C" void gated_logits_bwd_workspace(const long long* dims, long long* out) {
  const float one = 1.f;
  const Dims D = dims_of(dims, &one);
  out[0] = madeleine::wgrad_work_floats(2 * D.f, D.e, D.M, D.nh);
  out[1] = (long long)madeleine::row_tiles(D.M) * 3 * D.nh * D.f;
}

// dims as gated_logits_forward. p: y, dl [M, nh] f32, wab, bab, wc, then
// the outputs dy [M, nh*e] bf16, dwab [nh, 2f, e], dbab [nh, 2f], dwc
// [nh, f] (f32), then scratch G [M, nh*2f] f32, DZG [M, nh*2f] bf16 and the
// two workspaces of gated_logits_bwd_workspace. Returns a cudaError_t.
extern "C" int gated_logits_backward(void** p, const long long* dims, const float* scales,
                                     void* stream_) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  const int nh = D.nh, e = D.e, f = D.f, M = D.M;
  const bf16* y = (const bf16*)p[0];
  const float* dl = (const float*)p[1];
  const bf16* wab = (const bf16*)p[2];
  const float *bab = (const float*)p[3], *wc = (const float*)p[4];
  bf16* dy = (bf16*)p[5];
  float *dwab = (float*)p[6], *dbab = (float*)p[7], *dwc = (float*)p[8];
  float* G = (float*)p[9];
  bf16* DZG = (bf16*)p[10];
  float *work = (float*)p[11], *part = (float*)p[12];
  const long long ldp = 3LL * nh * f;
  const int ntr = madeleine::row_tiles(M);
  // recompute the gate activations (f32), then their adjoint
  cudaError_t err = madeleine::gate_products(y, wab, bab, G, M, nh, e, f, st);
  if (err != cudaSuccess) return (int)err;
  madeleine::gate_bwd<float><<<ntr, nh * f / 4, 0, st>>>(G, G + f, 2LL * nh * f, 2 * f, dl, wc,
                                                         DZG, part, ldp, M, D.t, nh, f,
                                                         D.row_offset, D.d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = madeleine::colsum_reduce(part, ldp, 0, nh * f, ntr, dwc, st)) != cudaSuccess)
    return (int)err;
  if ((err = madeleine::colsum_reduce(part, ldp, nh * f, 2 * nh * f, ntr, dbab, st)) !=
      cudaSuccess)
    return (int)err;
  // dy_h = [dza | dzb]_h . [Wa; Wb]_h: both branches in one f32 sum, cast once
  if ((err = madeleine::dgrad<bf16>(DZG, 2LL * nh * f, 2LL * f, wab, e, 2LL * f * e, dy, D.E, e,
                                    M, e, 2 * f, nh, 0, st)) != cudaSuccess)
    return (int)err;
  // dW[a|b]_h = DZG_h^T y_h
  return (int)madeleine::wgrad(DZG, 2LL * nh * f, 2LL * f, y, D.E, e, 2 * f, e, M, nh, dwab,
                               work, st);
}
