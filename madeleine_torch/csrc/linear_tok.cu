// Token projector for training in bf16: forward (kernel 19) and backward
// (kernel 20) of the per-op lane.
//
// Replaces madeleine_tpu/ops/linear_tok.py::_fwd_kernel and ::_bwd_kernel:
//   forward:  tok [M, dout] = y [M, E] Wt^T + bt   (f32 accumulation and
//             bias, cast to bf16)
//   backward: dy [M, E] = g Wt (bf16), dWt = g^T y, dbt = sum of g (f32)
// with g the cotangent of tok in bf16. The TPU needed the kernels to pin
// the operands' layout; here they are the token projector's products of
// K6/K7 behind an entry point of their own.
//
// What bounds it on an H100: 2 * E * dout = 0.52 MFLOP per token forward at
// the published widths (2048 -> 128) and twice that backward, against 4.3 KB
// and 8.4 KB of traffic per token: about 120 operations per byte, below the
// card's 295, so the bytes of y, dy and g bound both.
//
// Design (simple first): the mma.sync GEMM of gemm_bf16.cuh with the bias
// in the epilogue; the weight gradient split over the tokens into pieces
// summed in order, the bias gradient per-tile column partials summed in
// tile order (train_rows.cuh): no atomics, launches are bitwise
// reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "train_rows.cuh"

using madeleine::bf16;

// dims: M (= b * t), E, dout. p: y [M, E] bf16, wt [dout, E] bf16, bt [dout]
// f32, tok [M, dout] bf16. Returns a cudaError_t.
extern "C" int linear_tok_forward(void** p, const long long* dims, const float*,
                                  void* stream_) {
  return (int)madeleine::tok_product((const bf16*)p[0], (const bf16*)p[1], (const float*)p[2],
                                     (bf16*)p[3], (int)dims[0], (int)dims[1], (int)dims[2],
                                     static_cast<cudaStream_t>(stream_));
}

// Floats of workspace the backward needs: [split-K partials, column partials].
extern "C" void linear_tok_bwd_workspace(const long long* dims, long long* out) {
  const int M = (int)dims[0], E = (int)dims[1], dout = (int)dims[2];
  out[0] = madeleine::wgrad_work_floats(dout, E, M, 1);
  out[1] = (long long)madeleine::row_tiles(M) * dout;
}

// dims as linear_tok_forward. p: y, g [M, dout] bf16, wt, then the outputs
// dy [M, E] bf16, dwt [dout, E] f32, dbt [dout] f32, then the two
// workspaces of linear_tok_bwd_workspace. Returns a cudaError_t.
extern "C" int linear_tok_backward(void** p, const long long* dims, const float*,
                                   void* stream_) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const int M = (int)dims[0], E = (int)dims[1], dout = (int)dims[2];
  const bf16 *y = (const bf16*)p[0], *g = (const bf16*)p[1], *wt = (const bf16*)p[2];
  const cudaError_t err = madeleine::dgrad<bf16>(g, dout, 0, wt, E, 0, (bf16*)p[3], E, 0, M, E,
                                                 dout, 1, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)madeleine::tok_wgrad(g, y, (float*)p[4], (float*)p[5], (float*)p[6],
                                   (float*)p[7], dout, M, E, dout, st);
}
