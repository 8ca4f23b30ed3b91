// Token projector for training in bf16: forward (kernel 19) and backward
// (kernel 20) of the per-op lane.
//
// Replaces madeleine_tpu/ops/linear_tok.py::_fwd_kernel and ::_bwd_kernel:
//   forward:  tok [M, dout] = y [M, E] Wt^T + bt   (f32 accumulation and
//             bias, cast to bf16)
//   backward: dy [M, E] = g Wt (bf16), dWt = g^T y, dbt = sum of g (f32)
// with g the cotangent of tok in bf16. The TPU needed the kernels to pin
// the operands' layout; here they are the token projector's products
// behind an entry point of their own.
//
// What bounds it on an H100: 2 * E * dout = 0.52 MFLOP per token forward at
// the published widths (2048 -> 128) and twice that backward, against 4.3 KB
// and 8.4 KB of traffic per token: about 120 operations per byte, below the
// card's 295, so the bytes of y, dy and g bound both. At the train step's
// [65, 2048] the forward moves 579 MB: 0.173 ms at 3.35 TB/s, against 0.071
// ms of math at 989 TFLOP/s.
//
// Forward design: the borrowed mma.sync GEMM of gemm_bf16.cuh (128 x 128
// tiles, k tiles of 32 in a 3-stage cp.async ring, a __syncthreads every 32
// k, ldmatrix from every warp) reached 0.386 ms (chip_smoke.py on an H100
// 80GB HBM3 at 700 W), 45% of the byte bound and slower than one F.linear
// call, as its math ran at 165-250 TFLOP/s: to keep
// pace with the bytes the math must run above 400 TFLOP/s, which on this
// card only wgmma does. So the forward is gemm_wgmma.cuh's streaming GEMM:
// one producer thread keeps TMA loads of [128, 64] y and Wt tiles in
// flight in a 4-stage ring, two consumer warpgroups take 128 x 128 output
// tiles in turn on wgmma m64n128k16 with f32 accumulators and the bias in
// the epilogue, so that one warpgroup's epilogue overlaps the other's
// products, and one persistent block per SM walks the tiles. y and Wt are
// both K-major, wgmma's native bf16 case: nothing is transposed. (The
// whole-encoder kernels K6 and K7 run every product on the same GEMM, with
// the other operand layouts.)
//
// Backward design (redesigned for Hopper): both products on the same TMA +
// wgmma GEMM, as K7 runs them (encoder_train_bwd.cu): dy = g Wt through
// dgrad<Gemm::WGMMA, bf16> (g K-major, Wt MN-major, no accumulation, one
// bf16 rounding), dWt = g^T y through tok_wgrad<Gemm::WGMMA> (both operands
// token-major, split over the tokens into pieces summed in split order: 16
// at the train step's call), dbt as per-64-row-tile column partials of g
// summed in tile order (train_rows.cuh). The split-K workspace is the wgmma
// GEMM's own count (wgrad_work<Gemm::WGMMA>: 16.8 MB at d_out 128, E 2048,
// M 133,120).
// No atomics: launches are bitwise reproducible. The first design (both
// products on the mma.sync GEMM of gemm_bf16.cuh, 165-250 TFLOP/s) stays as
// the check-only entry point linear_tok_backward_mmasync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"
#include "train_rows.cuh"

using madeleine::bf16;

namespace {

// dims: M (the b t rows), E, d_out. The GEMM counts rows in 32 bits
// (train_common.cuh::MAX_TRAIN_ROWS): a larger call runs in blocks of whole
// bags (models/abmil.py::abmil_embed_train).
bool fits(const long long* dims) { return madeleine::rows_fit(1, dims[0], 0); }

}  // namespace

// dims: M (= b * t), E, dout. p: y [M, E] bf16, wt [dout, E] bf16, bt [dout]
// f32, tok [M, dout] bf16. Returns a cudaError_t.
extern "C" int linear_tok_forward(void** p, const long long* dims, const float*,
                                  void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  return (int)madeleine::gemm_tn_wgmma((const bf16*)p[0], (const bf16*)p[1], (const float*)p[2],
                                       (bf16*)p[3], (int)dims[0], (int)dims[2], (int)dims[1],
                                       static_cast<cudaStream_t>(stream_));
}

// Floats of workspace the backward needs: [split-K partials, column partials].
extern "C" void linear_tok_bwd_workspace(const long long* dims, long long* out) {
  out[0] = out[1] = 0;   // a call past the row limit is refused: it needs none
  if (!fits(dims)) return;
  const int M = (int)dims[0], E = (int)dims[1], dout = (int)dims[2];
  out[0] = madeleine::wgrad_work<madeleine::Gemm::WGMMA>(dout, E, M, 1);
  out[1] = (long long)madeleine::row_tiles(M) * dout;
}

namespace {

template <madeleine::Gemm G>
int backward(void** p, const long long* dims, cudaStream_t st) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  const int M = (int)dims[0], E = (int)dims[1], dout = (int)dims[2];
  const bf16 *y = (const bf16*)p[0], *g = (const bf16*)p[1], *wt = (const bf16*)p[2];
  const cudaError_t err =
      madeleine::dgrad<G, bf16>(g, dout, 0, wt, E, 0, (bf16*)p[3], E, 0, M, E, dout, 1, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)madeleine::tok_wgrad<G>(g, y, (float*)p[4], (float*)p[5], (float*)p[6],
                                      (float*)p[7], dout, M, E, dout, st);
}

}  // namespace

// dims as linear_tok_forward. p: y, g [M, dout] bf16, wt, then the outputs
// dy [M, E] bf16, dwt [dout, E] f32, dbt [dout] f32, then the two
// workspaces of linear_tok_bwd_workspace. Returns a cudaError_t
// (cudaErrorInvalidValue where the wgmma GEMM refuses an operand).
extern "C" int linear_tok_backward(void** p, const long long* dims, const float*,
                                   void* stream_) {
  return backward<madeleine::Gemm::WGMMA>(p, dims, static_cast<cudaStream_t>(stream_));
}

// The first design of the backward, kept as a check (no path calls it).
extern "C" void linear_tok_bwd_mmasync_workspace(const long long* dims, long long* out) {
  out[0] = out[1] = 0;   // a call past the row limit is refused: it needs none
  if (!fits(dims)) return;
  const int M = (int)dims[0], E = (int)dims[1], dout = (int)dims[2];
  out[0] = madeleine::wgrad_work<madeleine::Gemm::MMA_SYNC>(dout, E, M, 1);
  out[1] = (long long)madeleine::row_tiles(M) * dout;
}

// Arguments as linear_tok_backward's, the workspaces those of
// linear_tok_bwd_mmasync_workspace.
extern "C" int linear_tok_backward_mmasync(void** p, const long long* dims, const float*,
                                           void* stream_) {
  return backward<madeleine::Gemm::MMA_SYNC>(p, dims, static_cast<cudaStream_t>(stream_));
}
