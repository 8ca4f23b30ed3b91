// Gated attention logits for training, bf16 or f32 operands: forward
// (kernel 17) and backward (kernel 18) of the per-op lane (the f32 entry
// points at the end of this file).
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
// Design of the forward (kernel 17, redesigned for Hopper): K6's gate
// product, alone. One batched launch of the TMA + wgmma GEMM of
// gemm_wgmma.cuh (64-row tiles, the heads as coordinates) on [Wa; Wb]_h in
// K6's permuted row order (ops/gated_logits.py::permute_gates), whose
// epilogue (epilogue_gates, with no a_pre / b_pre to write, as in K1's call)
// forms a and g, their dropout and one partial logit per 64 gate columns;
// then gate_logits_sum (train_rows.cuh, K6's) adds the partials in chunk
// order and bc. The f32 gate products never reach memory: the scratch is
// the partials [M, nh, f/64] f32, 17 MB at the step's call shape where the
// first design's G took 2.18 GB. Per element the logits are K6's for the
// same y with no mask bias. The first design (the f32 gate products on the
// mma.sync GEMM of gemm_bf16.cuh, then gate_logits_fwd's row pass over
// them) stays as the check-only entry point gated_logits_forward_rowblock.
//
// Design of the backward (kernel 18, redesigned for Hopper): the recompute
// and the gate adjoint are one batched launch of the same GEMM on the same
// permuted [Wa; Wb], whose epilogue (epilogue_gates_bwd) forms a, g, their
// dropout and dza, dzb from dl and wc, writes DZG [M, nh*2f] bf16 in the
// natural [dza | dzb] order and the per-64-row-tile column partials of dwc,
// dba and dbb: the f32 gate products never reach memory. Then dy = DZG .
// [Wa; Wb] and dW[a|b] = DZG^T y on the same GEMM, as K7's. Parameter
// gradients are split-K partials and per-tile column partials summed in a
// fixed order: no atomics, launches are bitwise reproducible. The first
// design (the f32 gate products on the mma.sync GEMM, K7's gate_bwd pass
// over them, the two products on the same GEMM) stays as the check-only
// entry point gated_logits_backward_rowblock.

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

// dims: b, t, nh, e, f, seed, row_offset, thr (gated_logits_forward).
bool fits(const long long* dims) { return madeleine::rows_fit(dims[0], dims[1], dims[6]); }

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
// p: y [M, nh*e] bf16, wabp [nh, 2f, e] bf16 and babp [nh, 2f] f32 (per head
// [Wa; Wb] and [ba; bb] in K6's permuted row order), wc [nh, f] f32, bc [nh]
// f32, logits [M, nh] f32, then scratch lpart [M, nh, f/64] f32. Returns a
// cudaError_t (cudaErrorInvalidValue where the wgmma GEMM refuses an operand).
extern "C" int gated_logits_forward(void** p, const long long* dims, const float* scales,
                                    void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  const int nh = D.nh, e = D.e, f = D.f, M = D.M;
  const bf16 *y = (const bf16*)p[0], *wabp = (const bf16*)p[1];
  const float *babp = (const float*)p[2], *wc = (const float*)p[3], *bc = (const float*)p[4];
  float *logits = (float*)p[5], *lpart = (float*)p[6];
  using madeleine::wg::EPI_GATES;
  // batch h reads y at column h e and the permuted [Wa; Wb]_h at row h 2f
  const madeleine::WgOperand a{y, D.E, M, D.E, 0, e};
  const madeleine::WgOperand bw{wabp, e, 2LL * nh * f, e, 2 * f, 0};
  madeleine::wg::Params gp = madeleine::wg_params(nullptr, 2 * f, babp, M, 2 * f, e);
  gp.strideBias = 2LL * f;
  gp.batches = nh;
  gp.lpart = lpart; gp.wc = wc;
  gp.f = f; gp.t = D.t; gp.row_offset = D.row_offset;
  gp.d = D.d;
  const cudaError_t err = madeleine::wg_gemm<false, false, EPI_GATES>(a, bw, gp, st);
  if (err != cudaSuccess) return (int)err;
  madeleine::gate_logits_sum<<<(unsigned)(((long long)M * nh + 255) / 256), 256, 0, st>>>(
      lpart, bc, nullptr, logits, M, nh, f / 64);
  return (int)cudaGetLastError();
}

// The first design of the forward, kept as a check (no path calls it).
// dims as gated_logits_forward. p: y, wab [nh, 2f, e] bf16 (per head [Wa;
// Wb]), bab [nh, 2f] f32, wc, bc, logits, then scratch G [M, nh*2f] f32.
extern "C" int gated_logits_forward_rowblock(void** p, const long long* dims,
                                             const float* scales, void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
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
  out[0] = out[1] = 0;   // a call past the row limits is refused: it needs none
  if (!fits(dims)) return;
  const float one = 1.f;
  const Dims D = dims_of(dims, &one);
  out[0] = madeleine::wgrad_work<madeleine::Gemm::WGMMA>(2 * D.f, D.e, D.M, D.nh);
  out[1] = (long long)madeleine::row_tiles(D.M) * 3 * D.nh * D.f;
}

// dims as gated_logits_forward. p: y, dl [M, nh] f32, wabp [nh, 2f, e] bf16
// and babp [nh, 2f] f32 (per head [Wa; Wb] and [ba; bb] in K6's permuted
// row order), wab [nh, 2f, e] bf16 (the natural order), wc, then the
// outputs dy [M, nh*e] bf16, dwab [nh, 2f, e], dbab [nh, 2f], dwc [nh, f]
// (f32), then scratch DZG [M, nh*2f] bf16 and the two workspaces of
// gated_logits_bwd_workspace. Returns a cudaError_t (cudaErrorInvalidValue
// where the wgmma GEMM refuses an operand).
extern "C" int gated_logits_backward(void** p, const long long* dims, const float* scales,
                                     void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  const int nh = D.nh, e = D.e, f = D.f, M = D.M;
  const bf16* y = (const bf16*)p[0];
  const float* dl = (const float*)p[1];
  const bf16* wabp = (const bf16*)p[2];
  const float* babp = (const float*)p[3];
  const bf16* wab = (const bf16*)p[4];
  const float* wc = (const float*)p[5];
  bf16* dy = (bf16*)p[6];
  float *dwab = (float*)p[7], *dbab = (float*)p[8], *dwc = (float*)p[9];
  bf16* DZG = (bf16*)p[10];
  float *work = (float*)p[11], *part = (float*)p[12];
  const long long ldp = 3LL * nh * f;
  const int ntr = madeleine::row_tiles(M);
  using madeleine::Gemm;
  // the gates recomputed and their adjoint, per head h: batch h reads y at
  // column h e and the permuted [Wa; Wb]_h at row h 2f
  const madeleine::WgOperand a{y, D.E, M, D.E, 0, e};
  const madeleine::WgOperand bw{wabp, e, 2LL * nh * f, e, 2 * f, 0};
  madeleine::wg::Params gp = madeleine::wg_params(DZG, 2LL * nh * f, babp, M, 2 * f, e);
  gp.strideBias = 2LL * f;
  gp.batches = nh;
  gp.wc = wc; gp.dl = dl;
  gp.lpart = part; gp.ld_part = ldp;
  gp.f = f; gp.t = D.t; gp.row_offset = D.row_offset;
  gp.d = D.d;
  cudaError_t err = madeleine::wg_gemm<false, false, madeleine::wg::EPI_GATES_BWD>(a, bw, gp, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = madeleine::colsum_reduce(part, ldp, 0, nh * f, ntr, dwc, st)) != cudaSuccess)
    return (int)err;
  if ((err = madeleine::colsum_reduce(part, ldp, nh * f, 2 * nh * f, ntr, dbab, st)) !=
      cudaSuccess)
    return (int)err;
  // dy_h = [dza | dzb]_h . [Wa; Wb]_h: both branches in one f32 sum, cast once
  if ((err = madeleine::dgrad<Gemm::WGMMA, bf16>(DZG, 2LL * nh * f, 2LL * f, wab, e,
                                                 2LL * f * e, dy, D.E, e, M, e, 2 * f, nh, 0,
                                                 st)) != cudaSuccess)
    return (int)err;
  // dW[a|b]_h = DZG_h^T y_h
  return (int)madeleine::wgrad<Gemm::WGMMA>(DZG, 2LL * nh * f, 2LL * f, y, D.E, e, 2 * f, e, M,
                                            nh, dwab, work, st);
}

// The first design of the backward, kept as a check (no path calls it).
extern "C" void gated_logits_bwd_rowblock_workspace(const long long* dims, long long* out) {
  out[0] = out[1] = 0;   // a call past the row limits is refused: it needs none
  if (!fits(dims)) return;
  const float one = 1.f;
  const Dims D = dims_of(dims, &one);
  out[0] = madeleine::wgrad_work<madeleine::Gemm::MMA_SYNC>(2 * D.f, D.e, D.M, D.nh);
  out[1] = (long long)madeleine::row_tiles(D.M) * 3 * D.nh * D.f;
}

// dims as gated_logits_forward. p: y, dl [M, nh] f32, wab, bab, wc (the
// natural order), then the outputs as gated_logits_backward's, then scratch
// G [M, nh*2f] f32, DZG [M, nh*2f] bf16 and the two workspaces of
// gated_logits_bwd_rowblock_workspace. Returns a cudaError_t.
extern "C" int gated_logits_backward_rowblock(void** p, const long long* dims,
                                              const float* scales, void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
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
  using madeleine::Gemm;
  if ((err = madeleine::dgrad<Gemm::MMA_SYNC, bf16>(DZG, 2LL * nh * f, 2LL * f, wab, e,
                                                    2LL * f * e, dy, D.E, e, M, e, 2 * f, nh, 0,
                                                    st)) != cudaSuccess)
    return (int)err;
  return (int)madeleine::wgrad<Gemm::MMA_SYNC>(DZG, 2LL * nh * f, 2LL * f, y, D.E, e, 2 * f, e,
                                               M, nh, dwab, work, st);
}

// ---------------------------------------------------------------------------
// f32 operands (--precision float32 on the per-op lane): the JAX package runs
// both TPU kernels at f32 with Precision.HIGHEST. Every product on
// gemm_ffma.cuh's FFMA tiles (each output's k in order with fmaf), the gates
// exact (tanhf, 1 / (1 + expf(-v))), nothing rounded: the FFMA gate product
// (ff::gates, K6 f32's first design) and K7 f32's gate adjoint (gate_bwd), one
// each. What bounds them on an H100: the same
// multiply-adds as the bf16 route against the 67 TFLOP/s of f32 FMA.
// ---------------------------------------------------------------------------

// Kernel 17, f32. dims as gated_logits_forward. p as gated_logits_forward's
// with y and wabp in f32: the FFMA gate product (ff::gates, the partial
// logit of every 64 gate columns a fixed xor tree of 16 four-column sums),
// then gate_logits_sum adds the partials in chunk order and bc.
extern "C" int gated_logits_forward_f32(void** p, const long long* dims, const float* scales,
                                        void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  float *logits = (float*)p[5], *lpart = (float*)p[6];
  const cudaError_t err = madeleine::ff::gates(
      (const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3], nullptr,
      nullptr, 0, 0, lpart, D.M, D.nh, D.e, D.f, D.t, D.row_offset, D.d, st);
  if (err != cudaSuccess) return (int)err;
  madeleine::gate_logits_sum<<<(unsigned)(((long long)D.M * D.nh + 255) / 256), 256, 0, st>>>(
      lpart, (const float*)p[4], nullptr, logits, D.M, D.nh, D.f / 64);
  return (int)cudaGetLastError();
}

// Floats of workspace the f32 backward needs: [split pieces, column partials].
extern "C" void gated_logits_bwd_workspace_f32(const long long* dims, long long* out) {
  out[0] = out[1] = 0;   // a call past the row limits is refused: it needs none
  if (!fits(dims)) return;
  const float one = 1.f;
  const Dims D = dims_of(dims, &one);
  out[0] = madeleine::wgrad_work<madeleine::Gemm::FFMA>(2 * D.f, D.e, D.M, D.nh);
  out[1] = (long long)madeleine::row_tiles(D.M) * 3 * D.nh * D.f;
}

// Kernel 18, f32: the first design's sequence on the FFMA tiles, in one
// scratch buffer G [M, nh*2f] f32: the recompute writes per head [a_pre |
// b_pre] there, and the adjoint overwrites them in place with DZG, per head
// [dza | dzb] (each thread reads its four columns of a and g of a row
// before it writes their dza and dzb, and nothing reads them again): 8.7 GB
// less at bucket 8192 than separate buffers. dims as gated_logits_forward.
// p: y [M, nh*e] f32, dl [M, nh] f32, wabp, babp (K6's permuted order), wab
// (the natural order), wc, then the outputs dy [M, nh*e], dwab [nh, 2f, e],
// dbab [nh, 2f], dwc [nh, f] (f32), then scratch G and the two workspaces of
// gated_logits_bwd_workspace_f32. Returns a cudaError_t.
extern "C" int gated_logits_backward_f32(void** p, const long long* dims, const float* scales,
                                         void* stream_) {
  if (!fits(dims)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Dims D = dims_of(dims, scales);
  const int nh = D.nh, e = D.e, f = D.f, M = D.M;
  const float *y = (const float*)p[0], *dl = (const float*)p[1];
  const float *wabp = (const float*)p[2], *babp = (const float*)p[3];
  const float *wab = (const float*)p[4], *wc = (const float*)p[5];
  float* dy = (float*)p[6];
  float *dwab = (float*)p[7], *dbab = (float*)p[8], *dwc = (float*)p[9];
  float* G = (float*)p[10];
  float *work = (float*)p[11], *part = (float*)p[12];
  const long long ldp = 3LL * nh * f;
  const int ntr = madeleine::row_tiles(M);
  using madeleine::Gemm;
  // the gates recomputed (ff::gates' product and epilogue, no logit partials),
  // then their adjoint (K7 f32's gate_bwd) in place: DZG and the column
  // partials
  const long long ldg = 2LL * nh * f;
  cudaError_t err = madeleine::ff::gates(y, wabp, babp, wc, G, G + f, ldg, 2LL * f, nullptr, M,
                                         nh, e, f, D.t, D.row_offset, D.d, st);
  if (err != cudaSuccess) return (int)err;
  float* DZG = G;
  madeleine::gate_bwd<float, float><<<ntr, nh * f / 4, 0, st>>>(
      G, G + f, ldg, 2 * f, dl, wc, DZG, part, ldp, M, D.t, nh, f, D.row_offset, D.d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = madeleine::colsum_reduce(part, ldp, 0, nh * f, ntr, dwc, st)) != cudaSuccess)
    return (int)err;
  if ((err = madeleine::colsum_reduce(part, ldp, nh * f, 2 * nh * f, ntr, dbab, st)) !=
      cudaSuccess)
    return (int)err;
  // dy_h = [dza | dzb]_h . [Wa; Wb]_h: both branches in one in-order sum
  if ((err = madeleine::dgrad<Gemm::FFMA>(DZG, 2LL * nh * f, 2LL * f, wab, e, 2LL * f * e, dy,
                                          D.E, e, M, e, 2 * f, nh, 0, st)) != cudaSuccess)
    return (int)err;
  // dW[a|b]_h = DZG_h^T y_h, the tokens in pieces added in piece order
  return (int)madeleine::wgrad<Gemm::FFMA>(DZG, 2LL * nh * f, 2LL * f, y, D.E, e, 2 * f, e, M,
                                           nh, dwab, work, st);
}
