#pragma once

#include "train_rows.cuh"

namespace madeleine {

// The whole encoder's row-wise forward up to its residuals: the three
// layers (`sf`, which must set H[2] = Y, y [M, E] bf16) and the gate
// products of every head in one batched launch whose epilogue is the gate
// itself (gemm_wgmma.cuh::epilogue_gates): batch h reads y at column h e and
// the permuted [Wa; Wb]_h (ops/gated_logits.py::permute_gates) at row h 2f,
// writes a_pre, b_pre [M, nh f] bf16 (pre-dropout; skipped when null) and
// one partial logit per 64 columns, lpart [M, nh, f / 64] f32. K6 runs it
// to save u1-u3, rstd, a_pre and b_pre; K7's recompute route runs it again
// from the same x, weights and seed, so its rebuilt rows equal K6's bit for
// bit.
struct RowsFwd {
  StackFwd sf;
  const bf16* wab;     // [nh, 2f, e], rows permuted
  const float* bab;    // [nh, 2f], permuted
  const float* wc;     // [nh, f]
  bf16 *ap, *bp;
  float* lpart;
  int nh, e, f;
  Dropout dgate;
};

inline cudaError_t rows_fwd(const RowsFwd& a, cudaStream_t st) {
  TRAIN_CHECK(stack_fwd<Gemm::WGMMA>(a.sf, st));
  const int M = a.sf.M, E = a.sf.E, nh = a.nh, e = a.e, f = a.f;
  const WgOperand y{a.sf.H[2], E, M, E, 0, e};
  const WgOperand bw{a.wab, e, 2LL * nh * f, e, 2 * f, 0};
  wg::Params gp = wg_params(nullptr, 2 * f, a.bab, M, 2 * f, e);
  gp.strideBias = 2LL * f;
  gp.batches = nh;
  gp.ap = a.ap; gp.bp = a.bp; gp.lpart = a.lpart; gp.wc = a.wc;
  gp.f = f; gp.t = a.sf.t; gp.row_offset = a.sf.row_offset;
  gp.d = a.dgate;
  return wg_gemm<false, false, wg::EPI_GATES>(y, bw, gp, st);
}

}  // namespace madeleine
