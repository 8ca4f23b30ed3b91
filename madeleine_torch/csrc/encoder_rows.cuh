#pragma once

#include "train_rows.cuh"

namespace madeleine {

// The whole encoder's row-wise forward up to its residuals: the three
// layers (`sf`) and the gate products of every head in one batched launch
// whose epilogue is the gate itself: batch h reads y at column h e and the
// permuted [Wa; Wb]_h (ops/gated_logits.py::permute_gates) at row h 2f,
// writes a_pre, b_pre [M, nh f] in T (pre-dropout; skipped when null) and
// one partial logit per 64 columns, lpart [M, nh, f / 64] f32. K6 runs it
// to save u1-u3, rstd, a_pre and b_pre; K7's recompute route runs it again
// from the same x, weights and seed, so its rebuilt rows equal K6's bit for
// bit. bf16 (T = bf16): every product on the wgmma GEMM, the gates in
// gemm_wgmma.cuh::epilogue_gates, y read from sf.H[2] (bf16, must be set).
// f32 (T = float): every product on gemm_ffma.cuh's FFMA tiles, the gates in
// ff::epilogue_gates (exact tanh and sigmoid), y read from sf.H[2], or from
// Z when H[2] is null (then sf.y32 must be set: y = y32 in f32).
template <typename T>
struct RowsFwdT {
  StackFwdT<T> sf;
  const T* wab;        // [nh, 2f, e], rows permuted
  const float* bab;    // [nh, 2f], permuted
  const float* wc;     // [nh, f]
  T *ap, *bp;
  float* lpart;
  int nh, e, f;
  Dropout dgate;
};
using RowsFwd = RowsFwdT<bf16>;

template <typename T>
inline cudaError_t rows_fwd(const RowsFwdT<T>& a, cudaStream_t st) {
  const int M = a.sf.M, E = a.sf.E, nh = a.nh, e = a.e, f = a.f;
  if constexpr (sizeof(T) == 4) {
    if (!a.sf.H[2] && !a.sf.y32) return cudaErrorInvalidValue;
    TRAIN_CHECK(stack_fwd<Gemm::FFMA>(a.sf, st));
    return ff::gates(a.sf.H[2] ? a.sf.H[2] : a.sf.Z, a.wab, a.bab, a.wc, a.ap, a.bp,
                     (long long)nh * f, f, a.lpart, M, nh, e, f, a.sf.t, a.sf.row_offset, a.dgate,
                     st);
  } else {
    TRAIN_CHECK(stack_fwd<Gemm::WGMMA>(a.sf, st));
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
}

}  // namespace madeleine
