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
// f32 (T = float): every product on gemm_tf32.cuh's split-TF32 wgmma GEMM,
// the gates in t32::epilogue_gates (exact tanh and sigmoid), y read from
// sf.H[2], or from Z when H[2] is null (then sf.y32 must be set: y = y32 in
// f32); sf.w[] and wab are then the weights pre-split as stored
// (t32::split_weights: hi, then lo).
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

// The f32 route's forward weights pre-split as stored (t32::split_weights),
// carved from ws in the order w1, w2, w3, the permuted [Wa; Wb], then wt
// where it is set (K6's token projector; K7's recompute has none).
struct SplitFwd {
  const float *w1, *w2, *w3, *wab, *wt;
};

inline long long split_fwd_floats(int d_in, int hd, int E, int nh, int e, int f, int dout) {
  return t32::split_floats(1, hd, d_in) + t32::split_floats(1, hd, hd) +
         t32::split_floats(1, E, hd) + t32::split_floats(nh, 2 * f, e) +
         t32::split_floats(1, dout, E);
}

inline cudaError_t split_fwd(const float* w1, const float* w2, const float* w3, const float* wab,
                             const float* wt, float* ws, int d_in, int hd, int E, int nh, int e,
                             int f, int dout, SplitFwd& out, cudaStream_t st) {
  const float* src[5] = {w1, w2, w3, wab, wt};
  const int R[5] = {hd, hd, E, 2 * nh * f, dout}, C[5] = {d_in, hd, hd, e, E};
  const float** dst[5] = {&out.w1, &out.w2, &out.w3, &out.wab, &out.wt};
  if (!ws) return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) {
    *dst[i] = nullptr;
    if (!src[i]) continue;
    TRAIN_CHECK(t32::split_weights(src[i], ws, 1, R[i], C[i], false, st));
    *dst[i] = ws;
    ws += t32::split_floats(1, R[i], C[i]);
  }
  return cudaSuccess;
}

template <typename T>
inline cudaError_t rows_fwd(const RowsFwdT<T>& a, cudaStream_t st) {
  const int M = a.sf.M, E = a.sf.E, nh = a.nh, e = a.e, f = a.f;
  if constexpr (sizeof(T) == 4) {
    if (!a.sf.H[2] && !a.sf.y32) return cudaErrorInvalidValue;
    TRAIN_CHECK(stack_fwd<Gemm::TF32>(a.sf, st));
    return t32::gates(a.sf.H[2] ? a.sf.H[2] : a.sf.Z, E, a.wab, a.bab, a.wc, a.ap, a.bp,
                      (long long)nh * f, f, a.lpart, M, nh, e, f, a.sf.t, a.sf.row_offset,
                      a.dgate, st);
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
