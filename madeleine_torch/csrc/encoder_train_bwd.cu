// Whole-encoder training backward (kernel K7), bf16 or f32 operands.
//
// Replaces madeleine_tpu/ops/encoder_train.py::_bwd_kernel (both save_acts
// routes, need_dx off and on, n_views 1 and 3). From the forward's residuals
// (u1, u2, u3, a_pre, b_pre, rstd), the masked logits and the pool
// statistics (m, s), it forms the
// summed cotangent of y in the TPU kernel's order (pool term, then token
// projector term, then gate terms; encoder_train.py:341-407) and runs the
// adjoints of the gates, the token projector and the three LN / GELU /
// dropout layers (ops/preattn.py::_layer_bwd). No forward product is
// recomputed: h1, h2 and y are rebuilt elementwise from the residuals.
// On the recompute route (save_acts off, B1c; JAX's _recompute_stack,
// encoder_train.py:128-141) the residuals were not kept: the backward first
// re-runs K6's own device code (encoder_rows.cuh::rows_fwd: the three
// layers and the gate product with its gate epilogue) from x, the weights
// and the seed into transient buffers, so the rebuilt rows equal K6's saved
// ones bit for bit and every gradient equals the save route's bit for bit.
// The recompute's f32 scratch is DY's memory and its logit partials DZG's,
// both written only after it.
// Outputs: the 20 weight, bias and LN gradients in f32 and, when the caller
// passes a dx buffer (need_dx: the input carries the learned stain-encoding
// columns), the input gradient dx = dz1 . W1 [b, t, d_in] in bf16.
// With f32 operands (encoder_train_backward_f32, the JAX package's parity
// route, encoder_train.py:308,323): the same launches with the residuals,
// the rebuilt activations, the cotangents DZG, DZ3, DZ12, dtok and dx in
// f32 (nothing rounded to bf16) and every product on gemm_tf32.cuh's
// split-TF32 wgmma GEMM: the input gradients with the weights split into
// TF32 hi and lo and transposed once a call (t32::split_weights; TF32 wgmma
// reads both operands K-major), the weight gradients transposing and
// splitting both token-major operands in shared memory, their token sums
// split into pieces of whole 32-token k tiles summed in piece order
// (t32::wgrad), the recompute route re-running K6's f32 rows on the same
// engine and the same splits. The first f32 design ran the products on
// gemm_ffma.cuh's FFMA tiles (no tensor cores), 44% of FP32's 67 TFLOP/s.
//
// What bounds it on an H100: 7.6 M multiply-adds per token at the published
// widths (a weight gradient for every product, an input gradient for every
// product but layer 1; with dx, layer 1's too, 7.9 M at d_in 544; the
// recompute route adds K6's 3.9 M): the dense bf16 rate bounds it, as for K6.
//
// Design. Every product runs on the TMA + wgmma GEMM of gemm_wgmma.cuh (PR
// 3's first version used the mma.sync GEMM of gemm_bf16.cuh, at about 210
// TFLOP/s): the input gradients with an MN-major B (the weights as stored),
// accumulating into the f32 cotangent in place, the gates' batched over
// heads by coordinates, dx in bf16; the weight gradients with both operands
// MN-major (token-major activations and cotangents), their reduction over
// all tokens split into pieces of whole k tiles that are summed in piece
// order. Row kernels loop over 64-row tiles for the elementwise adjoints,
// each thread owning 4 columns, so the bias, LN scale and shift gradients
// are per-tile column partials summed in tile order. Nothing uses atomics:
// two launches on the same inputs give bitwise-equal gradients. The gate,
// token-projector and layer adjoints are train_rows.cuh's, shared with the
// per-op kernels 16, 18 and 20 (which stay on the mma.sync GEMM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "encoder_rows.cuh"

namespace {

using madeleine::bf16;
using madeleine::Dropout;
using madeleine::ROW_TILE;
using madeleine::Gemm;

// One row per block, W/4 threads: H = gelu(u * s + sh) * mask, in T.
template <typename T>
__global__ void recon_h(const T* __restrict__ U, const float* __restrict__ s,
                        const float* __restrict__ sh, T* __restrict__ H, int W, int t,
                        int row_offset, int layer, Dropout d) {
  const long long r = blockIdx.x;
  const int c = threadIdx.x * 4;
  float u[4], k[4], h[4];
  madeleine::load4(U + r * W + c, u);
  madeleine::keep4(d, threadIdx.x, (int)(r % t), (int)(r / t) + row_offset, layer, k);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = u[j] * s[c + j] + sh[c + j];
    h[j] = v * madeleine::gauss_cdf(v) * k[j];
  }
  madeleine::store4(H + r * W + c, h);
}

// Pool adjoint. Block = 64-row tile, E/4 threads (e % 128 == 0). Per row:
// y32 rebuilt from u3; per view v (NV = 1, or 3 with the view bias vb [t, 2]
// added to the logits of views 1 and 2): p_v = softmax weight, dl += p_v
// (y32_h . g_v,h - inner_v,h), DY += p_v g_v (the first term of the summed
// cotangent, encoder_train.py:341-356); Y = y32 in T, DL = dl.
// part[tile, h] = sum of the tile's dl (for dbc).
template <int NV, typename T>
__global__ void pool_bwd(const T* __restrict__ U3, const float* __restrict__ s3,
                         const float* __restrict__ t3, const float* __restrict__ l,
                         const float* __restrict__ vb, const float* __restrict__ m,
                         const float* __restrict__ s, const float* __restrict__ g,
                         const float* __restrict__ inner, T* __restrict__ Y,
                         float* __restrict__ DY, float* __restrict__ DL, float* __restrict__ part,
                         long long ld_part, int M, int t, int nh, int e, int row_offset,
                         Dropout d) {
  __shared__ float red[32];
  const int tpb = e / 4, h = threadIdx.x / tpb, c = h * e + (threadIdx.x % tpb) * 4;
  const int E = nh * e, wph = tpb / 32;
  float sh3[4], tt3[4];
  madeleine::load4(s3 + c, sh3);
  madeleine::load4(t3 + c, tt3);
  float dbc = 0.f;
  const long long r0 = (long long)blockIdx.x * ROW_TILE;
  for (int i = 0; i < ROW_TILE; ++i) {
    const long long r = r0 + i;
    if (r >= M) break;
    const int bi = (int)(r / t), tok = (int)(r % t);
    float u[4], k[4], y[4];
    madeleine::load4(U3 + r * E + c, u);
    madeleine::keep4(d, c / 4, tok, bi + row_offset, 2, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = u[j] * sh3[j] + tt3[j];
      y[j] = v * madeleine::gauss_cdf(v) * k[j];
    }
    madeleine::store4(Y + r * E + c, y);
    const float lh = l[r * nh + h];
    float dl = 0.f, dy[4];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const long long bv = (long long)bi * NV + v;
      float gv[4];
      madeleine::load4(g + bv * E + c, gv);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) dot += y[j] * gv[j];
      dot = madeleine::group_sum(dot, red, h * wph, wph);
      const float lv = v == 0 ? lh : lh + vb[(long long)tok * 2 + v - 1];
      const float p = lv > madeleine::TRAIN_MASKED ? expf(lv - m[bv * nh + h]) / s[bv * nh + h]
                                                   : 0.f;
      const float dlv = p * (dot - inner[bv * nh + h]);
      dl = v == 0 ? dlv : dl + dlv;
#pragma unroll
      for (int j = 0; j < 4; ++j) dy[j] = v == 0 ? p * gv[j] : dy[j] + p * gv[j];
    }
    madeleine::store4(DY + r * E + c, dy);
    if (threadIdx.x % tpb == 0) {
      DL[r * nh + h] = dl;
      dbc += dl;
    }
  }
  if (threadIdx.x % tpb == 0) part[blockIdx.x * ld_part + h] = dbc;
}

#define CHECK(x)                               \
  do {                                         \
    cudaError_t err_ = (x);                    \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

struct Shapes {
  int b, t, d_in, hd, nh, e, f, dout, M, E, ntr;
};

Shapes shapes_of(const long long* dims) {
  Shapes S;
  S.b = (int)dims[0]; S.t = (int)dims[1]; S.d_in = (int)dims[2]; S.hd = (int)dims[3];
  S.nh = (int)dims[4]; S.e = (int)dims[5]; S.f = (int)dims[6]; S.dout = (int)dims[7];
  S.M = S.b * S.t; S.E = S.nh * S.e;
  S.ntr = (S.M + ROW_TILE - 1) / ROW_TILE;
  return S;
}

// Row stride of the column-partial buffer (floats per 64-row tile).
long long colpart_stride(const Shapes& S) {
  long long cols = 3LL * S.nh * S.f;
  const long long cand[4] = {3LL * S.E, 3LL * S.hd, (long long)S.dout, (long long)S.nh};
  for (long long c : cand) cols = c > cols ? c : cols;
  return cols;
}

// Floats of workspace the backward needs on engine G: [split-K partials,
// column partials, and on TF32 the weight splits: the five matrices
// transposed, then w1, w2, w3 and the permuted [Wa; Wb] as stored for the
// recompute route].
template <Gemm G>
void workspace(const long long* dims, long long* out) {
  const Shapes S = shapes_of(dims);
  long long w = madeleine::stack_bwd_work<G>(S.M, S.d_in, S.hd, S.E);
  const long long cand[2] = {madeleine::wgrad_work<G>(2 * S.f, S.e, S.M, S.nh),
                             madeleine::wgrad_work<G>(S.dout, S.E, S.M, 1)};
  for (long long c : cand) w = c > w ? c : w;
  out[0] = w;
  out[1] = S.ntr * colpart_stride(S);
  if constexpr (G == Gemm::TF32) {
    const long long fwd = madeleine::split_fwd_floats(S.d_in, S.hd, S.E, S.nh, S.e, S.f, S.dout);
    out[2] = 2 * fwd - madeleine::t32::split_floats(1, S.dout, S.E);
  }
}

// dims as encoder_train_forward (dims[12] = nv), and dims[13] = 1 on the
// recompute route. p: the pointers of
// ops/encoder_train.py::encoder_train_bwd_cuda's `tensors`, in that order
// (dx null without need_dx; the view bias [t, 2] null when nv = 1; then, set
// on the recompute route only, b1, b2, b3 and K6's permuted [Wa; Wb] and
// [ba; bb], while u1, u2, u3, a_pre, b_pre and rstd are the buffers the
// recompute fills; then, f32 only, the weight splits, out[2] of
// encoder_train_bwd_workspace_f32). g is [b, nv, E]; inner, m and s are [b,
// nv, nh]. T: the operands' type, bf16 on the wgmma GEMM, float on the
// split-TF32 GEMM. Returns a cudaError_t.
template <typename T>
int backward(void** p, const long long* dims, const float* scales, void* stream_) {
  constexpr Gemm G = sizeof(T) == 4 ? Gemm::TF32 : Gemm::WGMMA;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  // rows and global bag indices are 32-bit below (every offset is 64-bit):
  // a larger call runs in blocks of whole bags (ops/encoder_train.py)
  if (!madeleine::rows_fit(dims[0], dims[1], dims[9]))
    return (int)cudaErrorInvalidValue;
  const Shapes S = shapes_of(dims);
  const Dropout dpre{(uint32_t)dims[8], (uint32_t)dims[10], scales[0]};
  const Dropout dgate{(uint32_t)dims[8], (uint32_t)dims[11], scales[1]};
  const int ro = (int)dims[9];
  const int M = S.M, E = S.E, hd = S.hd, nh = S.nh, e = S.e, f = S.f, t = S.t;
  const T* x = (const T*)p[0];
  const float *l = (const float*)p[1], *m = (const float*)p[2], *s = (const float*)p[3];
  const float *g = (const float*)p[4], *inner = (const float*)p[5];
  const T* dtok = (const T*)p[6];
  const T *u1 = (const T*)p[7], *u2 = (const T*)p[8], *u3 = (const T*)p[9];
  const T *ap = (const T*)p[10], *bp = (const T*)p[11];
  const float* rstd = (const float*)p[12];
  const T* w1 = (const T*)p[13];
  const float *s1 = (const float*)p[14], *t1 = (const float*)p[15];
  const T* w2 = (const T*)p[16];
  const float *s2 = (const float*)p[17], *t2 = (const float*)p[18];
  const T* w3 = (const T*)p[19];
  const float *s3 = (const float*)p[20], *t3 = (const float*)p[21];
  const T* wab = (const T*)p[22];
  const float* wc = (const float*)p[23];
  const T* wt = (const T*)p[24];
  float *dw1 = (float*)p[25], *db1 = (float*)p[26], *ds1 = (float*)p[27], *dt1 = (float*)p[28];
  float *dw2 = (float*)p[29], *db2 = (float*)p[30], *ds2 = (float*)p[31], *dt2 = (float*)p[32];
  float *dw3 = (float*)p[33], *db3 = (float*)p[34], *ds3 = (float*)p[35], *dt3 = (float*)p[36];
  float *dwab = (float*)p[37], *dbab = (float*)p[38], *dwc = (float*)p[39], *dbc = (float*)p[40];
  float *dwt = (float*)p[41], *dbt = (float*)p[42];
  T *H1 = (T*)p[43], *H2 = (T*)p[44], *Y = (T*)p[45];
  float *DY = (float*)p[46], *DL = (float*)p[47];
  T *DZG = (T*)p[48], *DZ3 = (T*)p[49];
  float* DH = (float*)p[50];
  T* DZ12 = (T*)p[51];
  float *work = (float*)p[52], *part = (float*)p[53];
  T* dx = (T*)p[54];   // null unless need_dx
  const float* vb = (const float*)p[55];   // null when nv = 1
  const int nv = (int)dims[12];
  if (nv != 1 && (nv != 3 || vb == nullptr)) return (int)cudaErrorInvalidValue;
  const long long ldp = colpart_stride(S);
  const int ntr = S.ntr;
  // the input gradients' B: the weights as stored (bf16), or (f32) split
  // into TF32 hi and lo and transposed per batch; the recompute's weights:
  // as stored, or split as stored
  const T *w1b = w1, *w2b = w2, *w3b = w3, *wabb = wab, *wtb = wt;
  const T *w1r = w1, *w2r = w2, *w3r = w3, *wabr = (const T*)p[59];
  if constexpr (sizeof(T) == 4) {
    float* ws = (float*)p[61];
    if (!ws) return (int)cudaErrorInvalidValue;
    const float* src[5] = {w1, w2, w3, wab, wt};
    const int nb[5] = {1, 1, 1, nh, 1}, R[5] = {hd, hd, E, 2 * f, S.dout};
    const int C[5] = {S.d_in, hd, hd, e, E};
    const T** dst[5] = {&w1b, &w2b, &w3b, &wabb, &wtb};
    for (int i = 0; i < 5; ++i) {
      if (i == 0 && !dx) continue;   // W1 only feeds dx
      CHECK(madeleine::t32::split_weights(src[i], ws, nb[i], R[i], C[i], true, st));
      *dst[i] = ws;
      ws += madeleine::t32::split_floats(nb[i], R[i], C[i]);
    }
    if (dims[13] && wabr) {
      madeleine::SplitFwd sp;
      CHECK(madeleine::split_fwd(w1, w2, w3, wabr, nullptr, ws, S.d_in, hd, E, nh, e, f, S.dout,
                                 sp, st));
      w1r = sp.w1; w2r = sp.w2; w3r = sp.w3; wabr = sp.wab;
    }
  }

  if (dims[13]) {
    // the recompute route: K6's rows from (x, seed) into the residual buffers
    madeleine::RowsFwdT<T> rf{};
    madeleine::StackFwdT<T>& sf = rf.sf;
    sf.x = x;
    sf.w[0] = w1r; sf.w[1] = w2r; sf.w[2] = w3r;
    sf.b[0] = (const float*)p[56]; sf.b[1] = (const float*)p[57];
    sf.b[2] = (const float*)p[58];
    sf.s[0] = s1; sf.s[1] = s2; sf.s[2] = s3;
    sf.sh[0] = t1; sf.sh[1] = t2; sf.sh[2] = t3;
    sf.Z = DY;
    sf.U[0] = (T*)p[7]; sf.U[1] = (T*)p[8]; sf.U[2] = (T*)p[9];
    sf.rstd = (float*)p[12];
    sf.H[0] = H1; sf.H[1] = H2; sf.H[2] = Y;
    sf.M = M; sf.t = t; sf.d_in = S.d_in; sf.hd = hd; sf.E = E; sf.row_offset = ro;
    sf.y32 = 0;
    sf.d = dpre;
    rf.wab = wabr; rf.bab = (const float*)p[60]; rf.wc = wc;
    rf.ap = (T*)p[10]; rf.bp = (T*)p[11];
    rf.lpart = reinterpret_cast<float*>(DZG);   // [M, nh, f / 64] f32 in DZG's bytes
    rf.nh = nh; rf.e = e; rf.f = f;
    rf.dgate = dgate;
    if (!sf.b[0] || !sf.b[1] || !sf.b[2] || !rf.wab || !rf.bab) return (int)cudaErrorInvalidValue;
    CHECK(madeleine::rows_fwd(rf, st));
  }

  // rebuild h1, h2 (the operands of dW2, dW3, in T)
  recon_h<T><<<M, hd / 4, 0, st>>>(u1, s1, t1, H1, hd, t, ro, 0, dpre);
  CHECK(cudaGetLastError());
  recon_h<T><<<M, hd / 4, 0, st>>>(u2, s2, t2, H2, hd, t, ro, 1, dpre);
  CHECK(cudaGetLastError());
  // 1. pool term of dy; dl; y
  if (nv == 1)
    pool_bwd<1, T><<<ntr, E / 4, 0, st>>>(u3, s3, t3, l, vb, m, s, g, inner, Y, DY, DL, part,
                                          ldp, M, t, nh, e, ro, dpre);
  else
    pool_bwd<3, T><<<ntr, E / 4, 0, st>>>(u3, s3, t3, l, vb, m, s, g, inner, Y, DY, DL, part,
                                          ldp, M, t, nh, e, ro, dpre);
  CHECK(cudaGetLastError());
  CHECK(madeleine::colsum_reduce(part, ldp, 0, nh, ntr, dbc, st));
  // 2. token projector term: DY += dtok . Wt; dWt = dtok^T y; dbt
  CHECK(madeleine::dgrad<G>(dtok, S.dout, 0, wtb, E, 0, DY, E, 0, M, E, S.dout, 1, 1, st));
  CHECK(madeleine::tok_wgrad<G>(dtok, Y, dwt, dbt, work, part, ldp, M, E, S.dout, st));
  // 3. gate terms: DZG; DY_h += [dza | dzb]_h . [Wa; Wb]_h; dW[a|b]_h = DZG_h^T y_h
  madeleine::gate_bwd<T, T><<<ntr, nh * f / 4, 0, st>>>(ap, bp, (long long)nh * f, f, DL, wc,
                                                         DZG, part, ldp, M, t, nh, f, ro, dgate);
  CHECK(cudaGetLastError());
  CHECK(madeleine::colsum_reduce(part, ldp, 0, nh * f, ntr, dwc, st));
  CHECK(madeleine::colsum_reduce(part, ldp, nh * f, 2 * nh * f, ntr, dbab, st));
  CHECK(madeleine::dgrad<G>(DZG, 2LL * nh * f, 2LL * f, wabb, e, 2LL * f * e, DY, E, e, M, e,
                            2 * f, nh, 1, st));
  CHECK(madeleine::wgrad<G>(DZG, 2LL * nh * f, 2LL * f, Y, E, e, 2 * f, e, M, nh, dwab, work,
                            st));
  // 4-6. the three layers on the summed cotangent; dx only when the caller asks for it
  madeleine::StackBwdT<T> sb{};
  sb.x = x; sb.h1 = H1; sb.h2 = H2;
  sb.u[0] = u1; sb.u[1] = u2; sb.u[2] = u3;
  sb.rstd = rstd;
  sb.w1 = w1b; sb.w2 = w2b; sb.w3 = w3b;
  sb.s[0] = s1; sb.s[1] = s2; sb.s[2] = s3;
  sb.sh[0] = t1; sb.sh[1] = t2; sb.sh[2] = t3;
  sb.dw[0] = dw1; sb.dw[1] = dw2; sb.dw[2] = dw3;
  sb.db[0] = db1; sb.db[1] = db2; sb.db[2] = db3;
  sb.ds[0] = ds1; sb.ds[1] = ds2; sb.ds[2] = ds3;
  sb.dt[0] = dt1; sb.dt[1] = dt2; sb.dt[2] = dt3;
  sb.DZ3 = DZ3; sb.DZ12 = DZ12; sb.DH = DH;
  sb.work = work; sb.part = part; sb.ldp = ldp;
  sb.dx = dx;
  sb.M = M; sb.t = t; sb.d_in = S.d_in; sb.hd = hd; sb.E = E; sb.row_offset = ro;
  sb.d = dpre;
  CHECK(madeleine::stack_bwd<G>(sb, (const float*)DY, st));
  return 0;
}

}  // namespace

extern "C" void encoder_train_bwd_workspace(const long long* dims, long long* out) {
  workspace<Gemm::WGMMA>(dims, out);
}

// out[0..2]: the three workspaces above.
extern "C" void encoder_train_bwd_workspace_f32(const long long* dims, long long* out) {
  workspace<Gemm::TF32>(dims, out);
}

extern "C" int encoder_train_backward(void** p, const long long* dims, const float* scales,
                                      void* stream) {
  return backward<bf16>(p, dims, scales, stream);
}

// The same with f32 operands, residuals, cotangents and dx.
extern "C" int encoder_train_backward_f32(void** p, const long long* dims, const float* scales,
                                          void* stream) {
  return backward<float>(p, dims, scales, stream);
}
