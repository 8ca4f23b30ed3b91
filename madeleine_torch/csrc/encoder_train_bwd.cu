// Whole-encoder training backward in bf16 (kernel K7).
//
// Replaces madeleine_tpu/ops/encoder_train.py::_bwd_kernel (save_acts route,
// need_dx off and on). From the forward's residuals (u1, u2, u3, a_pre, b_pre,
// rstd), the masked logits and the pool statistics (m, s), it forms the
// summed cotangent of y in the TPU kernel's order (pool term, then token
// projector term, then gate terms; encoder_train.py:341-407) and runs the
// adjoints of the gates, the token projector and the three LN / GELU /
// dropout layers (ops/preattn.py::_layer_bwd). No forward product is
// recomputed: h1, h2 and y are rebuilt elementwise from the residuals.
// Outputs: the 20 weight, bias and LN gradients in f32 and, when the caller
// passes a dx buffer (need_dx: the input carries the learned stain-encoding
// columns), the input gradient dx = dz1 . W1 [b, t, d_in] in bf16.
//
// What bounds it on an H100: 7.6 M multiply-adds per token at the published
// widths (a weight gradient for every product, an input gradient for every
// product but layer 1; with dx, layer 1's too, 7.9 M at d_in 544): the dense
// bf16 rate bounds it, as for K6.
//
// Design (simple first): the GEMM of gemm_bf16.cuh for the input gradients
// (accumulating into the f32 cotangent in place) and the weight gradients,
// whose reduction runs over all tokens split into pieces that are summed in
// piece order; row kernels that loop over 64-row tiles for the elementwise
// adjoints, each thread owning 4 columns, so the bias, LN scale and shift
// gradients are per-tile column partials summed in tile order. Nothing uses
// atomics: two launches on the same inputs give bitwise-equal gradients.
// The gate, token-projector and layer adjoints are train_rows.cuh's, shared
// with the per-op kernels 16, 18 and 20.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "train_rows.cuh"

namespace {

using madeleine::bf16;
using madeleine::Dropout;
using madeleine::ROW_TILE;
using madeleine::dgrad;
using madeleine::wgrad;

// One row per block, W/4 threads: H = bf16(gelu(u * s + sh) * mask).
__global__ void recon_h(const bf16* __restrict__ U, const float* __restrict__ s,
                        const float* __restrict__ sh, bf16* __restrict__ H, int W, int t,
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
// y32 rebuilt from u3, p = softmax weight, dl = p (y32_h . g_h - inner_h),
// DY = p g (the first term of the summed cotangent), Y = bf16(y32), DL = dl.
// part[tile, h] = sum of the tile's dl (for dbc).
__global__ void pool_bwd(const bf16* __restrict__ U3, const float* __restrict__ s3,
                         const float* __restrict__ t3, const float* __restrict__ l,
                         const float* __restrict__ m, const float* __restrict__ s,
                         const float* __restrict__ g, const float* __restrict__ inner,
                         bf16* __restrict__ Y, float* __restrict__ DY, float* __restrict__ DL,
                         float* __restrict__ part, long long ld_part, int M, int t, int nh,
                         int e, int row_offset, Dropout d) {
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
    const int bi = (int)(r / t);
    float u[4], k[4], gv[4], y[4];
    madeleine::load4(U3 + r * E + c, u);
    madeleine::load4(g + (long long)bi * E + c, gv);
    madeleine::keep4(d, c / 4, (int)(r % t), bi + row_offset, 2, k);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = u[j] * sh3[j] + tt3[j];
      y[j] = v * madeleine::gauss_cdf(v) * k[j];
      dot += y[j] * gv[j];
    }
    madeleine::store4(Y + r * E + c, y);
    dot = madeleine::group_sum(dot, red, h * wph, wph);
    const float lh = l[r * nh + h];
    const float p = lh > madeleine::TRAIN_MASKED
                        ? expf(lh - m[bi * nh + h]) / s[bi * nh + h] : 0.f;
    const float dl = p * (dot - inner[bi * nh + h]);
    float dy[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dy[j] = p * gv[j];
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

}  // namespace

// Floats of workspace the backward needs: [split-K partials, column partials].
extern "C" void encoder_train_bwd_workspace(const long long* dims, long long* out) {
  const Shapes S = shapes_of(dims);
  long long w = madeleine::wgrad_work_floats(S.dout, S.E, S.M, 1);
  const long long cand[4] = {madeleine::wgrad_work_floats(2 * S.f, S.e, S.M, S.nh),
                             madeleine::wgrad_work_floats(S.E, S.hd, S.M, 1),
                             madeleine::wgrad_work_floats(S.hd, S.hd, S.M, 1),
                             madeleine::wgrad_work_floats(S.hd, S.d_in, S.M, 1)};
  for (long long c : cand) w = c > w ? c : w;
  out[0] = w;
  out[1] = S.ntr * colpart_stride(S);
}

// dims as encoder_train_forward. p: the pointers of
// ops/encoder_train.py::encoder_train_bwd_cuda's `tensors`, in that order
// (the last, dx, null without need_dx). Returns a cudaError_t.
extern "C" int encoder_train_backward(void** p, const long long* dims, const float* scales,
                                      void* stream_) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const Shapes S = shapes_of(dims);
  const Dropout dpre{(uint32_t)dims[8], (uint32_t)dims[10], scales[0]};
  const Dropout dgate{(uint32_t)dims[8], (uint32_t)dims[11], scales[1]};
  const int ro = (int)dims[9];
  const int M = S.M, E = S.E, hd = S.hd, nh = S.nh, e = S.e, f = S.f, t = S.t;
  const bf16* x = (const bf16*)p[0];
  const float *l = (const float*)p[1], *m = (const float*)p[2], *s = (const float*)p[3];
  const float *g = (const float*)p[4], *inner = (const float*)p[5];
  const bf16* dtok = (const bf16*)p[6];
  const bf16 *u1 = (const bf16*)p[7], *u2 = (const bf16*)p[8], *u3 = (const bf16*)p[9];
  const bf16 *ap = (const bf16*)p[10], *bp = (const bf16*)p[11];
  const float* rstd = (const float*)p[12];
  const bf16* w1 = (const bf16*)p[13];
  const float *s1 = (const float*)p[14], *t1 = (const float*)p[15];
  const bf16* w2 = (const bf16*)p[16];
  const float *s2 = (const float*)p[17], *t2 = (const float*)p[18];
  const bf16* w3 = (const bf16*)p[19];
  const float *s3 = (const float*)p[20], *t3 = (const float*)p[21];
  const bf16* wab = (const bf16*)p[22];
  const float* wc = (const float*)p[23];
  const bf16* wt = (const bf16*)p[24];
  float *dw1 = (float*)p[25], *db1 = (float*)p[26], *ds1 = (float*)p[27], *dt1 = (float*)p[28];
  float *dw2 = (float*)p[29], *db2 = (float*)p[30], *ds2 = (float*)p[31], *dt2 = (float*)p[32];
  float *dw3 = (float*)p[33], *db3 = (float*)p[34], *ds3 = (float*)p[35], *dt3 = (float*)p[36];
  float *dwab = (float*)p[37], *dbab = (float*)p[38], *dwc = (float*)p[39], *dbc = (float*)p[40];
  float *dwt = (float*)p[41], *dbt = (float*)p[42];
  bf16 *H1 = (bf16*)p[43], *H2 = (bf16*)p[44], *Y = (bf16*)p[45];
  float *DY = (float*)p[46], *DL = (float*)p[47];
  bf16 *DZG = (bf16*)p[48], *DZ3 = (bf16*)p[49];
  float* DH = (float*)p[50];
  bf16* DZ12 = (bf16*)p[51];
  float *work = (float*)p[52], *part = (float*)p[53];
  bf16* dx = (bf16*)p[54];   // null unless need_dx
  const long long ldp = colpart_stride(S);
  const int ntr = S.ntr;

  // rebuild h1, h2 (bf16 operands of dW2, dW3)
  recon_h<<<M, hd / 4, 0, st>>>(u1, s1, t1, H1, hd, t, ro, 0, dpre);
  CHECK(cudaGetLastError());
  recon_h<<<M, hd / 4, 0, st>>>(u2, s2, t2, H2, hd, t, ro, 1, dpre);
  CHECK(cudaGetLastError());
  // 1. pool term of dy; dl; y
  pool_bwd<<<ntr, E / 4, 0, st>>>(u3, s3, t3, l, m, s, g, inner, Y, DY, DL, part, ldp, M, t,
                                  nh, e, ro, dpre);
  CHECK(cudaGetLastError());
  CHECK(madeleine::colsum_reduce(part, ldp, 0, nh, ntr, dbc, st));
  // 2. token projector term: DY += dtok . Wt; dWt = dtok^T y; dbt
  CHECK(dgrad(dtok, S.dout, 0, wt, E, 0, DY, E, 0, M, E, S.dout, 1, 1, st));
  CHECK(madeleine::tok_wgrad(dtok, Y, dwt, dbt, work, part, ldp, M, E, S.dout, st));
  // 3. gate terms: DZG; DY_h += [dza | dzb]_h . [Wa; Wb]_h; dW[a|b]_h = DZG_h^T y_h
  madeleine::gate_bwd<bf16><<<ntr, nh * f / 4, 0, st>>>(ap, bp, (long long)nh * f, f, DL, wc,
                                                        DZG, part, ldp, M, t, nh, f, ro, dgate);
  CHECK(cudaGetLastError());
  CHECK(madeleine::colsum_reduce(part, ldp, 0, nh * f, ntr, dwc, st));
  CHECK(madeleine::colsum_reduce(part, ldp, nh * f, 2 * nh * f, ntr, dbab, st));
  CHECK(dgrad(DZG, 2LL * nh * f, 2LL * f, wab, e, 2LL * f * e, DY, E, e, M, e, 2 * f, nh, 1,
              st));
  CHECK(wgrad(DZG, 2LL * nh * f, 2LL * f, Y, E, e, 2 * f, e, M, nh, dwab, work, st));
  // 4-6. the three layers on the summed cotangent; dx only when the caller asks for it
  madeleine::StackBwd sb{};
  sb.x = x; sb.h1 = H1; sb.h2 = H2;
  sb.u[0] = u1; sb.u[1] = u2; sb.u[2] = u3;
  sb.rstd = rstd;
  sb.w1 = w1; sb.w2 = w2; sb.w3 = w3;
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
  CHECK(madeleine::stack_bwd(sb, (const float*)DY, st));
  return 0;
}
