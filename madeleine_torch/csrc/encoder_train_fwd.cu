// Whole-encoder training forward (kernel K6), bf16 or f32 operands.
//
// Replaces madeleine_tpu/ops/encoder_train.py::_fwd_kernel (both save_acts routes).
// Per token row r of x [b*t, d_in]:
//   3 x [Linear -> LayerNorm -> GELU (exact erf) -> dropout]   -> y32 [E] f32
//   tok = y Wt^T + bt                                           -> [d_out] bf16
//   per head h: a = tanh(y_h Wa_h^T + ba_h), g = sigmoid(y_h Wb_h^T + bb_h),
//     both with dropout; l_h = (a g) . wc_h + bc_h + mask bias  -> [nh] f32
//   softmax pool of y32 over each bag's tokens -> pooled [b, E] f32, (m, s);
//   with n_views = 3 (the intra-modality loss) also over two disjoint
//   half-bags, the same logits plus a view bias      -> pooled [b, 3, E]
// and, on the save route, the residuals the backward reads instead of
// recomputing any product: u1, u2, u3 (normalised pre-affine LN inputs),
// a_pre, b_pre (bf16) and the three LN rstd (f32), the columns of
// encoder_train.py:218-226. On the recompute route (save_acts off: their
// pointers null) nothing but the outputs outlives the call, and K7 rebuilds
// the residuals with this kernel's own device code (encoder_rows.cuh).
//
// Numerics as on the TPU: bf16 operands, f32 accumulation, f32 bias, LN and
// GELU; each layer's output is rounded to bf16 before the next product and
// the pool sums f32 y32. Dropout: Philox masks (philox.cuh), keyed by site.
// With f32 operands (encoder_train_forward_f32, the JAX package's parity
// route, encoder_train.py:133,323): the same sequence of launches with every
// operand, residual and token output in f32, nothing rounded between layers,
// exact tanh and sigmoid in the gates, and every product on gemm_tf32.cuh's
// split-TF32 wgmma GEMM (three TF32 terms a product, each 32-deep k tile a
// fresh partial added in k order to nearest; the gate epilogue's logit
// partials each thread's 16 columns in order, then the quad in xor order),
// the weights split into TF32 hi and lo once a call (t32::split_weights).
// y is y32 there: the gates and the token projector read it from the f32
// scratch Z. The first f32 design ran the products on gemm_ffma.cuh's FFMA
// tiles (no tensor cores), 47% of FP32's 67 TFLOP/s.
//
// What bounds it on an H100: 3.93 M multiply-adds per token at the published
// widths (7.86 MFLOP) against ~16 KB of traffic per token (x in; residuals,
// tokens and logits out): the 989 TFLOP/s of dense bf16 bounds it; with f32
// operands three TF32 terms of the same work at 495 TFLOP/s.
//
// Design. PR 3's first version ran every product on the mma.sync GEMM of
// gemm_bf16.cuh (128 x 128 tiles, a 3-stage cp.async ring) at about 165
// TFLOP/s, and sent the gate products through device memory in f32 (G [M,
// nh 2f], 2.2 GB at the step's call shape) only for a row kernel to form the
// logits. Now:
//   - every product runs on the TMA + wgmma GEMM of gemm_wgmma.cuh (one
//     producer thread, two ping-pong consumer warpgroups, a 4-stage ring,
//     one persistent block per SM): the three layers with f32 output and
//     bias into an f32 scratch row block, the token projector as kernel 19's
//     instantiation (bf16 output);
//   - a row kernel (one row per block) takes each layer's LayerNorm
//     statistics over the whole row (2048 columns for layer 3, which is why
//     K1 runs that layer twice; here the row is in memory anyway), applies
//     GELU and dropout, and writes the residuals and the next product's bf16
//     operand; layer 3 writes y32 back into the scratch in place;
//   - the gate products of all heads run as one batched launch whose
//     epilogue is the gate itself (gemm_wgmma.cuh::epilogue_gates): the
//     wrapper permutes [Wa; Wb]'s rows so that each 128-column tile holds 64
//     tanh and the same 64 sigmoid columns, the epilogue writes a_pre and
//     b_pre in bf16, applies the gate dropout (the keys of gated_logits'
//     row kernel) and writes one partial logit per 64 columns; gate_logits_sum
//     adds the partials in chunk order, bc and the mask bias. G is gone;
//   - the pool splits each bag into 64-token tiles whose (m, s, w) partials
//     are merged in tile order, as pool_combine.cuh does; with three views
//     (encoder_train.py:228-249) each tile reads y32 once into three
//     accumulators, and the merge runs once per view.
// No atomics anywhere: launches are bitwise reproducible. The layer stack is
// train_rows.cuh's, shared with the first design of the per-op kernel 15
// (kept as a check); gate_logits_sum is shared with the per-op kernel 17.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "encoder_rows.cuh"

namespace {

using madeleine::bf16;
using madeleine::Dropout;

constexpr int POOL_TM = 64;

// Grid (ntiles, b), 256 threads: per (bag, 64-token tile, view, head) the
// partial softmax-pool state m, s, w[e] of the tile's unmasked tokens of the
// view. View 0 is the whole bag; with NV = 3, views 1 and 2 re-softmax the
// same logits plus the view bias vb [t, 2] (0 inside the view, -1e30
// outside, shared by every bag). y32 is read once for all views.
template <int NV>
__global__ void pool_partial(const float* __restrict__ l, const float* __restrict__ vb,
                             const float* __restrict__ y32, float* __restrict__ part_m,
                             float* __restrict__ part_s, float* __restrict__ part_w, int t,
                             int nh, int e) {
  __shared__ float p_s[NV][POOL_TM];
  const int tile = blockIdx.x, bi = blockIdx.y, ntiles = gridDim.x;
  const int tok0 = tile * POOL_TM, rows = min(POOL_TM, t - tok0);
  const int tid = threadIdx.x, lane = tid & 31, E = nh * e;
  const long long r0 = (long long)bi * t + tok0;
  const long long pbase = ((long long)bi * ntiles + tile) * NV;
  for (int h = 0; h < nh; ++h) {
    if (tid < 32) {
      const float l0 = lane < rows ? l[(r0 + lane) * nh + h] : -INFINITY;
      const float l1 = lane + 32 < rows ? l[(r0 + lane + 32) * nh + h] : -INFINITY;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float lv0 = l0, lv1 = l1;
        if (v > 0) {
          if (lane < rows) lv0 += vb[(long long)(tok0 + lane) * 2 + v - 1];
          if (lane + 32 < rows) lv1 += vb[(long long)(tok0 + lane + 32) * 2 + v - 1];
        }
        const bool v0 = lv0 > madeleine::TRAIN_MASKED, v1 = lv1 > madeleine::TRAIN_MASKED;
        float m = fmaxf(v0 ? lv0 : -INFINITY, v1 ? lv1 : -INFINITY);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const float p0 = v0 ? expf(lv0 - m) : 0.f, p1 = v1 ? expf(lv1 - m) : 0.f;
        p_s[v][lane] = p0;
        p_s[v][lane + 32] = p1;
        const float s = madeleine::warp_sum(p0 + p1);
        if (lane == 0) {
          part_m[(pbase + v) * nh + h] = m;
          part_s[(pbase + v) * nh + h] = s;
        }
      }
    }
    __syncthreads();
    float* pw = part_w + pbase * E + (long long)h * e;
    for (int c = tid; c < e; c += blockDim.x) {
      float w[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) w[v] = 0.f;
      for (int i = 0; i < rows; ++i) {
        const float y = y32[(r0 + i) * E + h * e + c];
#pragma unroll
        for (int v = 0; v < NV; ++v) w[v] = fmaf(p_s[v][i], y, w[v]);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) pw[(long long)v * E + c] = w[v];
    }
    __syncthreads();
  }
}

// Grid (ceil(E/256), b, nv): merge the tile partials of one view in tile
// order -> pooled [b, nv, E] f32 and per (bag, view, head) m and s = max(S,
// 1e-30). A view without an unmasked token pools to 0 (m = -inf).
__global__ void pool_merge(const float* __restrict__ part_m, const float* __restrict__ part_s,
                           const float* __restrict__ part_w, float* __restrict__ pooled,
                           float* __restrict__ m_out, float* __restrict__ s_out, int ntiles,
                           int nh, int e) {
  const int bi = blockIdx.y, v = blockIdx.z, nv = gridDim.z, E = nh * e;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= E) return;
  const int h = c / e;
  const long long bv = (long long)bi * nv + v;
  const float* pm = part_m + ((long long)bi * ntiles * nv + v) * nh + h;
  const float* ps = part_s + ((long long)bi * ntiles * nv + v) * nh + h;
  const float* pw = part_w + ((long long)bi * ntiles * nv + v) * E + c;
  const long long sm = (long long)nv * nh, sw = (long long)nv * E;
  float M = -INFINITY;
  for (int i = 0; i < ntiles; ++i) M = fmaxf(M, pm[i * sm]);
  float S = 0.f, Wt = 0.f;
  if (M != -INFINITY) {
    for (int i = 0; i < ntiles; ++i) {
      const float a = expf(pm[i * sm] - M);
      S = fmaf(ps[i * sm], a, S);
      Wt = fmaf(pw[i * sw], a, Wt);
    }
  }
  const float Sc = fmaxf(S, 1e-30f);
  pooled[bv * E + c] = M == -INFINITY ? 0.f : Wt / Sc;
  if (c % e == 0) {
    m_out[bv * nh + h] = M;
    s_out[bv * nh + h] = Sc;
  }
}

}  // namespace

namespace {

// dims: b, t, d_in, hidden, nh, e, f, d_out, seed, row_offset, thr_pre, thr_gate,
// nv (1, or 3 with the view bias). scales: keep scales of the two rates. p: the
// pointers of ops/encoder_train.py::encoder_train_fwd_cuda's `tensors`, in that
// order (the residuals u1, u2, u3, a_pre, b_pre and rstd all null on the
// recompute route; the last, the view bias [t, 2], null when nv = 1; Y null
// in f32; then, f32 only, the split workspace of encoder_train_fwd_workspace_f32).
// T: the operands' type. Returns a cudaError_t.
template <typename T>
int forward(void** p, const long long* dims, const float* scales, void* stream_) {
  constexpr bool F32 = sizeof(T) == 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  // rows and global bag indices are 32-bit below (every offset is 64-bit):
  // a larger call runs in blocks of whole bags (ops/encoder_train.py)
  if (!madeleine::rows_fit(dims[0], dims[1], dims[9]))
    return (int)cudaErrorInvalidValue;
  const int b = (int)dims[0], t = (int)dims[1], d_in = (int)dims[2], hd = (int)dims[3];
  const int nh = (int)dims[4], e = (int)dims[5], f = (int)dims[6], dout = (int)dims[7];
  const Dropout dpre{(uint32_t)dims[8], (uint32_t)dims[10], scales[0]};
  const Dropout dgate{(uint32_t)dims[8], (uint32_t)dims[11], scales[1]};
  const int row_offset = (int)dims[9], nv = (int)dims[12];
  const int M = b * t, E = nh * e;
  const T* x = (const T*)p[0];
  const float* bias = (const float*)p[1];
  const T *w1 = (const T*)p[2], *w2 = (const T*)p[6], *w3 = (const T*)p[10];
  const float *b1 = (const float*)p[3], *s1 = (const float*)p[4], *t1 = (const float*)p[5];
  const float *b2 = (const float*)p[7], *s2 = (const float*)p[8], *t2 = (const float*)p[9];
  const float *b3 = (const float*)p[11], *s3 = (const float*)p[12], *t3 = (const float*)p[13];
  const T* wab = (const T*)p[14];   // rows permuted per head (ops/encoder_train.py)
  const float *bab = (const float*)p[15], *wc = (const float*)p[16], *bc = (const float*)p[17];
  const T* wt = (const T*)p[18];
  const float* bt = (const float*)p[19];
  float *pooled = (float*)p[20], *m_out = (float*)p[21], *s_out = (float*)p[22];
  T* tok = (T*)p[23];
  float* l = (float*)p[24];
  T *u1 = (T*)p[25], *u2 = (T*)p[26], *u3 = (T*)p[27];
  T *ap = (T*)p[28], *bp = (T*)p[29];
  float* rstd = (float*)p[30];
  float* Z = (float*)p[31];
  T *H1 = (T*)p[32], *H2 = (T*)p[33], *Y = (T*)p[34];   // Y null in f32: y = y32, in Z
  float* lpart = (float*)p[35];   // [M, nh, f / 64] partial logits
  float *part_m = (float*)p[36], *part_s = (float*)p[37], *part_w = (float*)p[38];
  const float* vb = (const float*)p[39];   // [t, 2] view bias, null when nv = 1
  if (nv != 1 && (nv != 3 || vb == nullptr)) return (int)cudaErrorInvalidValue;
  if ((Y == nullptr) != F32) return (int)cudaErrorInvalidValue;
  const bool save = u1 != nullptr;   // every residual set, or none
  if ((u2 != nullptr) != save || (u3 != nullptr) != save || (ap != nullptr) != save ||
      (bp != nullptr) != save || (rstd != nullptr) != save)
    return (int)cudaErrorInvalidValue;
  // the products' weight operands: as stored (bf16), or split into TF32 hi
  // and lo as stored (f32)
  const T *w1p = w1, *w2p = w2, *w3p = w3, *wabp = wab, *wtp = wt;
  if constexpr (F32) {
    madeleine::SplitFwd sp;
    const cudaError_t e2 = madeleine::split_fwd(w1, w2, w3, wab, wt, (float*)p[40], d_in, hd, E,
                                                nh, e, f, dout, sp, st);
    if (e2 != cudaSuccess) return (int)e2;
    w1p = sp.w1; w2p = sp.w2; w3p = sp.w3; wabp = sp.wab; wtp = sp.wt;
  }
  // pre-attention layers: Z = A W^T + bias, then LN / GELU / dropout rows;
  // layer 3 leaves y32 in Z for the pool; then the gate products of every
  // head, the gates and their partial logits in the epilogue
  madeleine::RowsFwdT<T> rf{};
  madeleine::StackFwdT<T>& sf = rf.sf;
  sf.x = x;
  sf.w[0] = w1p; sf.w[1] = w2p; sf.w[2] = w3p;
  sf.b[0] = b1; sf.b[1] = b2; sf.b[2] = b3;
  sf.s[0] = s1; sf.s[1] = s2; sf.s[2] = s3;
  sf.sh[0] = t1; sf.sh[1] = t2; sf.sh[2] = t3;
  sf.Z = Z;
  sf.U[0] = u1; sf.U[1] = u2; sf.U[2] = u3;
  sf.rstd = rstd;
  sf.H[0] = H1; sf.H[1] = H2; sf.H[2] = Y;
  sf.M = M; sf.t = t; sf.d_in = d_in; sf.hd = hd; sf.E = E; sf.row_offset = row_offset;
  sf.y32 = 1;
  sf.d = dpre;
  rf.wab = wabp; rf.bab = bab; rf.wc = wc;
  rf.ap = ap; rf.bp = bp; rf.lpart = lpart;
  rf.nh = nh; rf.e = e; rf.f = f;
  rf.dgate = dgate;
  cudaError_t err = madeleine::rows_fwd(rf, st);
  if (err != cudaSuccess) return (int)err;
  madeleine::gate_logits_sum<<<(unsigned)(((long long)M * nh + 255) / 256), 256, 0, st>>>(
      lpart, bc, bias, l, M, nh, f / 64);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // token projector: kernel 19's product (f32: on the split-TF32 GEMM, from y32)
  if constexpr (F32)
    err = madeleine::t32::linear(Z, wtp, bt, tok, M, dout, E, st);
  else
    err = madeleine::gemm_tn_wgmma(Y, wt, bt, tok, M, dout, E, st);
  if (err != cudaSuccess) return (int)err;
  // softmax pool of y32 (in Z)
  const int ntiles = (t + POOL_TM - 1) / POOL_TM;
  if (nv == 1)
    pool_partial<1><<<dim3(ntiles, b), 256, 0, st>>>(l, vb, Z, part_m, part_s, part_w, t, nh, e);
  else
    pool_partial<3><<<dim3(ntiles, b), 256, 0, st>>>(l, vb, Z, part_m, part_s, part_w, t, nh, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pool_merge<<<dim3((E + 255) / 256, b, nv), 256, 0, st>>>(part_m, part_s, part_w, pooled,
                                                           m_out, s_out, ntiles, nh, e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int encoder_train_forward(void** p, const long long* dims, const float* scales,
                                     void* stream) {
  return forward<bf16>(p, dims, scales, stream);
}

// The same with f32 operands, residuals and tokens (x, the weight matrices,
// u1-u3, a_pre, b_pre, tok; Y null).
extern "C" int encoder_train_forward_f32(void** p, const long long* dims, const float* scales,
                                         void* stream) {
  return forward<float>(p, dims, scales, stream);
}

// Floats of K6's f32 workspace: out[0] the weights split into TF32 hi and
// lo (encoder_rows.cuh::split_fwd), out[1] 0.
extern "C" void encoder_train_fwd_workspace_f32(const long long* dims, long long* out) {
  const int d_in = (int)dims[2], hd = (int)dims[3], nh = (int)dims[4], e = (int)dims[5];
  const int f = (int)dims[6], dout = (int)dims[7];
  out[0] = madeleine::split_fwd_floats(d_in, hd, nh * e, nh, e, f, dout);
  out[1] = 0;
}

// The piece length (tokens) of a weight gradient [Mo, No] over `tokens` x
// `batches`: K6 / K7 with f32 operands (gemm_tf32.cuh::wgrad_chunk), and the
// per-op kernels 15-18 with f32 operands (gemm_ffma.cuh::wgrad_chunk);
// ops/encoder_train.py's tf32_wgrad_chunk and ffma_wgrad_chunk mirror them.
extern "C" int encoder_train_tf32_wgrad_chunk(int Mo, int No, int tokens, int batches) {
  return madeleine::t32::wgrad_chunk(Mo, No, tokens, batches);
}

extern "C" int encoder_train_ffma_wgrad_chunk(int Mo, int No, int tokens, int batches) {
  return madeleine::ff::wgrad_chunk(Mo, No, tokens, batches);
}

extern "C" int encoder_train_pool_tile() { return POOL_TM; }
