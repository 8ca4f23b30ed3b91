// Whole-encoder training forward in bf16 (kernel K6).
//
// Replaces madeleine_tpu/ops/encoder_train.py::_fwd_kernel (save_acts route).
// Per token row r of x [b*t, d_in]:
//   3 x [Linear -> LayerNorm -> GELU (exact erf) -> dropout]   -> y32 [E] f32
//   tok = y Wt^T + bt                                           -> [d_out] bf16
//   per head h: a = tanh(y_h Wa_h^T + ba_h), g = sigmoid(y_h Wb_h^T + bb_h),
//     both with dropout; l_h = (a g) . wc_h + bc_h + mask bias  -> [nh] f32
//   softmax pool of y32 over each bag's tokens -> pooled [b, E] f32, (m, s)
// and the residuals the backward reads instead of recomputing any product:
// u1, u2, u3 (normalised pre-affine LN inputs), a_pre, b_pre (bf16) and the
// three LN rstd (f32), the columns of encoder_train.py:218-226.
//
// Numerics as on the TPU: bf16 operands, f32 accumulation, f32 bias, LN and
// GELU; each layer's output is rounded to bf16 before the next product and
// the pool sums f32 y32. Dropout: Philox masks (philox.cuh), keyed by site.
//
// What bounds it on an H100: 3.93 M multiply-adds per token at the published
// widths (7.86 MFLOP) against ~16 KB of traffic per token (x in; residuals,
// tokens and logits out): the 989 TFLOP/s of dense bf16 bounds it.
//
// Design (simple first): a fixed sequence of launches of one tiled mma.sync
// GEMM (gemm_bf16.cuh) and row kernels. Each pre-LN product lands in an f32
// scratch row block; a row kernel (one row per block) takes its LayerNorm
// statistics over the whole row (2048 columns for layer 3, which is why K1
// runs that layer twice; here the row is in memory anyway), applies GELU and
// dropout, and writes the residuals and the next product's bf16 operand.
// Layer 3 writes y32 back into the scratch in place. The gate products of all
// heads run as one batched GEMM with tanh / sigmoid in the epilogue; a row
// kernel applies gate dropout and reduces to the logits. The pool splits each
// bag into 64-token tiles whose (m, s, w) partials are merged in tile order,
// as pool_combine.cuh does (no atomics: launches are bitwise reproducible).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"
#include "train_common.cuh"

namespace {

using madeleine::bf16;
using madeleine::Dropout;

constexpr int POOL_TM = 64;

// One row per block, W/4 threads, 4 columns each: LayerNorm + GELU + dropout.
// Z [M, W] f32 pre-LN rows (bias included). Writes U (bf16 u), rstd[r * 3 +
// layer], H (bf16 output) and, when y32 is set, the f32 output back into Z.
__global__ void ln_gelu_fwd(float* __restrict__ Z, const float* __restrict__ s,
                            const float* __restrict__ sh, bf16* __restrict__ U,
                            float* __restrict__ rstd, bf16* __restrict__ H, int W, int t,
                            int row_offset, int layer, Dropout d, int y32) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const int c = threadIdx.x * 4, nw = blockDim.x >> 5;
  float z[4];
  madeleine::load4(Z + r * W + c, z);
  const float mean = madeleine::group_sum(z[0] + z[1] + z[2] + z[3], red, 0, nw) / W;
  float dv = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) dv += (z[j] - mean) * (z[j] - mean);
  const float var = madeleine::group_sum(dv, red, 0, nw) / W;
  const float rs = rsqrtf(var + madeleine::TRAIN_LN_EPS);
  float k[4];
  madeleine::keep4(d, threadIdx.x, (int)(r % t), (int)(r / t) + row_offset, layer, k);
  float u[4], h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = (z[j] - mean) * rs;
    const float v = u[j] * s[c + j] + sh[c + j];
    h[j] = v * madeleine::gauss_cdf(v) * k[j];
  }
  madeleine::store4(U + r * W + c, u);
  madeleine::store4(H + r * W + c, h);
  if (y32) madeleine::store4(Z + r * W + c, h);
  if (threadIdx.x == 0) rstd[r * 3 + layer] = rs;
}

// One row per block, nh*f/4 threads (f % 128 == 0): gate dropout and logits.
// G [M, nh*2f] f32 holds per head [tanh branch | sigmoid branch]; writes
// l [M, nh] (with the mask bias), ap / bp [M, nh*f] bf16 (pre-dropout).
__global__ void gate_logits_fwd(const float* __restrict__ G, const float* __restrict__ wc,
                                const float* __restrict__ bc, const float* __restrict__ bias,
                                float* __restrict__ l, bf16* __restrict__ ap,
                                bf16* __restrict__ bp, int nh, int f, int t, int row_offset,
                                Dropout d) {
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const int tpb = f / 4, h = threadIdx.x / tpb, c4 = threadIdx.x % tpb, j0 = c4 * 4;
  const int tok = (int)(r % t), row = (int)(r / t) + row_offset;
  float a[4], g[4], ka[4], kb[4], w[4];
  madeleine::load4(G + r * nh * 2 * f + h * 2 * f + j0, a);
  madeleine::load4(G + r * nh * 2 * f + h * 2 * f + f + j0, g);
  madeleine::load4(wc + h * f + j0, w);
  madeleine::keep4(d, c4, tok, row, 3 + 2 * h, ka);
  madeleine::keep4(d, c4, tok, row, 4 + 2 * h, kb);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc += (a[j] * ka[j]) * (g[j] * kb[j]) * w[j];
  madeleine::store4(ap + r * nh * f + h * f + j0, a);
  madeleine::store4(bp + r * nh * f + h * f + j0, g);
  const int wph = tpb / 32;
  const float sum = madeleine::group_sum(acc, red, h * wph, wph);
  if (c4 == 0) l[r * nh + h] = sum + bc[h] + bias[r];
}

// Grid (ntiles, b), 256 threads: per (bag, 64-token tile, head) the partial
// softmax-pool state m, s, w[e] of the tile's unmasked tokens.
__global__ void pool_partial(const float* __restrict__ l, const float* __restrict__ y32,
                             float* __restrict__ part_m, float* __restrict__ part_s,
                             float* __restrict__ part_w, int t, int nh, int e) {
  __shared__ float p_s[POOL_TM];
  const int tile = blockIdx.x, bi = blockIdx.y, ntiles = gridDim.x;
  const int tok0 = tile * POOL_TM, rows = min(POOL_TM, t - tok0);
  const int tid = threadIdx.x, lane = tid & 31, E = nh * e;
  const long long r0 = (long long)bi * t + tok0;
  for (int h = 0; h < nh; ++h) {
    if (tid < 32) {
      const float l0 = lane < rows ? l[(r0 + lane) * nh + h] : -INFINITY;
      const float l1 = lane + 32 < rows ? l[(r0 + lane + 32) * nh + h] : -INFINITY;
      const bool v0 = l0 > madeleine::TRAIN_MASKED, v1 = l1 > madeleine::TRAIN_MASKED;
      float m = fmaxf(v0 ? l0 : -INFINITY, v1 ? l1 : -INFINITY);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float p0 = v0 ? expf(l0 - m) : 0.f, p1 = v1 ? expf(l1 - m) : 0.f;
      p_s[lane] = p0;
      p_s[lane + 32] = p1;
      const float s = madeleine::warp_sum(p0 + p1);
      if (lane == 0) {
        part_m[((long long)bi * ntiles + tile) * nh + h] = m;
        part_s[((long long)bi * ntiles + tile) * nh + h] = s;
      }
    }
    __syncthreads();
    float* pw = part_w + ((long long)bi * ntiles + tile) * E + (long long)h * e;
    for (int c = tid; c < e; c += blockDim.x) {
      float w = 0.f;
      for (int i = 0; i < rows; ++i) w = fmaf(p_s[i], y32[(r0 + i) * E + h * e + c], w);
      pw[c] = w;
    }
    __syncthreads();
  }
}

// Grid (ceil(E/256), b): merge the tile partials in tile order -> pooled
// [b, E] f32 and per (bag, head) m and s = max(S, 1e-30). A bag without an
// unmasked token pools to 0 (m = -inf).
__global__ void pool_merge(const float* __restrict__ part_m, const float* __restrict__ part_s,
                           const float* __restrict__ part_w, float* __restrict__ pooled,
                           float* __restrict__ m_out, float* __restrict__ s_out, int ntiles,
                           int nh, int e) {
  const int bi = blockIdx.y, E = nh * e;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= E) return;
  const int h = c / e;
  const float* pm = part_m + (long long)bi * ntiles * nh + h;
  const float* ps = part_s + (long long)bi * ntiles * nh + h;
  const float* pw = part_w + (long long)bi * ntiles * E + c;
  float M = -INFINITY;
  for (int i = 0; i < ntiles; ++i) M = fmaxf(M, pm[(long long)i * nh]);
  float S = 0.f, Wt = 0.f;
  if (M != -INFINITY) {
    for (int i = 0; i < ntiles; ++i) {
      const float a = expf(pm[(long long)i * nh] - M);
      S = fmaf(ps[(long long)i * nh], a, S);
      Wt = fmaf(pw[(long long)i * E], a, Wt);
    }
  }
  const float Sc = fmaxf(S, 1e-30f);
  pooled[(long long)bi * E + c] = M == -INFINITY ? 0.f : Wt / Sc;
  if (c % e == 0) {
    m_out[bi * nh + h] = M;
    s_out[bi * nh + h] = Sc;
  }
}

#define CHECK(x)                             \
  do {                                       \
    cudaError_t err_ = (x);                  \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

// dims: b, t, d_in, hidden, nh, e, f, d_out, seed, row_offset, thr_pre, thr_gate.
// scales: keep scales of the two rates. p: the pointers listed in
// ops/encoder_train.py::_FWD_PTRS, in that order. Returns a cudaError_t.
extern "C" int encoder_train_forward(void** p, const long long* dims, const float* scales,
                                     void* stream_) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const int b = (int)dims[0], t = (int)dims[1], d_in = (int)dims[2], hd = (int)dims[3];
  const int nh = (int)dims[4], e = (int)dims[5], f = (int)dims[6], dout = (int)dims[7];
  const Dropout dpre{(uint32_t)dims[8], (uint32_t)dims[10], scales[0]};
  const Dropout dgate{(uint32_t)dims[8], (uint32_t)dims[11], scales[1]};
  const int row_offset = (int)dims[9];
  const int M = b * t, E = nh * e;
  const bf16* x = (const bf16*)p[0];
  const float* bias = (const float*)p[1];
  const bf16 *w1 = (const bf16*)p[2], *w2 = (const bf16*)p[6], *w3 = (const bf16*)p[10];
  const float *b1 = (const float*)p[3], *s1 = (const float*)p[4], *t1 = (const float*)p[5];
  const float *b2 = (const float*)p[7], *s2 = (const float*)p[8], *t2 = (const float*)p[9];
  const float *b3 = (const float*)p[11], *s3 = (const float*)p[12], *t3 = (const float*)p[13];
  const bf16* wab = (const bf16*)p[14];
  const float *bab = (const float*)p[15], *wc = (const float*)p[16], *bc = (const float*)p[17];
  const bf16* wt = (const bf16*)p[18];
  const float* bt = (const float*)p[19];
  float *pooled = (float*)p[20], *m_out = (float*)p[21], *s_out = (float*)p[22];
  bf16* tok = (bf16*)p[23];
  float* l = (float*)p[24];
  bf16 *u1 = (bf16*)p[25], *u2 = (bf16*)p[26], *u3 = (bf16*)p[27];
  bf16 *ap = (bf16*)p[28], *bp = (bf16*)p[29];
  float* rstd = (float*)p[30];
  float* Z = (float*)p[31];
  bf16 *H1 = (bf16*)p[32], *H2 = (bf16*)p[33], *Y = (bf16*)p[34];
  float* G = (float*)p[35];
  float *part_m = (float*)p[36], *part_s = (float*)p[37], *part_w = (float*)p[38];
  using madeleine::GemmArgs;
  using madeleine::launch_gemm;

  // pre-attention layers: Z = A W^T + bias, then LN / GELU / dropout rows
  const bf16* Ain[3] = {x, H1, H2};
  const bf16* Wl[3] = {w1, w2, w3};
  const float* Bl[3] = {b1, b2, b3};
  const float* Sl[3] = {s1, s2, s3};
  const float* Tl[3] = {t1, t2, t3};
  bf16* Ul[3] = {u1, u2, u3};
  bf16* Hl[3] = {H1, H2, Y};
  const int Kl[3] = {d_in, hd, hd}, Nl[3] = {hd, hd, E};
  for (int i = 0; i < 3; ++i) {
    GemmArgs g{};
    g.A = Ain[i]; g.lda = Kl[i];
    g.B = Wl[i]; g.ldb = Kl[i];
    g.C = Z; g.ldc = Nl[i];
    g.bias = Bl[i];
    g.M = M; g.N = Nl[i]; g.K = Kl[i];
    g.splits = 1;
    CHECK((launch_gemm<true, true, float>(g, 1, st)));
    ln_gelu_fwd<<<M, Nl[i] / 4, 0, st>>>(Z, Sl[i], Tl[i], Ul[i], rstd, Hl[i], Nl[i], t,
                                          row_offset, i, dpre, i == 2);
    CHECK(cudaGetLastError());
  }
  // gate products of every head in one batched launch: G_h = act(y_h Wab_h^T + bab_h)
  {
    GemmArgs g{};
    g.A = Y; g.lda = E; g.strideA = e;
    g.B = wab; g.ldb = e; g.strideB = 2LL * f * e;
    g.C = G; g.ldc = 2LL * nh * f; g.strideC = 2LL * f;
    g.bias = bab; g.strideBias = 2LL * f;
    g.M = M; g.N = 2 * f; g.K = e;
    g.splits = 1;
    g.act = madeleine::ACT_GATES; g.act_split = f;
    CHECK((launch_gemm<true, true, float>(g, nh, st)));
  }
  gate_logits_fwd<<<M, nh * f / 4, 0, st>>>(G, wc, bc, bias, l, ap, bp, nh, f, t, row_offset,
                                             dgate);
  CHECK(cudaGetLastError());
  // token projector
  {
    GemmArgs g{};
    g.A = Y; g.lda = E;
    g.B = wt; g.ldb = E;
    g.C = tok; g.ldc = dout;
    g.bias = bt;
    g.M = M; g.N = dout; g.K = E;
    g.splits = 1;
    CHECK((launch_gemm<true, true, bf16>(g, 1, st)));
  }
  // softmax pool of y32 (in Z)
  const int ntiles = (t + POOL_TM - 1) / POOL_TM;
  pool_partial<<<dim3(ntiles, b), 256, 0, st>>>(l, Z, part_m, part_s, part_w, t, nh, e);
  CHECK(cudaGetLastError());
  pool_merge<<<dim3((E + 255) / 256, b), 256, 0, st>>>(part_m, part_s, part_w, pooled, m_out,
                                                       s_out, ntiles, nh, e);
  return (int)cudaGetLastError();
}

extern "C" int encoder_train_pool_tile() { return POOL_TM; }
