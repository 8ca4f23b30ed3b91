// Whole-encoder fused forward in bf16 (kernel K1).
//
// Replaces madeleine_tpu/ops/encode_fused.py::_encode_kernel. Per token:
//   x -> [Linear -> LN -> GELU] x2 -> [Linear 512->nh*512 -> LN -> GELU] = y32
//   gates per head on bf16(y32): tanh(y_h Wa_h^T + ba) * sigmoid(y_h Wb_h^T + bb)
//   logit_h = gates . wc_h + bc_h + mask bias;  softmax pool of y32 over tokens
// Cast points as on the TPU (encode_fused.py:142-191): bf16 operands, f32
// accumulation, f32 bias / LayerNorm (eps 1e-5) / exact-erf GELU, each layer's
// output rounded to bf16 before the next product; the pool sums f32 y32.
//
// What bounds it on an H100: matrix products, 7.34 MFLOP per token at the
// published widths (d_in = hidden = attention = 512, 4 heads), against 1 KB of
// input per token: far above the card's ~295 FLOP/byte ridge, so the bound is
// the 989 TFLOP/s of dense bf16 tensor cores.
//
// Design:
// - Tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate). Each
//   k16 step reads 4 consecutive k per thread for both operands (a k
//   permutation inside the step that A and B share), so A comes from shared
//   memory and B straight from global/L2 as 8-byte loads in the weights'
//   own [out, in] layout, without a staging copy.
// - One block = 64 tokens of one bag (4 m16 tiles), 8 warps. Each weight
//   element is read once per block, by one warp; the 7 MB of bf16 weights
//   stay resident in the 50 MB L2 and are re-read by every token tile, so a
//   larger tile would cut L2 traffic but the activations must fit in the
//   block's 227 KB of shared memory.
// - Tile choice: 64 tokens. The block keeps three activation buffers in
//   shared memory: x/h1 (bf16, aliased later by y32), h2 (bf16 [64, 512]) and
//   one head's y32 (f32 [64, 512], 132 KB). 64 is the largest multiple of the
//   m16 tile for which that fits (about 206 KB at d_in = 512); a whole
//   [64, 2048] pre-LN row block would need 512 KB in f32.
// - LN3 needs statistics over all nh*512 columns of a row, but only one head's
//   columns fit. So layer 3 runs twice: a first pass computes each head's
//   512 columns in registers and merges per-row (mean, M2) across heads with
//   Chan's formula; a second pass recomputes each head's columns, normalises
//   them with the merged statistics, and feeds that head's gates and pool.
//   This costs 1 M extra multiply-adds per token (+29% of the work) instead
//   of a round trip of 8 KB per token through device memory.
// - Split-token reduction: the TPU carries (m, s, w) across token blocks in
//   its sequential grid; here every (bag, tile) block writes its per-head
//   partial state and pool_combine.cuh merges the tiles in index order
//   (deterministic, no atomics). Rows past t are zero-filled on load and
//   excluded from the pool. A tile whose tokens are all masked is skipped
//   outright, so the serving path's bucket and power-of-two batch padding
//   costs almost no device time; a bag with no unmasked token pools to 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_combine.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 64;            // tokens per block
constexpr int HID = 512;          // hidden width e and attention width f
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int SB = HID + 16;      // bf16 row stride of h1/h2 (264 words: 8 mod 32)
constexpr int SY = HID + 16;      // f32 row stride of y32 (528 words: 16 mod 32)
constexpr float LN_EPS = 1e-5f;

// bf16 row stride of the x tile: d_in rounded up to 64, plus 16 (8 mod 32 words)
__host__ __device__ constexpr int x_stride(int d_in) { return (d_in + 63) / 64 * 64 + 16; }

struct Smem {
  size_t y32, h1, h2, red, stat, total;
};

__host__ __device__ inline Smem smem_layout(int d_in) {
  Smem L;
  const size_t sx = x_stride(d_in);
  const size_t xh1 = (size_t)TM * (sx + SB) * sizeof(bf16);      // x then h1
  const size_t y32 = (size_t)TM * SY * sizeof(float);            // aliases x and h1
  const size_t r1 = xh1 > y32 ? xh1 : y32;
  L.y32 = 0;
  L.h1 = (size_t)TM * sx * sizeof(bf16);
  L.h2 = r1;
  L.red = L.h2 + (size_t)TM * SB * sizeof(bf16);
  L.stat = L.red + (size_t)NWARPS * TM * sizeof(float);
  L.total = L.stat + 6 * TM * sizeof(float);
  return L;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Fragment map of mma.m16n8k16 (lane = 4 * g + q):
//   A: a0 (row g, k 2q..2q+1), a1 (row g+8, same k), a2 (row g, k 2q+8..),
//      a3 (row g+8, k 2q+8..);  B: b0 (k 2q.., col g), b1 (k 2q+8.., col g);
//   C: c0,c1 (row g, cols 2q, 2q+1), c2,c3 (row g+8, same cols).
// Within each k16 step, logical k {2q, 2q+1, 2q+8, 2q+9} is read from
// physical k {4q, .., 4q+3} for both A and B: the sum over k is unchanged,
// and every operand read is 4 consecutive elements.

// acc[mt][nt] += A[64 x K] (bf16 smem, row stride sa) . B[N x K]^T, where B
// (bf16 global, row stride ldb) is already offset to this warp's first column.
template <int NT>
__device__ __forceinline__ void gemm_bf16(float (&acc)[4][NT][4], const bf16* As, int sa,
                                          const bf16* __restrict__ B, int ldb, int K, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
  const bf16* ap = As + g * sa + q * 4;
  const bf16* bp = B + (size_t)g * ldb + q * 4;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint2 v0 = *reinterpret_cast<const uint2*>(ap + (mt * 16) * sa + k0);
      const uint2 v1 = *reinterpret_cast<const uint2*>(ap + (mt * 16 + 8) * sa + k0);
      a[mt][0] = v0.x; a[mt][1] = v1.x; a[mt][2] = v0.y; a[mt][3] = v1.y;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 bv = __ldg(reinterpret_cast<const uint2*>(bp + (size_t)(nt * 8) * ldb + k0));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], bv.x, bv.y);
    }
  }
}

// Gate products for one head: A = bf16(y32) read from f32 smem, B = Wa and Wb.
template <int NT>
__device__ __forceinline__ void gemm_gates(float (&acc_a)[4][NT][4], float (&acc_b)[4][NT][4],
                                           const float* Ys, const bf16* __restrict__ Wa,
                                           const bf16* __restrict__ Wb, int K, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_a[mt][nt][j] = acc_b[mt][nt][j] = 0.f;
  const float* yp = Ys + g * SY + q * 4;
  const bf16* pa = Wa + (size_t)g * K + q * 4;
  const bf16* pb = Wb + (size_t)g * K + q * 4;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float4 v0 = *reinterpret_cast<const float4*>(yp + (mt * 16) * SY + k0);
      const float4 v1 = *reinterpret_cast<const float4*>(yp + (mt * 16 + 8) * SY + k0);
      a[mt][0] = pack_bf16(v0.x, v0.y); a[mt][1] = pack_bf16(v1.x, v1.y);
      a[mt][2] = pack_bf16(v0.z, v0.w); a[mt][3] = pack_bf16(v1.z, v1.w);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 av = __ldg(reinterpret_cast<const uint2*>(pa + (size_t)(nt * 8) * K + k0));
      const uint2 bv = __ldg(reinterpret_cast<const uint2*>(pb + (size_t)(nt * 8) * K + k0));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        mma_bf16(acc_a[mt][nt], a[mt], av.x, av.y);
        mma_bf16(acc_b[mt][nt], a[mt], bv.x, bv.y);
      }
    }
  }
}

// Sum per-row partials v[mt * 2 + half] (row mt*16 + g + 8*half) over the 4
// lanes of a quad, then write the warp's sum to red[warp][row].
__device__ __forceinline__ void warp_rows_to_smem(float (&v)[8], float* red, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
  }
  if (q == 0) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      red[warp * TM + mt * 16 + g] = v[mt * 2];
      red[warp * TM + mt * 16 + g + 8] = v[mt * 2 + 1];
    }
  }
}

// Row statistics of a [64 x 512] chunk held as acc[4][8][4] across the 8 warps
// (warp w owns columns 64w..64w+63): mean -> mean_s[row], sum of squared
// deviations -> m2_s[row]. Ends synchronised.
__device__ __forceinline__ void chunk_row_stats(const float (&acc)[4][8][4], float* red,
                                                float* mean_s, float* m2_s, int warp, int lane,
                                                int tid) {
  const int g = lane >> 2;
  float v[8];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s0 += acc[mt][nt][0] + acc[mt][nt][1];
      s1 += acc[mt][nt][2] + acc[mt][nt][3];
    }
    v[mt * 2] = s0;
    v[mt * 2 + 1] = s1;
  }
  warp_rows_to_smem(v, red, warp, lane);
  __syncthreads();
  if (tid < TM) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w * TM + tid];
    mean_s[tid] = s * (1.f / HID);
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const float m0 = mean_s[mt * 16 + g], m1 = mean_s[mt * 16 + g + 8];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float d0 = acc[mt][nt][0] - m0, d1 = acc[mt][nt][1] - m0;
      const float d2 = acc[mt][nt][2] - m1, d3 = acc[mt][nt][3] - m1;
      s0 += d0 * d0 + d1 * d1;
      s1 += d2 * d2 + d3 * d3;
    }
    v[mt * 2] = s0;
    v[mt * 2 + 1] = s1;
  }
  warp_rows_to_smem(v, red, warp, lane);
  __syncthreads();
  if (tid < TM) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w * TM + tid];
    m2_s[tid] = s;
  }
  __syncthreads();
}

// acc += bias over this warp's columns (col0 = 64 * warp).
__device__ __forceinline__ void add_bias(float (&acc)[4][8][4], const float* __restrict__ bias,
                                         int col0, int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = col0 + nt * 8 + q * 2;
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      acc[mt][nt][0] += b0; acc[mt][nt][1] += b1;
      acc[mt][nt][2] += b0; acc[mt][nt][3] += b1;
    }
  }
}

// One pre-attention layer of width 512: Hout = bf16(GELU(LN(A . W^T + b))).
__device__ __forceinline__ void mlp_layer(const bf16* As, int sa, int K, const bf16* __restrict__ W,
                                          const float* __restrict__ b,
                                          const float* __restrict__ s,
                                          const float* __restrict__ sh, bf16* Hout, float* red,
                                          float* mean_s, float* m2_s, int warp, int lane,
                                          int tid) {
  const int g = lane >> 2, q = lane & 3;
  float acc[4][8][4];
  gemm_bf16<8>(acc, As, sa, W + (size_t)(warp * 64) * K, K, K, lane);
  add_bias(acc, b, warp * 64, lane);
  chunk_row_stats(acc, red, mean_s, m2_s, warp, lane, tid);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      const float mean = mean_s[r], rstd = rsqrtf(m2_s[r] * (1.f / HID) + LN_EPS);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = warp * 64 + nt * 8 + q * 2;
        const float v0 = gelu((acc[mt][nt][2 * half] - mean) * rstd * s[c] + sh[c]);
        const float v1 = gelu((acc[mt][nt][2 * half + 1] - mean) * rstd * s[c + 1] + sh[c + 1]);
        *reinterpret_cast<__nv_bfloat162*>(Hout + r * SB + c) = __floats2bfloat162_rn(v0, v1);
      }
    }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
encode_partial(const bf16* __restrict__ x, const float* __restrict__ bias,
               const bf16* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ s1, const float* __restrict__ t1,
               const bf16* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ s2, const float* __restrict__ t2,
               const bf16* __restrict__ w3, const float* __restrict__ b3,
               const float* __restrict__ s3, const float* __restrict__ t3,
               const bf16* __restrict__ wa, const float* __restrict__ ba,
               const bf16* __restrict__ wb, const float* __restrict__ bb,
               const float* __restrict__ wc, const float* __restrict__ bc,
               float* __restrict__ part_m, float* __restrict__ part_s,
               float* __restrict__ part_w, int t, int d_in, int nh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(d_in);
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* H1 = reinterpret_cast<bf16*>(smem + L.h1);
  bf16* H2 = reinterpret_cast<bf16*>(smem + L.h2);
  float* Y32 = reinterpret_cast<float*>(smem + L.y32);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* mean_s = reinterpret_cast<float*>(smem + L.stat);
  float* m2_s = mean_s + TM;
  float* mean3_s = m2_s + TM;
  float* rstd3_s = mean3_s + TM;
  float* logit_s = rstd3_s + TM;
  float* p_s = logit_s + TM;

  const int tile = blockIdx.x, bi = blockIdx.y, ntiles = gridDim.x;
  const int tok0 = tile * TM;
  const int rows = min(TM, t - tok0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int sx = x_stride(d_in);
  const int E = nh * HID;

  // a tile with no unmasked token in any head adds nothing: skip its work
  {
    int live = 0;
    const float* tb = bias + ((size_t)bi * t + tok0) * nh;
    for (int i = tid; i < rows * nh; i += THREADS) live |= tb[i] > madeleine::MASKED_BIAS;
    if (!__syncthreads_or(live)) {
      for (int h = 0; h < nh; ++h) {
        const size_t pidx = ((size_t)bi * ntiles + tile) * nh + h;
        madeleine::write_empty_partial(part_m + pidx, part_s + pidx,
                                       part_w + ((size_t)bi * ntiles + tile) * E + h * HID,
                                       HID, tid, THREADS);
      }
      return;
    }
  }

  // ---- x tile -> shared memory (rows past t are zeros) ----
  {
    const bf16* xb = x + ((size_t)bi * t + tok0) * d_in;
    const int vpr = d_in / 8;  // 16-byte vectors per row
    for (int i = tid; i < TM * vpr; i += THREADS) {
      const int r = i / vpr, c = (i - r * vpr) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) v = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)r * d_in + c));
      *reinterpret_cast<uint4*>(X + r * sx + c) = v;
    }
  }
  __syncthreads();

  // ---- layers 1 and 2 ----
  mlp_layer(X, sx, d_in, w1, b1, s1, t1, H1, red, mean_s, m2_s, warp, lane, tid);
  mlp_layer(H1, SB, HID, w2, b2, s2, t2, H2, red, mean_s, m2_s, warp, lane, tid);

  // ---- layer 3, pass 1: LN3 row statistics over all nh heads (Chan merge) ----
  float run_mean = 0.f, run_m2 = 0.f;  // meaningful in threads tid < TM
  for (int h = 0; h < nh; ++h) {
    float acc[4][8][4];
    gemm_bf16<8>(acc, H2, SB, w3 + (size_t)(h * HID + warp * 64) * HID, HID, HID, lane);
    add_bias(acc, b3 + h * HID, warp * 64, lane);
    chunk_row_stats(acc, red, mean_s, m2_s, warp, lane, tid);
    if (tid < TM) {
      const float mb = mean_s[tid], m2b = m2_s[tid];
      if (h == 0) {
        run_mean = mb;
        run_m2 = m2b;
      } else {
        const float na = (float)(h * HID), nb = (float)HID, n = na + nb;
        const float d = mb - run_mean;
        run_mean += d * (nb / n);
        run_m2 += m2b + d * d * (na * nb / n);
      }
    }
  }
  if (tid < TM) {
    mean3_s[tid] = run_mean;
    rstd3_s[tid] = rsqrtf(run_m2 / (float)E + LN_EPS);
  }
  __syncthreads();

  // ---- per head: layer 3 again -> y32, gates -> logits, tile softmax pool ----
  for (int h = 0; h < nh; ++h) {
    {
      float acc[4][8][4];
      gemm_bf16<8>(acc, H2, SB, w3 + (size_t)(h * HID + warp * 64) * HID, HID, HID, lane);
      __syncthreads();  // the previous head's pool has finished reading Y32
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          const float mean = mean3_s[r], rstd = rstd3_s[r];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int c = warp * 64 + nt * 8 + q * 2;
            const int cg = h * HID + c;
            const float z0 = acc[mt][nt][2 * half] + b3[cg];
            const float z1 = acc[mt][nt][2 * half + 1] + b3[cg + 1];
            float2 v;
            v.x = gelu((z0 - mean) * rstd * s3[cg] + t3[cg]);
            v.y = gelu((z1 - mean) * rstd * s3[cg + 1] + t3[cg + 1]);
            *reinterpret_cast<float2*>(Y32 + r * SY + c) = v;
          }
        }
    }
    __syncthreads();

    float lp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) lp[i] = 0.f;
    const bf16* wah = wa + (size_t)h * HID * HID;
    const bf16* wbh = wb + (size_t)h * HID * HID;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int n0 = pass * 256 + warp * 32;
      float acc_a[4][4][4], acc_b[4][4][4];
      gemm_gates<4>(acc_a, acc_b, Y32, wah + (size_t)n0 * HID, wbh + (size_t)n0 * HID, HID,
                    lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = h * HID + n0 + nt * 8 + q * 2 + (j & 1);
          const float bav = ba[c], bbv = bb[c], wcv = wc[c];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const float av = tanhf(acc_a[mt][nt][j] + bav);
            const float sv = 1.f / (1.f + expf(-(acc_b[mt][nt][j] + bbv)));
            lp[mt * 2 + (j >> 1)] += av * sv * wcv;
          }
        }
    }
    warp_rows_to_smem(lp, red, warp, lane);
    __syncthreads();
    if (tid < TM) {
      float l = bc[h];
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) l += red[w * TM + tid];
      if (tid < rows) l += bias[((size_t)bi * t + tok0 + tid) * nh + h];
      logit_s[tid] = l;
    }
    __syncthreads();

    if (warp == 0) {
      const float l0 = lane < rows ? logit_s[lane] : -INFINITY;
      const float l1 = lane + 32 < rows ? logit_s[lane + 32] : -INFINITY;
      float m = fmaxf(l0, l1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float p0 = lane < rows ? expf(l0 - m) : 0.f;
      const float p1 = lane + 32 < rows ? expf(l1 - m) : 0.f;
      p_s[lane] = p0;
      p_s[lane + 32] = p1;
      float s = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        part_m[((size_t)bi * ntiles + tile) * nh + h] = m;
        part_s[((size_t)bi * ntiles + tile) * nh + h] = s;
      }
    }
    __syncthreads();

    float* pw = part_w + ((size_t)bi * ntiles + tile) * E + (size_t)h * HID;
    for (int c = tid; c < HID; c += THREADS) {
      float w = 0.f;
      for (int r = 0; r < rows; ++r) w = fmaf(p_s[r], Y32[r * SY + c], w);
      pw[c] = w;
    }
  }
}

}  // namespace

extern "C" int encode_fused_tile_rows() { return TM; }

// Returns the cudaError_t of the launches (0 = success). Pointers are device
// pointers; shapes as in encode_fused.py::encode_fused_cuda (hidden and
// attention widths 512, d_in a multiple of 16). out is [b, nh*512] bf16.
extern "C" int encode_fused_forward(
    const bf16* x, const float* bias, const bf16* w1, const float* b1, const float* s1,
    const float* t1, const bf16* w2, const float* b2, const float* s2, const float* t2,
    const bf16* w3, const float* b3, const float* s3, const float* t3, const bf16* wa,
    const float* ba, const bf16* wb, const float* bb, const float* wc, const float* bc,
    float* part_m, float* part_s, float* part_w, bf16* out, int b, int t, int d_in, int nh,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (t + TM - 1) / TM;
  const size_t smem = smem_layout(d_in).total;
  cudaError_t err = cudaFuncSetAttribute(encode_partial,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  encode_partial<<<dim3(ntiles, b), THREADS, smem, s>>>(
      x, bias, w1, b1, s1, t1, w2, b2, s2, t2, w3, b3, s3, t3, wa, ba, wb, bb, wc, bc, part_m,
      part_s, part_w, t, d_in, nh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)madeleine::launch_pool_combine<bf16>(part_m, part_s, part_w, out, b, ntiles, nh,
                                                   HID, s);
}
