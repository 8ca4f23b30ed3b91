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
// Design (encode_fused_tiles_forward, the route every path takes): K6's
// forward machinery at dropout rate 0, over the bag's live 64-token tiles
// only.
// - Live tiles. A tile (bag, 64 tokens) is live when any of its tokens is
//   unmasked in any head (per-head masking stays in the logits). tile_flags
//   marks every tile slot and writes a dead slot's pool partials empty;
//   live_scan (one block, a fixed-order scan) lists the live slots in slot
//   order and writes, per chunk of `cap` list entries, its live row count.
//   That count stays on the device: every later kernel of the chunk reads it
//   (the wgmma GEMM's m_live, the row kernels' early return), so serving's
//   bucket and power-of-two batch padding costs almost no device time and
//   the host never reads a count back.
// - Per chunk: gather_tiles copies the live tiles' x rows into a compact
//   operand (rows past t zero-filled); the three layers run on the TMA +
//   wgmma GEMM of gemm_wgmma.cuh with f32 output and bias into a scratch
//   row block Z, each followed by a row kernel (ln_gelu_rows: a warp per
//   row, LN over the whole row, GELU, the bf16 operand of the next
//   product; no dropout, no residuals). Layer 3's 2048-column row is one
//   row of Z, so LN3 runs once, not twice as in the first design; it
//   leaves y32 in Z and bf16(y32) for the gates. The gate products of all
//   heads run as one batched EPI_GATES launch on K6's permuted [Wa; Wb]
//   (ops/encoder_train.py::permute_gates), writing only the per-64-column
//   logit partials; pool_tiles (a block per live tile and head) adds them
//   in chunk order with bc and the mask bias and writes the tile's
//   softmax-pool partial (m, s, w) into its slot, as the first design does.
// - pool_combine.cuh merges every slot's partials in tile order (no
//   atomics: two launches give bitwise-equal results). A bag with no
//   unmasked token pools to 0.
// - Scratch is bounded: a chunk holds at most `cap` live tiles (the wrapper's
//   row budget, ops/encode_fused.py::ROW_BUDGET), and one bf16 row block
//   holds in turn the compact x, h1, h2 and y (each dead before the next
//   overwrites it).
//
// First design (encode_partial; kept as a check-only entry point,
// encode_fused_forward):
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
//   outright; a bag with no unmasked token pools to 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_combine.cuh"
#include "train_rows.cuh"

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

// ---------------------------------------------------------------------------
// The route every path takes: live token tiles on the wgmma GEMM
// ---------------------------------------------------------------------------

namespace {

constexpr int SCAN_THREADS = 1024;
constexpr int ROW_THREADS = 256;

// Grid: the b * ntiles tile slots, bag-major (the partials' layout). flag[slot]
// = whether any token of the slot is unmasked in any head; a dead slot's
// partials are written empty here.
__global__ void tile_flags(const float* __restrict__ bias, int* __restrict__ flag,
                           float* __restrict__ part_m, float* __restrict__ part_s,
                           float* __restrict__ part_w, int t, int nh) {
  const int slot = blockIdx.x, ntiles = (t + TM - 1) / TM;
  const int bi = slot / ntiles, tok0 = (slot % ntiles) * TM, rows = min(TM, t - tok0);
  const float* tb = bias + ((size_t)bi * t + tok0) * nh;
  int live = 0;
  for (int i = threadIdx.x; i < rows * nh; i += blockDim.x) live |= tb[i] > madeleine::MASKED_BIAS;
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) flag[slot] = live;
  if (live) return;
  for (int h = 0; h < nh; ++h)
    madeleine::write_empty_partial(part_m + (size_t)slot * nh + h, part_s + (size_t)slot * nh + h,
                                   part_w + ((size_t)slot * nh + h) * HID, HID, threadIdx.x,
                                   blockDim.x);
}

// One block: list[k] = the k-th live slot in slot order (thread i scans the
// slots [i per, (i + 1) per) and writes its live ones at its exclusive
// prefix, a warp scan then a scan of the warp totals); chunk_rows[c] = TM *
// the live tiles among list entries [c cap, (c + 1) cap).
__global__ void __launch_bounds__(SCAN_THREADS)
live_scan(const int* __restrict__ flag, int* __restrict__ list, int* __restrict__ chunk_rows,
          int S, int cap, int nchunks) {
  __shared__ int wsum[SCAN_THREADS / 32];
  __shared__ int total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (S + SCAN_THREADS - 1) / SCAN_THREADS;
  const int s0 = min(S, tid * per), s1 = min(S, s0 + per);
  int cnt = 0;
  for (int s = s0; s < s1; ++s) cnt += flag[s] != 0;
  int inc = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = wsum[lane];
    int winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += v;
    }
    wsum[lane] = winc - w;
    if (lane == 31) total = winc;
  }
  __syncthreads();
  int k = wsum[warp] + inc - cnt;
  for (int s = s0; s < s1; ++s)
    if (flag[s]) list[k++] = s;
  for (int c = tid; c < nchunks; c += SCAN_THREADS)
    chunk_rows[c] = TM * max(0, min(cap, total - c * cap));
}

// Grid: a chunk's `cap` list entries; block k copies the x rows of live slot
// list[k] into rows k TM .. k TM + TM - 1 of the compact operand (rows past t
// as zeros). Entries past the chunk's live rows (*m_live) return at once.
__global__ void gather_tiles(const bf16* __restrict__ x, const int* __restrict__ list,
                             const int* __restrict__ m_live, bf16* __restrict__ Xc, int t,
                             int d_in) {
  const int k = blockIdx.x;
  if (k * TM >= *m_live) return;
  const int slot = list[k], ntiles = (t + TM - 1) / TM;
  const int bi = slot / ntiles, tok0 = (slot % ntiles) * TM, rows = min(TM, t - tok0);
  const bf16* xb = x + ((size_t)bi * t + tok0) * d_in;
  bf16* xo = Xc + (size_t)k * TM * d_in;
  const int vpr = d_in / 8;   // 16-byte vectors per row
  for (int i = threadIdx.x; i < TM * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)r * d_in + c));
    *reinterpret_cast<uint4*>(xo + (size_t)r * d_in + c) = v;
  }
}

// LayerNorm + GELU of W-column rows, a warp per row (8 rows per 256-thread
// block, no block barrier), rows from *m_live on returning at once: lane l
// holds the 16-byte chunks l, l + 32, ... of its row, the statistics are two
// warp sums (mean, then the squared deviations), and the row goes out as
// bf16 into H (the next product's operand) and, with y32, as f32 back into
// Z. Rate 0: no dropout, no residuals.
template <int W>
__global__ void __launch_bounds__(ROW_THREADS)
ln_gelu_rows(float* __restrict__ Z, const float* __restrict__ s, const float* __restrict__ sh,
             bf16* __restrict__ H, int y32, const int* __restrict__ m_live) {
  constexpr int V = W / 128;   // float4 chunks per lane
  const long long r = (long long)blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= *m_live) return;
  const int lane = threadIdx.x & 31;
  float* zr = Z + r * W;
  float z[V][4];
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    madeleine::load4(zr + (v * 32 + lane) * 4, z[v]);
    sum += (z[v][0] + z[v][1]) + (z[v][2] + z[v][3]);
  }
  const float mean = madeleine::warp_sum(sum) * (1.f / W);
  float dev = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int j = 0; j < 4; ++j) dev += (z[v][j] - mean) * (z[v][j] - mean);
  const float rs = rsqrtf(madeleine::warp_sum(dev) * (1.f / W) + LN_EPS);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = (v * 32 + lane) * 4;
    float sc[4], shv[4], h[4];
    madeleine::load4(s + c, sc);
    madeleine::load4(sh + c, shv);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = gelu((z[v][j] - mean) * rs * sc[j] + shv[j]);
    madeleine::store4(H + r * W + c, h);
    if (y32) madeleine::store4(zr + c, h);
  }
}

template <int W>
cudaError_t launch_ln_gelu_rows(float* Z, const float* s, const float* sh, bf16* H, int y32,
                                const int* m_live, int M, cudaStream_t st) {
  constexpr int rows = ROW_THREADS / 32;
  ln_gelu_rows<W><<<(M + rows - 1) / rows, ROW_THREADS, 0, st>>>(Z, s, sh, H, y32, m_live);
  return cudaGetLastError();
}

// Grid (a chunk's `cap` list entries, nh heads), POOL_THREADS threads;
// block (k, h) is live slot list[k] (past *m_live: return) in head h. Each
// token's logit = its `chunks` gate partials added in chunk order + bc + the
// mask bias; then the tile's softmax-pool partial of y32 (rows k TM .. of
// Z) as the first design forms it, written at the slot: thread i sums
// columns 4 i .. 4 i + 3 over the tile's tokens in order.
constexpr int POOL_THREADS = HID / 4;

__global__ void __launch_bounds__(POOL_THREADS)
pool_tiles(const float* __restrict__ Z, const float* __restrict__ lpart,
           const float* __restrict__ bc, const float* __restrict__ bias,
           const int* __restrict__ list, const int* __restrict__ m_live,
           float* __restrict__ part_m, float* __restrict__ part_s, float* __restrict__ part_w,
           int t, int chunks) {
  __shared__ float logit_s[TM], p_s[TM];
  const int k = blockIdx.x, h = blockIdx.y, nh = gridDim.y;
  if (k * TM >= *m_live) return;
  const int slot = list[k], ntiles = (t + TM - 1) / TM;
  const int bi = slot / ntiles, tok0 = (slot % ntiles) * TM, rows = min(TM, t - tok0);
  const int tid = threadIdx.x, lane = tid & 31, E = nh * HID;
  if (tid < TM) {
    const float* lp = lpart + ((size_t)(k * TM + tid) * nh + h) * chunks;
    float l = 0.f;
    for (int c = 0; c < chunks; ++c) l += lp[c];
    l += bc[h];
    if (tid < rows) l += bias[((size_t)bi * t + tok0 + tid) * nh + h];
    logit_s[tid] = l;
  }
  __syncthreads();
  if (tid < 32) {
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
      part_m[(size_t)slot * nh + h] = m;
      part_s[(size_t)slot * nh + h] = s;
    }
  }
  __syncthreads();
  const float* y = Z + (size_t)k * TM * E + (size_t)h * HID + 4 * tid;
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < rows; ++r) {
    float v[4];
    madeleine::load4(y + (size_t)r * E, v);
    const float pr = p_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = fmaf(pr, v[j], w[j]);
  }
  madeleine::store4(part_w + (size_t)slot * E + (size_t)h * HID + 4 * tid, w);
}

}  // namespace

// dims: b, t, d_in, nh, e, f, cap (live tiles per chunk), nchunks. p: the
// pointers of ops/encode_fused.py::encode_fused_cuda, in its order: x, bias,
// w1, b1, s1, t1, w2, b2, s2, t2, w3, b3, s3, t3, wab, bab (permuted per
// head), wc, bc, out [b, nh e] bf16; scratch Z [rows, nh e] f32, Hb [rows,
// max(nh e, 2 e + d_in)] bf16, lpart [rows, nh, f / 64] f32 (rows = TM
// min(cap, b ntiles)), flag and list [b ntiles] int, chunk_rows [nchunks]
// int, part_m, part_s [b ntiles nh] f32, part_w [b ntiles nh e] f32.
// Returns a cudaError_t (cudaErrorInvalidValue for shapes it does not take).
extern "C" int encode_fused_tiles_forward(void** p, const long long* dims, const float* scales,
                                          void* stream) {
  (void)scales;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = (int)dims[0], t = (int)dims[1], d_in = (int)dims[2], nh = (int)dims[3];
  const int e = (int)dims[4], f = (int)dims[5], cap = (int)dims[6], nchunks = (int)dims[7];
  const int ntiles = (t + TM - 1) / TM, E = nh * HID;
  const long long S = (long long)b * ntiles;
  if (e != HID || f != HID || b < 1 || t < 1 || d_in % 8 || nh < 1 || nh > 4 || nh == 3 ||
      cap < 1 || S >= (1LL << 31) || (long long)TM * cap * E >= (1LL << 31) ||
      nchunks != (S + cap - 1) / cap)
    return (int)cudaErrorInvalidValue;
  const bf16* x = (const bf16*)p[0];
  const float* bias = (const float*)p[1];
  const bf16* w[3] = {(const bf16*)p[2], (const bf16*)p[6], (const bf16*)p[10]};
  const float* bl[3] = {(const float*)p[3], (const float*)p[7], (const float*)p[11]};
  const float* sl[3] = {(const float*)p[4], (const float*)p[8], (const float*)p[12]};
  const float* tl[3] = {(const float*)p[5], (const float*)p[9], (const float*)p[13]};
  const bf16* wab = (const bf16*)p[14];
  const float *bab = (const float*)p[15], *wc = (const float*)p[16], *bc = (const float*)p[17];
  bf16* out = (bf16*)p[18];
  float* Z = (float*)p[19];
  bf16* Hb = (bf16*)p[20];
  float* lpart = (float*)p[21];
  int *flag = (int*)p[22], *list = (int*)p[23], *chunk_rows = (int*)p[24];
  float *part_m = (float*)p[25], *part_s = (float*)p[26], *part_w = (float*)p[27];
  const long long rows = (long long)TM * (S < cap ? S : cap);
  bf16* H1 = Hb;                      // Hb holds in turn: Xc, h1, h2, then y
  bf16* H2 = Hb + rows * HID;
  bf16* Xc = Hb + 2 * rows * HID;
  bf16* Y = Hb;
  const madeleine::Dropout none{0u, 0u, 1.f};   // the gate epilogue at rate 0

  tile_flags<<<(unsigned)S, ROW_THREADS, 0, st>>>(bias, flag, part_m, part_s, part_w, t, nh);
  TRAIN_CHECK(cudaGetLastError());
  live_scan<<<1, SCAN_THREADS, 0, st>>>(flag, list, chunk_rows, (int)S, cap, nchunks);
  TRAIN_CHECK(cudaGetLastError());
  for (int c = 0; c < nchunks; ++c) {
    const long long left = S - (long long)c * cap;
    const int tiles = (int)(left < cap ? left : cap), M = TM * tiles;
    const int* live = chunk_rows + c;
    const int* lst = list + (size_t)c * cap;
    gather_tiles<<<tiles, ROW_THREADS, 0, st>>>(x, lst, live, Xc, t, d_in);
    TRAIN_CHECK(cudaGetLastError());
    const bf16* Ain[3] = {Xc, H1, H2};
    bf16* Hout[2] = {H1, H2};
    const int Kl[3] = {d_in, HID, HID}, Nl[3] = {HID, HID, E};
    for (int i = 0; i < 3; ++i) {
      const madeleine::WgOperand a{Ain[i], Kl[i], M, Kl[i], 0, 0};
      const madeleine::WgOperand bw{w[i], Kl[i], Nl[i], Kl[i], 0, 0};
      madeleine::wg::Params gp = madeleine::wg_params(Z, Nl[i], bl[i], M, Nl[i], Kl[i]);
      gp.m_live = live;
      TRAIN_CHECK((madeleine::wg_gemm<false, false, madeleine::wg::EPI_F32>(a, bw, gp, st)));
      // LN, GELU -> the next product's bf16 operand; layer 3 also leaves y32 in Z
      TRAIN_CHECK(i < 2       ? launch_ln_gelu_rows<HID>(Z, sl[i], tl[i], Hout[i], 0, live, M, st)
                  : E == 512  ? launch_ln_gelu_rows<512>(Z, sl[i], tl[i], Y, 1, live, M, st)
                  : E == 1024 ? launch_ln_gelu_rows<1024>(Z, sl[i], tl[i], Y, 1, live, M, st)
                              : launch_ln_gelu_rows<2048>(Z, sl[i], tl[i], Y, 1, live, M, st));
    }
    // the gate products of every head, the logit partials in the epilogue:
    // batch h reads y at column h e and the permuted [Wa; Wb]_h at row h 2f
    {
      const madeleine::WgOperand a{Y, E, M, E, 0, HID};
      const madeleine::WgOperand bw{wab, HID, 2LL * nh * f, HID, 2 * f, 0};
      madeleine::wg::Params gp = madeleine::wg_params(nullptr, 2 * f, bab, M, 2 * f, HID);
      gp.strideBias = 2LL * f;
      gp.batches = nh;
      gp.lpart = lpart; gp.wc = wc;
      gp.f = f; gp.t = 1;
      gp.d = none;
      gp.m_live = live;
      TRAIN_CHECK((madeleine::wg_gemm<false, false, madeleine::wg::EPI_GATES>(a, bw, gp, st)));
    }
    pool_tiles<<<dim3(tiles, nh), POOL_THREADS, 0, st>>>(Z, lpart, bc, bias, lst, live, part_m,
                                                         part_s, part_w, t, f / 64);
    TRAIN_CHECK(cudaGetLastError());
  }
  return (int)madeleine::launch_pool_combine<bf16>(part_m, part_s, part_w, out, b, ntiles, nh,
                                                   HID, st);
}
