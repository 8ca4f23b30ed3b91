// The products of the f32 train kernels (K6 and K7 with f32 operands, the
// JAX package's parity route, --precision float32, Precision.HIGHEST there)
// on Hopper's TF32 tensor cores: a persistent TMA + wgmma GEMM whose every
// product is the three-term split of wgmma_tf32.cuh.
//
//   C[z][m, n] (+)= epi(sum_k A_z(m, k) B_z(n, k) + bias_z[n])
//
// The arithmetic (K2's, wgmma_tf32.cuh): each f32 operand x is cut into x_hi
// = tf32(x) (cvt.rna) and x_lo = tf32(x - x_hi); each 32-deep k tile starts a
// fresh m64n128 partial holding lo.hi and hi.lo of its four k8 steps, then
// hi.hi (split_ktile); the partials are added in k order in registers,
// rounded to nearest. No accumulator is chained across k tiles: chained over
// a 512-deep product, K2 missed its atol 1e-5 bar by 2.75e-5.
//
// What bounds it on an H100: the three TF32 terms, 3 x 2 M N K operations at
// 495 TFLOP/s (a 2.45x lower bound than FFMA's 67 TFLOP/s for the same f32
// work), and the shared memory the split passes and the wgmma operand reads
// share with it.
//
// TF32 wgmma reads both operands K-major from shared memory (no transpose
// immediates), which sets the two forms the launch sequences of
// train_rows.cuh need (Gemm::TF32 there):
//   form K (TOK = false): A K-major (the activations or cotangents, [rows,
//     k] row-major), B pre-split K-major: `split_weights` writes a weight's
//     hi and lo once per call, as stored ([N, K]: linear, K6's gates) or
//     transposed per batch (dgrad: [batches N, K] from [batches, K, N]); a
//     stage holds [A | A lo | B hi | B lo], 128 rows x 32 floats each, with
//     the TMA's 128-byte swizzle; each consumer warpgroup splits its 64 rows
//     of A in place (hi over the raw tile, lo beside it, the same swizzled
//     offsets), as K2 does;
//   form T (TOK = true): the weight gradients, both operands token-major
//     (A(m, tok) at A[tok lda + m]); a stage holds the raw tiles [32 tokens,
//     128 m] and [32 tokens, 128 n] unswizzled, and the consumers transpose
//     and split them into K-major swizzled hi / lo buffers (two of them, so
//     that the split of k tile kt + 1 runs while kt's products do): each
//     thread reads one column of four token rows (lanes on consecutive
//     columns: no bank conflict) and writes one 16-byte chunk of hi and of lo
//     (the swizzle spreads eight consecutive rows over the eight chunks of a
//     128-byte row: no bank conflict). The token sum is cut into pieces of
//     whole k tiles (`wgrad_chunk`), each piece's partial into a workspace,
//     summed in piece order by splitk_reduce_kernel: deterministic, no
//     atomics.
// Block: a producer warpgroup (one thread starts the TMA loads into a
// 3-stage mbarrier ring, running ahead across tiles) and two consumer
// warpgroups, each the 64 rows of the block's 128 x 128 output tile; one
// persistent block per SM walks the tiles blockIdx.x, + gridDim.x, ...
// (batch and split outermost, then m tiles, then n tiles), as gemm_wgmma.cuh
// does, whose mbarrier, TMA and descriptor helpers this engine reuses.
// Epilogues: EPI_F32 (+ bias, + C's old value with beta, f32 stores from the
// accumulator fragments) and EPI_GATES, K6's gate product: the bias, exact
// tanh and 1 / (1 + e^-v), the gate dropout (gemm_wgmma.cuh::gate_keep_bits:
// the keys of the FFMA route and of the bf16 route), f32 a_pre and b_pre, and
// one partial logit per 64 columns (each thread's 16 columns in order, then
// the four threads of a row in xor order 1, 2), which gate_logits_sum adds in
// chunk order. Every offset is 64-bit. Two launches give bitwise-equal
// results: every output element comes from one warpgroup in a fixed order.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"     // splitk_reduce_kernel
#include "gemm_wgmma.cuh"    // mbarriers, TMA, descriptors, the gate epilogue's helpers
#include "wgmma_tf32.cuh"    // split, split_ktile, fence_proxy_async

namespace madeleine {
namespace t32 {

constexpr int BM = 128, BN = 128, KT = tf32::KT;   // KT = 32 floats: 128 bytes
constexpr int THREADS = 384;                       // producer + 2 consumer warpgroups
constexpr int TILE_BYTES = 128 * KT * 4;           // 128 rows x 32 floats: 16 KB
constexpr int HALF_BYTES = TILE_BYTES / 2;         // a consumer warpgroup's 64 rows
constexpr int STAGES = 3;
constexpr int STAGE_K = 4 * TILE_BYTES;            // form K: A (hi in place), A lo, B hi, B lo
constexpr int STAGE_T = 2 * TILE_BYTES;            // form T: raw A, raw B
constexpr int SPLIT_T = 4 * TILE_BYTES;            // form T: A hi, A lo, B hi, B lo
// ring (+ form T's two split buffers), full and empty barriers, + slack to
// align the ring to 1024 bytes (the 128-byte swizzle's period)
template <bool TOK>
constexpr int smem_bytes() {
  return (TOK ? STAGES * STAGE_T + 2 * SPLIT_T : STAGES * STAGE_K) + 2 * STAGES * 8 + 1024;
}
// Blocks of a launch: one per SM of an H100 (132); the weight gradients'
// pieces aim at two tiles a block.
constexpr int SPLIT_TARGET_TILES = 264;
constexpr int SPLIT_MIN_TOKENS = 1024;   // the shortest piece of a split weight gradient

enum Epi { EPI_F32 = 0, EPI_GATES = 1 };

// What the kernel reads besides its tensor maps: gemm_wgmma.cuh's Params
// (output, shapes, batches, split-K, bias, beta, and for EPI_GATES the gate
// fields lpart, wc, f, t, row_offset, d), and EPI_GATES' f32 activations:
// head h's f columns of row i at ap + i ldg + h hs (skipped when null).
struct Params {
  wg::Params g;
  float* ap;
  float* bp;
  long long ldg, hs;
};

__device__ __forceinline__ wg::Tile tile_at(const wg::Params& p, int tile, int tiles_n,
                                            int tiles_mn) {
  wg::Tile T;
  T.z = tile / tiles_mn;
  const int r = tile - T.z * tiles_mn;
  T.batch = T.z / p.splits;
  const int split = T.z - T.batch * p.splits;
  T.m0 = r / tiles_n * BM;
  T.n0 = r % tiles_n * BN;
  T.kbeg = split * p.kchunk;
  const int kend = min(p.K, T.kbeg + p.kchunk);
  T.nk = (kend - T.kbeg + KT - 1) / KT;
  return T;
}

// Form K: the warpgroup's 64 rows x 32 floats of A split in place, hi over
// the raw tile at `a`, lo at `a_lo` (4 float4 a thread, same offsets).
__device__ __forceinline__ void split_rows(unsigned char* a, unsigned char* a_lo, int wt) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int off = (wt + 128 * i) * 16;
    float4 v = *reinterpret_cast<const float4*>(a + off), lo;
    tf32::split(v.x, lo.x);
    tf32::split(v.y, lo.y);
    tf32::split(v.z, lo.z);
    tf32::split(v.w, lo.w);
    *reinterpret_cast<float4*>(a + off) = v;
    *reinterpret_cast<float4*>(a_lo + off) = lo;
  }
}

// Form T: rows 64 half .. 64 half + 63 of a raw token-major tile `raw` [32
// k][128 rows] (row stride 512 bytes) transposed and split into the K-major
// swizzled hi and lo tiles [128 rows][32 k]: element (r, k) at byte r 128 +
// 16 ((k / 4) ^ (r % 8)) + 4 (k % 4), as TMA's 128-byte swizzle lays it.
__device__ __forceinline__ void split_transpose(const float* raw, unsigned char* hi,
                                                unsigned char* lo, int half, int wt) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int task = wt + 128 * i, r = 64 * half + (task & 63), kc = task >> 6;
    float4 v = make_float4(raw[(4 * kc) * BM + r], raw[(4 * kc + 1) * BM + r],
                           raw[(4 * kc + 2) * BM + r], raw[(4 * kc + 3) * BM + r]);
    float4 l;
    tf32::split(v.x, l.x);
    tf32::split(v.y, l.y);
    tf32::split(v.z, l.z);
    tf32::split(v.w, l.w);
    const int off = r * 128 + ((kc ^ (r & 7)) << 4);
    *reinterpret_cast<float4*>(hi + off) = v;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// EPI_F32: the warpgroup's 64 rows (from m0) of the tile, bias added, C's old
// value added with beta; fragment i of the m64n128 accumulator is row 16
// warp + lane / 4 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
__device__ __forceinline__ void epilogue_f32(const wg::Params& p, const float (&acc)[64],
                                             const wg::Tile& T, int m0, int warp, int lane) {
  const int r0 = m0 + 16 * warp + lane / 4, c0 = T.n0 + 2 * (lane % 4);
  const float* bias = p.bias ? p.bias + (long long)T.batch * p.strideBias : nullptr;
  float* C = static_cast<float*>(p.C) + (long long)T.z * p.strideC;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int c = c0 + 8 * q;
    if (c >= p.N) continue;   // N is even, so c + 1 < N too
    const float b0 = bias ? __ldg(bias + c) : 0.f, b1 = bias ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= p.M) continue;
      float2* o = reinterpret_cast<float2*>(C + (long long)row * p.ldc + c);
      float2 v = make_float2(acc[4 * q + 2 * hh] + b0, acc[4 * q + 2 * hh + 1] + b1);
      if (p.beta) {
        const float2 old = *o;
        v = make_float2(old.x + v.x, old.y + v.y);
      }
      *o = v;
    }
  }
}

__device__ __forceinline__ float sigmoid_exact(float v) { return 1.f / (1.f + expf(-v)); }

// EPI_GATES (batch = head h, N = 2f, [Wa; Wb]_h's rows permuted so that
// 128-column tile c holds tanh columns 64 c .. 64 c + 63, then the sigmoid
// columns of the same j: gemm_wgmma.cuh::gate_bias_wc's layout): per row a =
// tanh, g = sigmoid (exact), f32 a_pre / b_pre, and lpart[(row nh + h) f / 64
// + c] = the 64 columns' drop(a) drop(g) wc, each thread adding its 16 in
// fragment order, then the quad in xor order 1, 2.
__device__ __forceinline__ void epilogue_gates(const Params& q, float (&acc)[64],
                                               const wg::Tile& T, int m0, int warp, int lane) {
  const wg::Params& p = q.g;
  const int h = T.batch, nh = p.batches, chunk = T.n0 / BN;
  wg::Tile Tw = T;
  Tw.m0 = m0;
  float wc[16];
  wg::gate_bias_wc(p, acc, Tw, lane, wc);
  const int row0 = m0 + 16 * warp + lane / 4;
  uint32_t abits[2], bbits[2];
  wg::gate_keep_bits(p, h, chunk, row0, lane, abits, bbits);
  const float sc = p.d.scale;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;   // may be >= M
    const bool live = row < p.M;
    const long long go = (long long)row * q.ldg + (long long)h * q.hs + chunk * 64;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int jj = 8 * k + 2 * (lane % 4);
      const float a0 = tanhf(acc[4 * k + 2 * hh]), a1 = tanhf(acc[4 * k + 2 * hh + 1]);
      const float g0 = sigmoid_exact(acc[4 * (k + 8) + 2 * hh]);
      const float g1 = sigmoid_exact(acc[4 * (k + 8) + 2 * hh + 1]);
      const float ka0 = (abits[hh] >> (4 * k)) & 1u ? sc : 0.f;
      const float ka1 = (abits[hh] >> (4 * k + 1)) & 1u ? sc : 0.f;
      const float kb0 = (bbits[hh] >> (4 * k)) & 1u ? sc : 0.f;
      const float kb1 = (bbits[hh] >> (4 * k + 1)) & 1u ? sc : 0.f;
      part += (a0 * ka0) * (g0 * kb0) * wc[2 * k];
      part += (a1 * ka1) * (g1 * kb1) * wc[2 * k + 1];
      if (q.ap && live) {
        *reinterpret_cast<float2*>(q.ap + go + jj) = make_float2(a0, a1);
        *reinterpret_cast<float2*>(q.bp + go + jj) = make_float2(g0, g1);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (live && lane % 4 == 0) p.lpart[((long long)row * nh + h) * (p.f / 64) + chunk] = part;
  }
}

template <bool TOK, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
tf32_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_b_lo, const __grid_constant__ Params q) {
  const wg::Params& p = q.g;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  constexpr int STAGE = TOK ? STAGE_T : STAGE_K;
  const uint32_t split_base = base + STAGES * STAGE;   // form T's split buffers
  const uint32_t bars = split_base + (TOK ? 2 * SPLIT_T : 0);   // full[s], then empty[s]
  auto gp = [&](uint32_t a) { return smem_raw + (a - raw_u32); };
  const int tid = threadIdx.x, group = tid / 128;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles_mn = (p.M + BM - 1) / BM * tiles_n;
  const int tiles = tiles_mn * p.batches * p.splits;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(bars + 8 * s, 1);
      wg::mbar_init(bars + 8 * (STAGES + s), 256);   // both consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == 0) {
    // producer: one thread keeps the ring full, k tile by k tile, tile by tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const wg::Tile T = tile_at(p, tile, tiles_n, tiles_mn);
        for (int kt = 0; kt < T.nk; ++kt, ++it) {
          const int s = it % STAGES;
          wg::mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
          const uint32_t full = bars + 8 * s, dst = base + s * STAGE;
          const int k = T.kbeg + kt * KT;
          if constexpr (TOK) {
            wg::mbar_expect_tx(full, 2 * TILE_BYTES);
            wg::tma_load_2d(dst, &map_a, full, p.a_mn * T.batch + T.m0, k);
            wg::tma_load_2d(dst + TILE_BYTES, &map_b, full, p.b_mn * T.batch + T.n0, k);
          } else {
            wg::mbar_expect_tx(full, 3 * TILE_BYTES);
            wg::tma_load_2d(dst, &map_a, full, p.a_k * T.batch + k, p.a_mn * T.batch + T.m0);
            const int bk = p.b_k * T.batch + k, bn = p.b_mn * T.batch + T.n0;
            wg::tma_load_2d(dst + 2 * TILE_BYTES, &map_b, full, bk, bn);
            wg::tma_load_2d(dst + 3 * TILE_BYTES, &map_b_lo, full, bk, bn);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup `half` takes rows 64 half .. 64 half + 63 of every
  // tile of the block; d: the k tile's partial; acc: the partials in k order
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int half = group - 1, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  float d[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = acc[i] = 0.f;
  int it = 0, buf = 0;   // it: the ring position of the tile's first k tile
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const wg::Tile T = tile_at(p, tile, tiles_n, tiles_mn);
    if constexpr (TOK) {
      // both warpgroups split half of each operand: a named barrier over the
      // 256 consumer threads after every split; a stage goes back to the
      // producer once it is split
      {
        const int s = it % STAGES;
        wg::mbar_wait(bars + 8 * s, (it / STAGES) & 1);
        const float* rawA = reinterpret_cast<const float*>(gp(base + s * STAGE));
        const uint32_t sb = split_base + buf * SPLIT_T;
        split_transpose(rawA, gp(sb), gp(sb + TILE_BYTES), half, wt);
        split_transpose(rawA + BM * KT, gp(sb + 2 * TILE_BYTES), gp(sb + 3 * TILE_BYTES), half,
                        wt);
        tf32::fence_proxy_async();
        asm volatile("bar.sync 3, 256;\n" ::: "memory");
        wg::mbar_arrive(bars + 8 * (STAGES + s));
      }
      for (int kt = 0; kt < T.nk; ++kt) {
        const uint32_t sb = split_base + buf * SPLIT_T;
        wg::fence_acc(d);
        wg::wgmma_fence();
        tf32::split_ktile(d, sb + half * HALF_BYTES, sb + TILE_BYTES + half * HALF_BYTES,
                          sb + 2 * TILE_BYTES, sb + 3 * TILE_BYTES);
        wg::wgmma_commit();
        wg::fence_acc(d);
        const int s1 = (it + kt + 1) % STAGES;
        if (kt + 1 < T.nk) {
          // the next k tile's split while this one's products run
          wg::mbar_wait(bars + 8 * s1, ((it + kt + 1) / STAGES) & 1);
          const float* rawA = reinterpret_cast<const float*>(gp(base + s1 * STAGE));
          const uint32_t nb = split_base + (buf ^ 1) * SPLIT_T;
          split_transpose(rawA, gp(nb), gp(nb + TILE_BYTES), half, wt);
          split_transpose(rawA + BM * KT, gp(nb + 2 * TILE_BYTES), gp(nb + 3 * TILE_BYTES),
                          half, wt);
          tf32::fence_proxy_async();
        }
        wg::wgmma_wait<0>();
        wg::fence_acc(d);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = kt == 0 ? d[i] : acc[i] + d[i];
        // both warpgroups: the next split written, this tile's products read
        asm volatile("bar.sync 3, 256;\n" ::: "memory");
        if (kt + 1 < T.nk) wg::mbar_arrive(bars + 8 * (STAGES + s1));
        buf ^= 1;
      }
    } else {
      // each warpgroup splits its own 64 rows of A in place: a named barrier
      // over its 128 threads; a stage goes back once both warpgroups' products
      // on it are done
      {
        const int s = it % STAGES;
        wg::mbar_wait(bars + 8 * s, (it / STAGES) & 1);
        const uint32_t st = base + s * STAGE;
        split_rows(gp(st + half * HALF_BYTES), gp(st + TILE_BYTES + half * HALF_BYTES), wt);
        tf32::fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
      }
      for (int kt = 0; kt < T.nk; ++kt) {
        const int s = (it + kt) % STAGES;
        const uint32_t st = base + s * STAGE;
        wg::fence_acc(d);
        wg::wgmma_fence();
        tf32::split_ktile(d, st + half * HALF_BYTES, st + TILE_BYTES + half * HALF_BYTES,
                          st + 2 * TILE_BYTES, st + 3 * TILE_BYTES);
        wg::wgmma_commit();
        wg::fence_acc(d);
        if (kt + 1 < T.nk) {
          const int s1 = (it + kt + 1) % STAGES;
          wg::mbar_wait(bars + 8 * s1, ((it + kt + 1) / STAGES) & 1);
          const uint32_t st1 = base + s1 * STAGE;
          split_rows(gp(st1 + half * HALF_BYTES), gp(st1 + TILE_BYTES + half * HALF_BYTES), wt);
          tf32::fence_proxy_async();
        }
        wg::wgmma_wait<0>();
        wg::fence_acc(d);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = kt == 0 ? d[i] : acc[i] + d[i];
        wg::mbar_arrive(bars + 8 * (STAGES + s));
        if (kt + 1 < T.nk) asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
      }
    }
    it += T.nk;
    if constexpr (EPI == EPI_GATES)
      epilogue_gates(q, acc, T, T.m0 + 64 * half, warp, lane);
    else
      epilogue_f32(p, acc, T, T.m0 + 64 * half, warp, lane);
  }
}

// One operand: a row-major f32 [rows, cols] matrix with row stride ld, the
// tensor map's extent. Form K: rows are m (or n), columns k; form T: rows
// are tokens (k), columns m (or n). Batch z's tile is off_mn z along m (or
// n) and off_k z along k. A pre-split B holds its hi rows, then as many lo
// rows: lo at p + rows ld.
struct Operand {
  const float* p;
  long long ld, rows, cols;
  int off_mn, off_k;
};

inline bool operand_ok(const Operand& o) {
  return o.p && reinterpret_cast<uintptr_t>(o.p) % 16 == 0 && o.ld % 4 == 0 && o.ld >= o.cols &&
         o.rows >= 1 && o.cols >= 1 && o.rows < (1LL << 31) && o.cols < (1LL << 31) &&
         o.off_mn >= 0 && o.off_k >= 0;
}

// Tensor map of a row-major f32 [rows, cols] matrix, boxes of [box_cols,
// box_rows]: 128-byte swizzle (box_cols 32) for form K, none for form T's
// 128-column boxes; zeros outside.
inline bool make_map(wg::EncodeTiledFn enc, CUtensorMap* map, const float* p, long long rows,
                     long long cols, long long ld, int box_cols, int box_rows, bool swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C = epi(A . B^T + bias), batched and split as q.g says. The caller sets
// C, ldc, strideC, bias, strideBias, M, N, K, batches, splits (and kchunk
// with splits > 1), beta and, for EPI_GATES, the gate fields; the launcher
// fills the coordinate offsets. Returns cudaErrorInvalidValue for anything
// the kernel cannot take (nothing falls back to another route): operands
// not on 16 bytes or with a row stride not a multiple of 4 floats, an odd
// N, C not on 8 bytes or ldc / strideC odd, a k tile past K that could read
// another batch's columns (form K: K % 32, or the map ending at K), a token
// extent other than K (form T), pieces that are not whole k tiles covering
// K, split-K with a bias or beta, and EPI_GATES' own shapes.
template <bool TOK, int EPI>
inline cudaError_t gemm(const Operand& A, const Operand& B, Params q, cudaStream_t st) {
  wg::Params& p = q.g;
  bool ok = p.M >= 1 && p.N >= 1 && p.K >= 1 && p.batches >= 1 && p.splits >= 1 &&
            p.N % 2 == 0 && p.ldc % 2 == 0 && p.strideC % 2 == 0 && p.ldc >= p.N &&
            operand_ok(A) && operand_ok(B) &&
            (EPI == EPI_GATES || (p.C && reinterpret_cast<uintptr_t>(p.C) % 8 == 0)) &&
            (p.splits == 1 || (EPI == EPI_F32 && !p.beta && !p.bias));
  if (TOK)
    ok = ok && A.rows == p.K && B.rows == p.K && A.off_k == 0 && B.off_k == 0;
  else
    ok = ok && B.cols == p.K && B.off_k == 0 && B.ld == p.K &&
         (p.K % KT == 0 || (A.off_k == 0 && A.cols == p.K));
  if (p.splits == 1)
    p.kchunk = (p.K + KT - 1) / KT * KT;
  else
    ok = ok && p.kchunk % KT == 0 && p.kchunk > 0 && (long long)(p.splits - 1) * p.kchunk < p.K &&
         (long long)p.splits * p.kchunk >= p.K;
  if (EPI == EPI_GATES)
    ok = ok && p.splits == 1 && p.f % 64 == 0 && p.N == 2 * p.f && p.t >= 1 && p.bias && p.wc &&
         p.lpart && !q.ap == !q.bp && reinterpret_cast<uintptr_t>(q.ap) % 8 == 0 &&
         reinterpret_cast<uintptr_t>(q.bp) % 8 == 0 && q.ldg % 2 == 0 && q.hs % 2 == 0;
  if (!ok) return cudaErrorInvalidValue;
  p.a_mn = A.off_mn; p.a_k = A.off_k;
  p.b_mn = B.off_mn; p.b_k = B.off_k;
  const long long tiles = (long long)((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN) * p.batches *
                          p.splits;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const wg::EncodeTiledFn enc = wg::encode_fn();
  if (!enc) return cudaErrorInitializationError;
  CUtensorMap map_a, map_b, map_b_lo;   // form T reads no lo map: map_b again
  const bool maps =
      TOK ? make_map(enc, &map_a, A.p, A.rows, A.cols, A.ld, BM, KT, false) &&
                make_map(enc, &map_b, B.p, B.rows, B.cols, B.ld, BN, KT, false) &&
                (map_b_lo = map_b, true)
          : make_map(enc, &map_a, A.p, A.rows, A.cols, A.ld, KT, BM, true) &&
                make_map(enc, &map_b, B.p, B.rows, B.cols, B.ld, KT, BN, true) &&
                make_map(enc, &map_b_lo, B.p + B.rows * B.ld, B.rows, B.cols, B.ld, KT, BN,
                         true);
  if (!maps) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // set on every launch: a function-local static would be one object for
  // every library of the process that includes this header
  err = cudaFuncSetAttribute(tf32_gemm_kernel<TOK, EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<TOK>());
  if (err != cudaSuccess) return err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  tf32_gemm_kernel<TOK, EPI><<<grid, THREADS, smem_bytes<TOK>(), st>>>(map_a, map_b, map_b_lo, q);
  return cudaGetLastError();
}

inline Params params(void* C, long long ldc, const float* bias, int M, int N, int K) {
  Params q{};
  q.g = wg_params(C, ldc, bias, M, N, K);
  return q;
}

// The pre-split B operand of the forms above: hi and lo of `batches` f32
// matrices [R, C] (contiguous, batch stride R C) written to dst as hi
// [batches, R, C] (or [batches, C, R] with transpose: dgrad's K-major B from
// the weights as stored), then lo of the same shape. One thread an element.
__global__ void split_weights_kernel(const float* __restrict__ w, float* __restrict__ dst,
                                     int R, int C, long long n, int transpose) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long src = i;
  if (transpose) {
    const long long RC = (long long)R * C, b = i / RC, j = i - b * RC, c = j / R;
    src = b * RC + (j - c * R) * C + c;
  }
  float v = w[src], lo;
  tf32::split(v, lo);
  dst[i] = v;
  dst[n + i] = lo;
}

// Floats of a pre-split operand of `batches` [R, C] matrices (hi and lo).
inline long long split_floats(int batches, int R, int C) {
  return 2LL * batches * R * C;
}

inline cudaError_t split_weights(const float* w, float* dst, int batches, int R, int C,
                                 bool transpose, cudaStream_t st) {
  const long long n = (long long)batches * R * C;
  if (!w || !dst || n < 1) return cudaErrorInvalidValue;
  split_weights_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(w, dst, R, C, n,
                                                                   transpose ? 1 : 0);
  return cudaGetLastError();
}

// Z [M, N] = X [M, K] W [N, K]^T + bias [N]; Wsp: W pre-split as stored.
inline cudaError_t linear(const float* X, const float* Wsp, const float* bias, float* Z, int M,
                          int N, int K, cudaStream_t st) {
  const Operand a{X, K, M, K, 0, 0}, b{Wsp, K, N, K, 0, 0};
  return gemm<false, EPI_F32>(a, b, params(Z, N, bias, M, N, K), st);
}

// C [tokens, N] (+)= A [tokens, K] . B_z [K, N], batched: batch z's A
// columns at z strideA, its C columns at z strideC; Bt: the weights pre-split
// transposed ([batches N, K] hi, then lo).
inline cudaError_t dgrad(const float* A, long long lda, long long strideA, const float* Bt,
                         float* C, long long ldc, long long strideC, int tokens, int N, int K,
                         int batches, int beta, cudaStream_t st) {
  const Operand a{A, lda, tokens, strideA * (batches - 1) + K, 0, (int)strideA};
  const Operand b{Bt, K, (long long)batches * N, K, N, 0};
  Params q = params(C, ldc, nullptr, tokens, N, K);
  q.g.strideC = strideC;
  q.g.batches = batches;
  q.g.beta = beta;
  return gemm<false, EPI_F32>(a, b, q, st);
}

// The piece length (tokens) of a weight gradient [Mo, No] (x batches) over
// `tokens`: as many pieces as keep the launch near SPLIT_TARGET_TILES output
// tiles, each at least SPLIT_MIN_TOKENS tokens, a whole number of 32-token k
// tiles (ops/encoder_train.py::tf32_wgrad_chunk mirrors it).
inline int wgrad_chunk(int Mo, int No, int tokens, int batches) {
  const long long tiles = (long long)((Mo + BM - 1) / BM) * ((No + BN - 1) / BN) * batches;
  long long s = (SPLIT_TARGET_TILES + tiles - 1) / tiles;
  const long long smax = (tokens + SPLIT_MIN_TOKENS - 1) / SPLIT_MIN_TOKENS;
  if (s > smax) s = smax;
  if (s < 1) s = 1;
  long long chunk = (tokens + s - 1) / s;
  chunk = (chunk + KT - 1) / KT * KT;
  return (int)chunk;
}

inline int wgrad_splits(int Mo, int No, int tokens, int batches) {
  const int chunk = wgrad_chunk(Mo, No, tokens, batches);
  return (tokens + chunk - 1) / chunk;
}

// Floats of split workspace `wgrad` needs (0 with one piece).
inline long long wgrad_work_floats(int Mo, int No, int tokens, int batches) {
  const int s = wgrad_splits(Mo, No, tokens, batches);
  return s > 1 ? (long long)s * batches * Mo * No : 0;
}

// out [batches, Mo, No] = sum over tokens of A(tok, m) B(tok, n), both
// token-major (batch z's columns at z strideA, z strideB); the pieces'
// partials into work, summed in piece order.
inline cudaError_t wgrad(const float* A, long long lda, long long strideA, const float* B,
                         long long ldb, long long strideB, int Mo, int No, int tokens,
                         int batches, float* out, float* work, cudaStream_t st) {
  const Operand a{A, lda, tokens, strideA * (batches - 1) + Mo, (int)strideA, 0};
  const Operand b{B, ldb, tokens, strideB * (batches - 1) + No, (int)strideB, 0};
  Params q = params(out, No, nullptr, Mo, No, tokens);
  q.g.batches = batches;
  q.g.kchunk = wgrad_chunk(Mo, No, tokens, batches);
  q.g.splits = (tokens + q.g.kchunk - 1) / q.g.kchunk;
  const long long n = (long long)Mo * No;
  if (q.g.splits > 1) {
    q.g.C = work;
    q.g.strideC = n;
  }
  cudaError_t err = gemm<true, EPI_F32>(a, b, q, st);
  if (err != cudaSuccess || q.g.splits == 1) return err;
  splitk_reduce_kernel<<<(unsigned)((n * batches + 255) / 256), 256, 0, st>>>(
      work, out, n, q.g.splits, batches);
  return cudaGetLastError();
}

// K6's gate product with the gate in its epilogue, every head in one
// launch: batch h reads y [M, nh e] (row stride ldy) at column h e and the
// permuted [Wa; Wb]_h pre-split as stored (wab_sp: [nh 2f, e] hi, then lo)
// at row h 2f; writes, where set, a_pre and b_pre (f32, pre-dropout; head
// h's f columns of row i at i ldg + h hs) and the logit partials lpart [M,
// nh, f / 64].
inline cudaError_t gates(const float* y, long long ldy, const float* wab_sp, const float* bab,
                         const float* wc, float* ap, float* bp, long long ldg, long long hs,
                         float* lpart, int M, int nh, int e, int f, int t, int row_offset,
                         Dropout d, cudaStream_t st) {
  const Operand a{y, ldy, M, (long long)nh * e, 0, e};
  const Operand b{wab_sp, e, 2LL * nh * f, e, 2 * f, 0};
  Params q = params(nullptr, 2 * f, bab, M, 2 * f, e);
  q.g.strideBias = 2LL * f;
  q.g.batches = nh;
  q.g.lpart = lpart; q.g.wc = wc;
  q.g.f = f; q.g.t = t; q.g.row_offset = row_offset;
  q.g.d = d;
  q.ap = ap; q.bp = bp; q.ldg = ldg; q.hs = hs;
  return gemm<false, EPI_GATES>(a, b, q, st);
}

}  // namespace t32
}  // namespace madeleine
