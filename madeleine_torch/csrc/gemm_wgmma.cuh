// A persistent bf16 GEMM for Hopper: TMA loads, wgmma math, one block per SM.
//
//   C[z][m, n] (+)= epi(sum_k A_z(m, k) B_z(n, k) + bias_z[n])   (f32 accumulation)
//
// Each operand is K-major (row-major with k contiguous: element (r, k) at
// P[r * ld + k]) or MN-major (element (r, k) at P[k * ld + r]); the kernel is
// instantiated per pair of layouts, so one kernel takes the forward products
// X.W^T (both K-major), the input gradients dZ.W (B MN-major) and the weight
// gradients dZ^T.H (both MN-major, the reduction over every token).
//
// Batches are coordinates, not pointers: batch z's operand tile sits at
// off_mn * z along the operand's m (or n) axis and off_k * z along its k axis
// of one tensor map, so the per-head gate products read y at column h e and
// [Wa; Wb] at row h 2f. Output z is at C + z strideC (and its bias at bias +
// z strideBias). Split-K cuts the k range into `splits` pieces of whole k
// tiles, each piece's tile going to C + (batch splits + split) strideC;
// splitk_reduce_kernel (gemm_bf16.cuh) then sums the pieces in split order.
// No atomics anywhere: every output element comes from one warpgroup in a
// fixed k order, so two launches give bitwise-equal results.
//
// Design (Hopper's usual shape, hopper-kernels guide section 1):
//   - output tiles of 128 rows x 128 columns (64 rows for the gate
//     epilogues, see tile_rows), k tiles of 64 (128 bytes of bf16: one row
//     of the 128-byte swizzle), a ring of STAGES stages of A and B tiles in
//     shared memory, each stage with a "full" and an "empty" mbarrier. A K-major
//     tile is one TMA box of [rows, 64 k]; an MN-major tile is [64 k, 64 mn]
//     boxes side by side (128 bytes of m or n per k row, as wide as the
//     128-byte swizzle allows);
//   - warpgroup 0 is the producer: one thread starts cp.async.bulk.tensor
//     (TMA) loads with 128-byte swizzle, tile after tile; the hardware
//     zero-fills rows and columns outside the tensors, so the ragged M and N
//     tails and a K that is no multiple of 64 need no code (the launcher
//     checks that a k tile past K can only read zeros);
//   - warpgroups 1 and 2 are the consumers and take the block's tiles in
//     turn ("ping-pong"): per k16 step one wgmma.mma_async m64n128k16 per
//     64-row half of the tile, on one B, from shared-memory descriptors
//     whose swizzle matches the TMA's and whose transpose immediates say
//     which operands are MN-major, f32 accumulators in registers, one group
//     kept in flight while the next stage is awaited; then the epilogue,
//     while the other warpgroup runs the next tile's products. An "order"
//     mbarrier starts a warpgroup's tile only once the other has taken every
//     stage of the previous one (its products may still run), since a parity
//     wait can only look one phase ahead. 128-row tiles read B from L2 half
//     as often as 64-row ones and hand over between the warpgroups half as
//     often;
//   - every output leaves through a per-warp staging area in shared memory
//     as whole-row stores (see the epilogues);
//   - gridDim = min(tiles, SMs): each block walks the tiles blockIdx.x,
//     + gridDim.x, ... (batch and split outermost, then m tiles, then n
//     tiles) with the producer running ahead across tiles;
//   - with m_live set, the walk covers only the first *m_live rows of M, a
//     count that an earlier kernel wrote on the device (K1's live token
//     tiles), so the host never reads it back; rows beyond it are neither
//     read nor written past their last 64- or 128-row tile.
//
// Epilogues: EPI_BF16 (+ bias, rounded to bf16), EPI_F32 (+ bias, then tanh
// below act_split and sigmoid from there when act_split >= 0, then + C's old
// value when beta is set), EPI_GATES, the whole-encoder forward's gate
// logits (see epilogue_gates), and EPI_GATES_BWD, the per-op lane's gate
// adjoint on the recomputed gates (see epilogue_gates_bwd).
//
// The tensor maps are built on the host by cuTensorMapEncodeTiled, found
// with dlsym in the libcuda.so.1 the process has loaded (the libraries are
// not linked against libcuda), and passed as __grid_constant__ kernel
// parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "gemm_bf16.cuh"   // bf16, splitk_reduce_kernel
#include "philox.cuh"      // the gate epilogue's dropout masks

namespace madeleine {
namespace wg {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 384;                   // producer warpgroup + 2 consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;           // A tile, 128 x 64: 16 KB
constexpr int B_BYTES = BN * BK * 2;           // B tile, 128 x 64: 16 KB
constexpr int MN_BOX_BYTES = 64 * BK * 2;      // one [64 k, 64 mn] box of an MN-major tile
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// each consumer warp's staging area for its 16 rows of a 64-row half tile
// (f32 [16, 128], or the gates' two bf16 [16, 64])
constexpr int WARP_OUT_BYTES = 16 * BN * 4;
constexpr int OUT_BYTES = 8 * WARP_OUT_BYTES;
// ring, output staging, full, empty and order barriers, + slack to align the
// ring to 1024 bytes
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + OUT_BYTES + (2 * STAGES + 1) * 8 + 1024;
// Output tiles a launch should offer per split-K plan: two per SM of an H100
// (132), one per consumer warpgroup.
constexpr int SPLIT_TARGET_TILES = 264;

enum Epi { EPI_BF16 = 0, EPI_F32 = 1, EPI_GATES = 2, EPI_GATES_BWD = 3 };

// Rows of an output tile: 128 (two m64 halves per warpgroup), but 64 for the
// gate epilogues, whose transcendental and Philox work is the larger part of
// their tile's time and needs the registers a second half's accumulators hold.
template <int EPI>
__host__ __device__ constexpr int tile_rows() { return EPI >= EPI_GATES ? 64 : BM; }

// What the kernel reads besides its two tensor maps.
struct Params {
  void* C;                    // element (z, r, c) at C + z * strideC + r * ldc + c
  long long ldc, strideC;
  const float* bias;          // [N] of batch b at bias + b * strideBias, or null
  long long strideBias;
  int M, N, K;                // per batch
  const int* m_live;          // or null: the rows of M the walk covers, read on the device
  int batches, splits, kchunk;   // kchunk: k of every split but the last, a multiple of BK
  int a_mn, a_k, b_mn, b_k;   // per-batch coordinate offsets of A and B
  int beta;                   // EPI_F32: C += result
  int act_split;              // EPI_F32: < 0 none, else tanh below it, sigmoid from it
  // EPI_GATES: the pre-dropout activations, the logit partials, wc, and
  // what keys the gate dropout
  bf16* ap;
  bf16* bp;
  float* lpart;
  const float* wc;
  int f, t, row_offset;
  Dropout d;
  // EPI_GATES_BWD: the logits' cotangent dl [M, batches] f32 and the row
  // stride of the column partials in lpart (per 64-row tile)
  const float* dl;
  long long ld_part;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D box (coordinates innermost first) into shared memory; completion
// is reported to the mbarrier as transaction bytes (the whole box, zeros
// included where it lies outside the tensor).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The operand tile of `rows` m (or n) rows from mn, 64 k from k: one K-major
// box, or rows / 64 MN-major boxes side by side.
template <bool MN, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int mn, int k) {
  if (MN) {
#pragma unroll
    for (int i = 0; i < ROWS / 64; ++i)
      tma_load_2d(dst + i * MN_BOX_BYTES, map, bar, mn + 64 * i, k);
  } else {
    tma_load_2d(dst, map, bar, k, mn);
  }
}

// wgmma descriptors of tiles as TMA writes them with 128-byte swizzle (layout
// type 1); tile bases are 1024-byte aligned.
//   K-major: rows of 128 bytes (64 k), 8-row groups 1024 bytes apart (stride
//   byte offset), leading byte offset unused (1); a k16 step is 32 bytes on.
//   MN-major: k rows of 128 bytes (64 m or n), 8-k-row groups 1024 bytes
//   apart (stride byte offset), 64-wide m/n atoms one box (8 KB) apart
//   (leading byte offset); a k16 step is 16 k rows, 2048 bytes on.
template <bool MN>
__device__ __forceinline__ uint64_t desc_sw128(uint32_t tile, int k16) {
  const uint32_t addr = tile + (MN ? 2048 * k16 : 32 * k16);
  const uint64_t lead = MN ? (MN_BOX_BYTES >> 4) : 1;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lead << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the async ops.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] . B[128 x 16]^T, both from shared memory; TA / TB: the
// operand is MN-major (wgmma's transpose immediates); scale_d 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// Where a tile index of the walk lies.
struct Tile {
  int z, batch, m0, n0, kbeg, nk;
};

template <int ROWS>
__device__ __forceinline__ Tile tile_at(const Params& p, int tile, int tiles_n, int tiles_mn) {
  Tile T;
  T.z = tile / tiles_mn;
  const int r = tile - T.z * tiles_mn;
  T.batch = T.z / p.splits;
  const int split = T.z - T.batch * p.splits;
  T.m0 = r / tiles_n * ROWS;
  T.n0 = r % tiles_n * BN;
  T.kbeg = split * p.kchunk;
  const int kend = min(p.K, T.kbeg + p.kchunk);
  T.nk = (kend - T.kbeg + BK - 1) / BK;
  return T;
}

// Fragment i of the m64nN accumulator is row 16 warp + lane / 4 (+ 8 for
// i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
//
// The epilogues read what they need (bias, wc) before their first store: a
// store through C may alias those reads as far as the compiler knows, so
// reads placed between stores would each wait for the one before.
//
// Outputs leave through shared memory: each warp writes its 16 rows of
// fragments to its own staging area, then stores whole rows, 512 contiguous
// bytes per instruction (the fragments' own layout writes 32 bytes of f32,
// or 16 of bf16, to each of 8 rows per instruction, and those stores took
// half of an f32-output product's time on an H100). Staging columns are
// XOR-swizzled by the row (words ^ 4 (row % 8)), so the fragment writes and
// the row reads are free of bank conflicts.
__device__ __forceinline__ int swz(int row, int word) { return word ^ ((row & 7) << 2); }

template <int EPI>
__device__ __forceinline__ void epilogue_plain(const Params& p, float (&d)[64], const Tile& T,
                                               int m0, int warp, int lane, float* stage) {
  const int c0 = T.n0 + (lane % 4) * 2;
  if (p.bias) {
    const float* bias = p.bias + (long long)T.batch * p.strideBias;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int c = c0 + q * 8;
      if (c >= p.N) continue;   // N is even, so c + 1 < N too
      const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
      d[4 * q] += b0; d[4 * q + 1] += b1; d[4 * q + 2] += b0; d[4 * q + 3] += b1;
    }
  }
  if constexpr (EPI == EPI_BF16) {
    // staging: [16 rows, 64 words] of bf16 pairs, then two rows of 256
    // bytes per instruction, 16 bytes a lane (the fragments' own layout
    // writes 16 bytes to each of 8 rows per instruction: a bf16 output of
    // 545 MB took 0.61 ms that way on an H100, where an f32 one of twice
    // the bytes, staged, took 0.43)
    uint32_t* sw = reinterpret_cast<uint32_t*>(stage);
#pragma unroll
    for (int q = 0; q < BN / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lane / 4 + 8 * h;
        const __nv_bfloat162 v = __floats2bfloat162_rn(d[4 * q + 2 * h], d[4 * q + 2 * h + 1]);
        sw[row * 64 + swz(row, q * 4 + lane % 4)] = *reinterpret_cast<const uint32_t*>(&v);
      }
    __syncwarp();
    const int r0 = m0 + warp * 16, seg = lane % 16, c = T.n0 + seg * 8;
    bf16* C = static_cast<bf16*>(p.C) + (long long)T.z * p.strideC + (long long)r0 * p.ldc + c;
#pragma unroll
    for (int i0 = 0; i0 < 16; i0 += 2) {
      const int i = i0 + lane / 16;
      if (r0 + i >= p.M || c >= p.N) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(sw + i * 64 + swz(i, seg * 4));
      bf16* o = C + (long long)i * p.ldc;
      if (c + 8 <= p.N) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {   // N % 8 != 0: the row's last pairs
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        for (int j = 0; j < (p.N - c) / 2; ++j) reinterpret_cast<uint32_t*>(o)[j] = w[j];
      }
    }
    __syncwarp();
  } else {
    if (p.act_split >= 0) {
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = d[4 * q + i];
          d[4 * q + i] = c0 + q * 8 + (i & 1) < p.act_split ? tanhf(v) : 1.f / (1.f + expf(-v));
        }
    }
#pragma unroll
    for (int q = 0; q < BN / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lane / 4 + 8 * h;
        *reinterpret_cast<float2*>(stage + row * BN + swz(row, q * 8 + (lane % 4) * 2)) =
            make_float2(d[4 * q + 2 * h], d[4 * q + 2 * h + 1]);
      }
    __syncwarp();
    // rows of the warp, 4 at a time: C's old values first (beta), then stores
    const int r0 = m0 + warp * 16, c = T.n0 + lane * 4;
    float* C = static_cast<float*>(p.C) + (long long)T.z * p.strideC + (long long)r0 * p.ldc + c;
#pragma unroll
    for (int g = 0; g < 16; g += 4) {
      float4 old[4];
      if (p.beta) {
#pragma unroll
        for (int i = g; i < g + 4; ++i)
          old[i - g] = r0 + i < p.M && c + 4 <= p.N
                           ? *reinterpret_cast<const float4*>(C + (long long)i * p.ldc)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = g; i < g + 4; ++i) {
        if (r0 + i >= p.M) continue;   // uniform over the warp
        float4 v = *reinterpret_cast<const float4*>(stage + i * BN + swz(i, lane * 4));
        float* o = C + (long long)i * p.ldc;
        if (c + 4 <= p.N) {
          if (p.beta) {
            v.x += old[i - g].x; v.y += old[i - g].y; v.z += old[i - g].z; v.w += old[i - g].w;
          }
          *reinterpret_cast<float4*>(o) = v;
        } else if (c < p.N) {   // N % 4 == 2: the last two columns
          *reinterpret_cast<float2*>(o) = p.beta ? make_float2(o[0] + v.x, o[1] + v.y)
                                                 : make_float2(v.x, v.y);
        }
      }
    }
    __syncwarp();
  }
}

// Branch-free activations for the gate epilogue (one exp2 and one reciprocal
// on the special-function unit each, about 1e-7 from the correctly rounded
// value in absolute terms, far below the bf16 rounding of a_pre and b_pre):
// sigmoid(v) = 1 / (1 + e^-v), tanh(v) = 1 - 2 / (1 + e^2v); both saturate
// correctly where the exponential overflows.
__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}

// The gate epilogues' dropout bits for a thread's two rows row0 and row0 + 8
// (row0 = m0 + 16 warp + lane / 4) of head h, 128-column tile `chunk`.
// Every Philox draw of the thread comes before any other work, so that the
// 16 independent draws overlap: keep4's bits are column group c4 = j / 4,
// word j % 4. The pair of lanes (lane, lane ^ 1) shares c4: the even lane
// draws the tanh branch's four words, the odd lane the sigmoid branch's;
// each keeps one bit per word (word >= thr) at bit 4 q + word, and one
// shuffle per row hands the partner its bits. Returns, per row hh, the
// thread's own columns (words 0-1 for an even lane, 2-3 for an odd one) at
// bits 4 q and 4 q + 1 of abits[hh] (tanh branch) and bbits[hh] (sigmoid).
// Without dropout every bit is set (the scale is then 1).
__device__ __forceinline__ void gate_keep_bits(const Params& p, int h, int chunk, int row0,
                                               int lane, uint32_t (&abits)[2],
                                               uint32_t (&bbits)[2]) {
  const int odd = lane & 1;
  uint32_t own[2] = {0xffffffffu, 0xffffffffu};
  if (p.d.thr != 0u) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;   // may be >= M
      const int tok = row % p.t, bag = row / p.t + p.row_offset;
      uint32_t bits = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c4 = chunk * 16 + q * 2 + (lane % 4) / 2;
        const Philox4 r = philox4x32_10((uint32_t)c4, (uint32_t)tok, (uint32_t)bag,
                                        (uint32_t)(3 + 2 * h + odd), p.d.seed, 0u);
        bits |= ((uint32_t)(r.x >= p.d.thr) | (uint32_t)(r.y >= p.d.thr) << 1 |
                 (uint32_t)(r.z >= p.d.thr) << 2 | (uint32_t)(r.w >= p.d.thr) << 3)
                << (4 * q);
      }
      own[hh] = bits;
    }
  }
  const uint32_t other[2] = {__shfl_xor_sync(0xffffffffu, own[0], 1),
                             __shfl_xor_sync(0xffffffffu, own[1], 1)};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    abits[hh] = (odd ? other[hh] : own[hh]) >> (2 * odd);
    bbits[hh] = (odd ? own[hh] : other[hh]) >> (2 * odd);
  }
}

// The gate epilogues' bf16 outputs: the warp's 16 rows of two staged
// [16 rows, 64 j] blocks (sa, sg: 32 swizzled words a row) to rows row0 ..
// row0 + 15 (those below M) of pa and pb, row stride ld, from column col: 4
// rows of 128 bytes per store.
__device__ __forceinline__ void store_gate_rows(const uint32_t* sa, const uint32_t* sg,
                                                bf16* pa, bf16* pb, long long ld, long long col,
                                                int row0, int lane, int M) {
  __syncwarp();
  const int seg = lane % 8;
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    const int srow = i + lane / 8, row = row0 + srow;
    if (row >= M) continue;
    const long long off = (long long)row * ld + col + seg * 8;
    *reinterpret_cast<uint4*>(pa + off) =
        *reinterpret_cast<const uint4*>(sa + srow * 32 + swz(srow, seg * 4));
    *reinterpret_cast<uint4*>(pb + off) =
        *reinterpret_cast<const uint4*>(sg + srow * 32 + swz(srow, seg * 4));
  }
  __syncwarp();
}

// Both gate epilogues: batch = head h, N = 2f, and the wrapper has permuted
// the rows of [Wa; Wb]_h (and of its bias) so that 128-column tile c holds
// the tanh rows 64 c .. 64 c + 63 in columns 0-63 and the sigmoid rows of
// the same j in columns 64-127: fragments q and q + 8 of a thread are then
// a = tanh(.) and g = sigmoid(.) of one (row, j). This adds the bias to the
// fragments and reads the thread's 16 wc[h, j].
__device__ __forceinline__ void gate_bias_wc(const Params& p, float (&d)[64], const Tile& T,
                                             int lane, float (&wc)[16]) {
  const float* ba = p.bias + (long long)T.batch * p.strideBias + T.n0;   // [64 tanh | 64 sigmoid]
  const float* wcp = p.wc + (long long)T.batch * p.f + T.n0 / BN * 64;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int jj = q * 8 + (lane % 4) * 2;   // j - 64 chunk of this thread's pair
    const float a0 = __ldg(ba + jj), a1 = __ldg(ba + jj + 1);
    const float g0 = __ldg(ba + 64 + jj), g1 = __ldg(ba + 64 + jj + 1);
    d[4 * q] += a0; d[4 * q + 1] += a1; d[4 * q + 2] += a0; d[4 * q + 3] += a1;
    d[4 * q + 32] += g0; d[4 * q + 33] += g1; d[4 * q + 34] += g0; d[4 * q + 35] += g1;
    wc[2 * q] = __ldg(wcp + jj);
    wc[2 * q + 1] = __ldg(wcp + jj + 1);
  }
}

// The gate logits of the whole-encoder forward (layout: gate_bias_wc).
// Writes a_pre / b_pre [M, nh f] bf16 (pre-dropout; skipped when ap is null,
// as in K1's forward, which keeps no residuals) and lpart[(row nh + h) f/64
// + c] = sum over the tile's 64 j of drop(a) drop(g) wc[h, j], each thread
// summing its 16 j in q order, then the quad in a fixed xor order.
__device__ __forceinline__ void epilogue_gates(const Params& p, float (&d)[64], const Tile& T,
                                               int m0, int warp, int lane, float* stage) {
  // staging: a [16 rows, 64 j] bf16, then g, 32 words per row
  uint32_t* sa = reinterpret_cast<uint32_t*>(stage);
  uint32_t* sg = sa + 16 * 32;
  const int h = T.batch, nh = p.batches, chunk = T.n0 / BN;
  float wc[16];
  gate_bias_wc(p, d, T, lane, wc);
  uint32_t abits[2], bbits[2];
  gate_keep_bits(p, h, chunk, m0 + warp * 16 + lane / 4, lane, abits, bbits);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int srow = lane / 4 + 8 * hh, row = m0 + warp * 16 + srow;   // may be >= M
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int jj = q * 8 + (lane % 4) * 2;
      const float a0 = tanh_fast(d[4 * q + 2 * hh]), a1 = tanh_fast(d[4 * q + 2 * hh + 1]);
      const float g0 = sigmoid_fast(d[4 * (q + 8) + 2 * hh]);
      const float g1 = sigmoid_fast(d[4 * (q + 8) + 2 * hh + 1]);
      const float sc = p.d.scale;
      const float ka0 = (abits[hh] >> (4 * q)) & 1u ? sc : 0.f;
      const float ka1 = (abits[hh] >> (4 * q + 1)) & 1u ? sc : 0.f;
      const float kb0 = (bbits[hh] >> (4 * q)) & 1u ? sc : 0.f;
      const float kb1 = (bbits[hh] >> (4 * q + 1)) & 1u ? sc : 0.f;
      part += (a0 * ka0) * (g0 * kb0) * wc[2 * q];
      part += (a1 * ka1) * (g1 * kb1) * wc[2 * q + 1];
      if (p.ap) {
        const __nv_bfloat162 av = __floats2bfloat162_rn(a0, a1);
        const __nv_bfloat162 gv = __floats2bfloat162_rn(g0, g1);
        sa[srow * 32 + swz(srow, jj / 2)] = *reinterpret_cast<const uint32_t*>(&av);
        sg[srow * 32 + swz(srow, jj / 2)] = *reinterpret_cast<const uint32_t*>(&gv);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (row < p.M && lane % 4 == 0)
      p.lpart[((long long)row * nh + h) * (p.f / 64) + chunk] = part;
  }
  if (!p.ap) return;
  store_gate_rows(sa, sg, p.ap, p.bp, (long long)nh * p.f, (long long)h * p.f + chunk * 64,
                  m0 + warp * 16, lane, p.M);
}

// The gate adjoint of the per-op lane's backward (kernel 18) on the
// recomputed gates (layout: gate_bias_wc). With a' = a ka and g' = g kb
// (train_rows.cuh::gate_bwd's formulas) and dl = dl[row, h] (0 past M):
//   dza = dl wc g' ka (1 - a^2),   dzb = dl wc a' kb g (1 - g),
// written to C = DZG [M, nh 2f] bf16 in the natural per-head [dza | dzb]
// order (p.ldc = nh 2f); and the 64-row tile's column sums of a' g' dl
// (dwc), dza (dba) and dzb (dbb) to lpart + (m0 / 64) ld_part at columns
// h f + j, nh f + h 2f + j and nh f + h 2f + f + j (gate_bwd's layout):
// each thread adds its two rows in order, the warp its 16 rows in a fixed
// xor order, the warpgroup its four warps in warp order through shared
// memory behind a named barrier (one per consumer warpgroup, 1 + half).
__device__ __forceinline__ void epilogue_gates_bwd(const Params& p, float (&d)[64], const Tile& T,
                                                   int m0, int warp, int lane, float* stage,
                                                   int half) {
  uint32_t* sa = reinterpret_cast<uint32_t*>(stage);   // dza [16 rows, 64 j] bf16
  uint32_t* sg = sa + 16 * 32;                          // dzb
  float* ps = stage + 2 * 16 * 32;                      // the warp's sums: dwc, dba, dbb
  const int h = T.batch, nh = p.batches, chunk = T.n0 / BN;
  float wc[16];
  gate_bias_wc(p, d, T, lane, wc);
  const int row0 = m0 + warp * 16 + lane / 4;
  const float dl[2] = {row0 < p.M ? __ldg(p.dl + (long long)row0 * nh + h) : 0.f,
                       row0 + 8 < p.M ? __ldg(p.dl + (long long)(row0 + 8) * nh + h) : 0.f};
  uint32_t abits[2], bbits[2];
  gate_keep_bits(p, h, chunk, row0, lane, abits, bbits);
  float sw[16], sza[16], szb[16];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int srow = lane / 4 + 8 * hh;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int jj = q * 8 + (lane % 4) * 2;
      float za[2], zb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float a = tanh_fast(d[4 * q + 2 * hh + i]);
        const float g = sigmoid_fast(d[4 * (q + 8) + 2 * hh + i]);
        const float ka = (abits[hh] >> (4 * q + i)) & 1u ? p.d.scale : 0.f;
        const float kb = (bbits[hh] >> (4 * q + i)) & 1u ? p.d.scale : 0.f;
        const float ad = a * ka, gd = g * kb, dg = dl[hh] * wc[2 * q + i];
        za[i] = dg * gd * ka * (1.f - a * a);
        zb[i] = dg * ad * kb * g * (1.f - g);
        const float w = (ad * gd) * dl[hh];
        sw[2 * q + i] = hh ? sw[2 * q + i] + w : w;
        sza[2 * q + i] = hh ? sza[2 * q + i] + za[i] : za[i];
        szb[2 * q + i] = hh ? szb[2 * q + i] + zb[i] : zb[i];
      }
      const __nv_bfloat162 av = __floats2bfloat162_rn(za[0], za[1]);
      const __nv_bfloat162 gv = __floats2bfloat162_rn(zb[0], zb[1]);
      sa[srow * 32 + swz(srow, jj / 2)] = *reinterpret_cast<const uint32_t*>(&av);
      sg[srow * 32 + swz(srow, jj / 2)] = *reinterpret_cast<const uint32_t*>(&gv);
    }
  }
  bf16* dz = static_cast<bf16*>(p.C);
  store_gate_rows(sa, sg, dz, dz + p.f, p.ldc, (long long)h * 2 * p.f + chunk * 64,
                  m0 + warp * 16, lane, p.M);
  // the warp's 16 rows: lanes of one lane % 4 hold one column pair
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      sw[i] += __shfl_xor_sync(0xffffffffu, sw[i], o);
      sza[i] += __shfl_xor_sync(0xffffffffu, sza[i], o);
      szb[i] += __shfl_xor_sync(0xffffffffu, szb[i], o);
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int jj = q * 8 + lane * 2;
      *reinterpret_cast<float2*>(ps + jj) = make_float2(sw[2 * q], sw[2 * q + 1]);
      *reinterpret_cast<float2*>(ps + 64 + jj) = make_float2(sza[2 * q], sza[2 * q + 1]);
      *reinterpret_cast<float2*>(ps + 128 + jj) = make_float2(szb[2 * q], szb[2 * q + 1]);
    }
  }
  // the four warps' sums in warp order, then the staging is free again
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
  const float* ps0 = ps - warp * (WARP_OUT_BYTES / 4);
  float* pt = p.lpart + (long long)(m0 / 64) * p.ld_part;
  for (int c = warp * 32 + lane; c < 192; c += 128) {
    const float v = ((ps0[c] + ps0[WARP_OUT_BYTES / 4 + c]) + ps0[2 * (WARP_OUT_BYTES / 4) + c]) +
                    ps0[3 * (WARP_OUT_BYTES / 4) + c];
    const int kind = c / 64, j = chunk * 64 + c % 64;
    pt[kind == 0 ? (long long)h * p.f + j
                 : (long long)nh * p.f + (long long)h * 2 * p.f + (kind - 1) * p.f + j] = v;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
}

template <bool A_MN, bool B_MN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // full[s] at bars + 8 s, empty[s] at + 8 (STAGES + s), order at + 16 STAGES
  const uint32_t out = base + STAGES * STAGE_BYTES;
  const uint32_t bars = out + OUT_BYTES, order = bars + 16 * STAGES;
  const int tid = threadIdx.x, group = tid / 128;
  const int tiles_n = (p.N + BN - 1) / BN;
  constexpr int ROWS = tile_rows<EPI>();
  const int M = p.m_live ? min(p.M, max(*p.m_live, 0)) : p.M;
  const int tiles_mn = (M + ROWS - 1) / ROWS * tiles_n;
  const int tiles = tiles_mn * p.batches * p.splits;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 128);   // one consumer warpgroup per stage
    }
    mbar_init(order, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == 0) {
    // producer: gives its registers to the consumers; one thread keeps the
    // ring full, k tile by k tile, tile by tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Tile T = tile_at<ROWS>(p, tile, tiles_n, tiles_mn);
        const int am = p.a_mn * T.batch + T.m0, bn = p.b_mn * T.batch + T.n0;
        const int ak = p.a_k * T.batch + T.kbeg, bk = p.b_k * T.batch + T.kbeg;
        for (int kt = 0; kt < T.nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
          const uint32_t full = bars + 8 * s, dst = base + s * STAGE_BYTES;
          mbar_expect_tx(full, ROWS * BK * 2 + B_BYTES);
          load_tile<A_MN, ROWS>(dst, &map_a, full, am, ak + kt * BK);
          load_tile<B_MN, BN>(dst + A_BYTES, &map_b, full, bn, bk + kt * BK);
        }
      }
    }
    return;
  }

  // consumers: warpgroup `half` takes the block's tiles j with j % 2 == half;
  // rows 0-63 of a tile accumulate in d0, rows 64-127 of a 128-row tile in
  // d1 (two m64 products per k16 step on the same B, A's second half 8 KB on
  // in either layout)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int half = group - 1, warp = (tid % 128) / 32, lane = tid % 32;
  float* stage = reinterpret_cast<float*>(smem_raw + (out - smem_u32(smem_raw)) +
                                          (half * 4 + warp) * WARP_OUT_BYTES);
  float d0[64], d1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d0[i] = d1[i] = 0.f;
  int j = 0, it = 0;   // it: the ring position of the tile's first k tile
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
    const Tile T = tile_at<ROWS>(p, tile, tiles_n, tiles_mn);
    if ((j & 1) != half) {   // the other warpgroup's tile
      it += T.nk;
      continue;
    }
    // a parity wait sees only one phase ahead: start once the other
    // warpgroup has taken every stage of the previous tile
    if (j > 0) mbar_wait(order, (j - 1) & 1);
    for (int kt = 0; kt < T.nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(bars + 8 * s, (it / STAGES) & 1);
      const uint32_t a = base + s * STAGE_BYTES, b = a + A_BYTES;
      fence_acc(d0);
      if constexpr (ROWS == 128) fence_acc(d1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        const uint64_t db = desc_sw128<B_MN>(b, k);
        const int acc = (kt > 0 || k > 0) ? 1 : 0;
        wgmma_m64n128k16<A_MN, B_MN>(d0, desc_sw128<A_MN>(a, k), db, acc);
        if constexpr (ROWS == 128)
          wgmma_m64n128k16<A_MN, B_MN>(d1, desc_sw128<A_MN>(a + MN_BOX_BYTES, k), db, acc);
      }
      wgmma_commit();
      fence_acc(d0);
      if constexpr (ROWS == 128) fence_acc(d1);
      // the previous k tile's products are done: hand its stage back
      wgmma_wait<1>();
      fence_acc(d0);
      if constexpr (ROWS == 128) fence_acc(d1);
      if (kt > 0) mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
    }
    // every stage of the tile is taken: the other warpgroup may start its
    // tile while these products finish
    mbar_arrive(order);
    wgmma_wait<0>();
    fence_acc(d0);
    if constexpr (ROWS == 128) fence_acc(d1);
    mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
    if constexpr (EPI == EPI_GATES) {
      epilogue_gates(p, d0, T, T.m0, warp, lane, stage);
    } else if constexpr (EPI == EPI_GATES_BWD) {
      epilogue_gates_bwd(p, d0, T, T.m0, warp, lane, stage, half);
    } else {
      epilogue_plain<EPI>(p, d0, T, T.m0, warp, lane, stage);
      epilogue_plain<EPI>(p, d1, T, T.m0 + 64, warp, lane, stage);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Internal linkage: one pointer per library that includes this header.
static EncodeTiledFn encode_tiled = nullptr;

inline EncodeTiledFn encode_fn() {
  if (!encode_tiled) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h) encode_tiled = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return encode_tiled;
}

// Tensor map of a row-major bf16 [rows, cols] matrix with row stride ld,
// boxes of [box_rows, 64 columns].
inline bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* p, long long rows,
                     long long cols, long long ld, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64u, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg

// One operand of wg_gemm: a row-major bf16 [rows, cols] matrix with row
// stride ld, the tensor map's extent. K-major: rows are m (or n), columns k;
// MN-major: rows are k, columns m (or n). Batch z's tile is off_mn z along m
// (or n) and off_k z along k.
struct WgOperand {
  const bf16* p;
  long long ld, rows, cols;
  int off_mn, off_k;
};

// Whether the kernel can take the operand (MN: its rows are k): 16-byte
// base and rows, extents TMA can address.
template <bool MN>
inline bool wg_operand_ok(const WgOperand& o, int K) {
  const long long kext = MN ? o.rows : o.cols;
  return o.p && reinterpret_cast<uintptr_t>(o.p) % 16 == 0 && o.ld % 8 == 0 && o.ld >= o.cols &&
         o.rows >= 1 && o.cols >= 1 && o.rows < (1LL << 31) && o.cols < (1LL << 31) &&
         o.off_mn >= 0 && o.off_k >= 0 &&
         // a k tile past K must read zeros: the map ends at K and no batch
         // starts further along k
         (K % wg::BK == 0 || (o.off_k == 0 && kext == K));
}

// C = epi(A . B^T + bias), batched and split as `p` says (see the header).
// The caller sets p.C, ldc, strideC, bias, strideBias, M, N, K, batches,
// splits, beta, act_split, m_live and, for EPI_GATES and EPI_GATES_BWD, the
// gate fields; the launcher fills the coordinate offsets and kchunk. Returns
// cudaErrorInvalidValue for anything the kernel cannot take: misaligned or
// unsupported operands (16-byte aligned bases, row strides a multiple of 8
// elements), an odd N, a misaligned C (a 16-byte base; ldc and strideC
// multiples of 4 for f32, of 8 for bf16 and EPI_GATES_BWD), split-K with a
// bias, beta or an activation.
template <bool A_MN, bool B_MN, int EPI>
inline cudaError_t wg_gemm(const WgOperand& A, const WgOperand& B, wg::Params p,
                           cudaStream_t st) {
  // rows leave as 16-byte vectors (the staged epilogues)
  const int align = 16, step = EPI == wg::EPI_BF16 ? 8 : 4;
  bool ok = p.M >= 1 && p.N >= 1 && p.K >= 1 && p.batches >= 1 && p.splits >= 1 &&
            p.N % 2 == 0 && p.ldc % step == 0 && p.strideC % step == 0 && p.ldc >= p.N &&
            wg_operand_ok<A_MN>(A, p.K) && wg_operand_ok<B_MN>(B, p.K) &&
            (EPI == wg::EPI_GATES || (p.C && reinterpret_cast<uintptr_t>(p.C) % align == 0)) &&
            (p.splits == 1 || (EPI == wg::EPI_F32 && !p.beta && !p.bias && p.act_split < 0));
  if (EPI >= wg::EPI_GATES)
    ok = ok && p.splits == 1 && p.f % 64 == 0 && p.N == 2 * p.f && p.t >= 1 && p.bias &&
         p.wc && p.lpart;
  if (EPI == wg::EPI_GATES)
    ok = ok && !p.ap == !p.bp && reinterpret_cast<uintptr_t>(p.ap) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p.bp) % 4 == 0;
  if (EPI == wg::EPI_GATES_BWD)
    ok = ok && p.dl && p.ldc % 8 == 0 && p.ldc >= (long long)p.batches * p.N &&
         p.ld_part >= 3LL * p.batches * p.f;
  if (!ok) return cudaErrorInvalidValue;
  p.a_mn = A.off_mn; p.a_k = A.off_k;
  p.b_mn = B.off_mn; p.b_k = B.off_k;
  // pieces of whole k tiles; every piece gets at least one
  const int ktiles = (p.K + wg::BK - 1) / wg::BK;
  const int per = (ktiles + p.splits - 1) / p.splits;
  p.kchunk = per * wg::BK;
  p.splits = (ktiles + per - 1) / per;
  constexpr int rows = wg::tile_rows<EPI>();
  const long long tiles = (long long)((p.M + rows - 1) / rows) *
                          ((p.N + wg::BN - 1) / wg::BN) * p.batches * p.splits;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const wg::EncodeTiledFn enc = wg::encode_fn();
  if (!enc) return cudaErrorInitializationError;
  CUtensorMap map_a, map_b;
  if (!wg::make_map(enc, &map_a, A.p, A.rows, A.cols, A.ld, A_MN ? wg::BK : rows) ||
      !wg::make_map(enc, &map_b, B.p, B.rows, B.cols, B.ld, B_MN ? wg::BK : wg::BN))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // set on every launch: a function-local static would be one object for
  // every library of the process that includes this header
  err = cudaFuncSetAttribute(wg::gemm_kernel<A_MN, B_MN, EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  wg::gemm_kernel<A_MN, B_MN, EPI><<<grid, wg::THREADS, wg::SMEM_BYTES, st>>>(map_a, map_b, p);
  return cudaGetLastError();
}

// Output defaults of a plain product: no batches, no split, no activation.
inline wg::Params wg_params(void* C, long long ldc, const float* bias, int M, int N, int K) {
  wg::Params p{};
  p.C = C;
  p.ldc = ldc;
  p.strideC = (long long)M * ldc;
  p.bias = bias;
  p.M = M; p.N = N; p.K = K;
  p.batches = 1;
  p.splits = 1;
  p.act_split = -1;
  return p;
}

// C [M, N] bf16 = A [M, K] . B [N, K]^T + bias [N] (bias f32, may be null).
// Needs K % 8 == 0 (TMA's 16-byte row stride), N % 8 == 0, and A, B and C
// 16-byte aligned; returns cudaErrorInvalidValue otherwise.
inline cudaError_t gemm_tn_wgmma(const bf16* A, const bf16* B, const float* bias, bf16* C, int M,
                                 int N, int K, cudaStream_t st) {
  const WgOperand a{A, K, M, K, 0, 0}, b{B, K, N, K, 0, 0};
  return wg_gemm<false, false, wg::EPI_BF16>(a, b, wg_params(C, N, bias, M, N, K), st);
}

// Split count of a weight-gradient product over K tokens: as many pieces as
// keep the launch within SPLIT_TARGET_TILES output tiles (one wave of two
// tiles per SM), each piece at least 8 k tiles, at most 64 pieces.
inline int wg_wgrad_splits(int M, int N, int K, int batches) {
  const long long tiles =
      (long long)((M + wg::BM - 1) / wg::BM) * ((N + wg::BN - 1) / wg::BN) * batches;
  long long s = wg::SPLIT_TARGET_TILES / tiles;
  const long long kmax = K / (8 * wg::BK);
  if (s > kmax) s = kmax;
  if (s > 64) s = 64;
  if (s < 1) return 1;
  const int ktiles = (K + wg::BK - 1) / wg::BK, per = (ktiles + (int)s - 1) / (int)s;
  return (ktiles + per - 1) / per;   // as wg_gemm rounds them
}

// Floats of split-K workspace wg_wgrad needs (0 when it writes out directly).
inline long long wg_wgrad_work_floats(int M, int N, int K, int batches) {
  const int s = wg_wgrad_splits(M, N, K, batches);
  return s > 1 ? (long long)s * batches * M * N : 0;
}

// Weight gradient out[batch] [Mo, No] f32 = sum over K tokens of A(m, k)
// B(n, k), both operands MN-major (token-major rows); split over the tokens
// into `work` and reduced in split order, or written directly when one piece
// fills the card.
inline cudaError_t wg_wgrad(const WgOperand& A, const WgOperand& B, int Mo, int No, int K,
                            int batches, float* out, float* work, cudaStream_t st) {
  wg::Params p = wg_params(out, No, nullptr, Mo, No, K);
  p.batches = batches;
  p.splits = wg_wgrad_splits(Mo, No, K, batches);
  if (p.splits == 1) return wg_gemm<true, true, wg::EPI_F32>(A, B, p, st);
  p.C = work;
  const cudaError_t err = wg_gemm<true, true, wg::EPI_F32>(A, B, p, st);
  if (err != cudaSuccess) return err;
  const long long n = (long long)Mo * No;
  splitk_reduce_kernel<<<(unsigned)((n * batches + 255) / 256), 256, 0, st>>>(work, out, n,
                                                                            p.splits, batches);
  return cudaGetLastError();
}

}  // namespace madeleine
