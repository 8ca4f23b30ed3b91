// Batched f32 SIMT tile product for Hopper (K14's products): one block of
// 256 threads computes one 128 x 128 tile of out(i, j) = sum_k X(i, k) Y(k, j)
// in full f32 (FFMA, no tensor cores: the GOT loss runs at full f32).
//
// Operands. X(i, k) = X.p[i * X.sx + k * X.sk] for i < X.rows, and Y(k, j) =
// Y.p[j * Y.sx + k * Y.sk] for j < Y.rows: either operand K-major (sk == 1)
// or M/N-major (sx == 1), chosen by template parameter, so a transposed
// operand (gamma^T, a product's P^T) is read in place. Each stage in shared
// memory holds BK = 16 k-rows of both tiles, [k][x] with x contiguous, so a
// thread's fragments are float4 reads whatever the operand's layout.
//
// Loads. Stages are fetched with cp.async into a ring of STAGES = 4, three
// in flight while one is multiplied (cp.async.commit_group / wait_group and
// one block barrier per stage). An M/N-major operand is copied in 16-byte
// chunks along x when its rows start on 16 bytes, else element by element; a
// K-major one element by element into its transposed place (lanes 8 k by 4
// rows, so the global reads are 32-byte sectors and the shared stores hit
// 32 banks). Anything beyond the operand (x >= rows, k >= K) is zero-filled
// by the copy (src-size 0), so ragged edges need no other code.
//
// Compute. Thread (ty, tx) of the 16 x 16 grid holds the 8 x 8 outputs at
// rows {4 ty .. 4 ty + 3, 64 + 4 ty ..} and columns {4 tx .., 64 + 4 tx ..}
// in registers: per k four float4 reads feed 64 FFMA, so the FFMA pipe, not
// shared memory, sets the pace. At 256 threads, 2 blocks per SM, the 64
// accumulators fit the 128 registers a thread may hold.
//
// Order. Every output's k runs in order from 0 with fmaf from 0.f, no
// split-K; the zero-filled tail adds exact zeros. So the outputs equal, bit
// for bit, any product that sums k in order with fmaf (ipot_common.cuh's
// block_gemm: K14's first design).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace madeleine_gemm_f32 {

constexpr int TILE = 128;          // output tile, rows and columns
constexpr int BK = 16;             // k per stage
constexpr int STAGES = 4;          // the cp.async ring
constexpr int THREADS = 256;
static_assert(BK % 8 == 0 && TILE == 128 && THREADS == 256, "the loaders' lane maps");
constexpr int LD = TILE + 4;       // padded stage row, floats (16-byte aligned)
constexpr int STAGE_FLOATS = 2 * BK * LD;
constexpr size_t SMEM_BYTES = sizeof(float) * STAGES * STAGE_FLOATS;

// element (x, k) at p[x * sx + k * sk], x < rows
struct Operand {
  const float* p;
  long long sx, sk;
  int rows;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes from src into dst, or a zero when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes into dst, `bytes` of them from src (16-byte aligned), the rest zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage st[kk * LD + x] = o(x0 + x, k0 + kk) for x < TILE, kk < BK (zero
// outside the operand). vec: 16-byte chunks along x (M/N-major only).
template <bool KMAJOR>
__device__ __forceinline__ void load_stage(float* st, const Operand& o, int x0, int k0, int K,
                                           bool vec) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (KMAJOR) {
#pragma unroll
    for (int q = 0; q < TILE * BK / THREADS; ++q) {
      const int kk = (lane & 7) + 8 * (q % (BK / 8));
      const int x = (lane >> 3) + 4 * warp + 32 * (q / (BK / 8));
      const int gx = x0 + x, gk = k0 + kk;
      const bool ok = gx < o.rows && gk < K;
      cp_async4(st + kk * LD + x, ok ? o.p + (size_t)gx * o.sx + gk : o.p, ok);
    }
  } else if (vec) {
#pragma unroll
    for (int q = 0; q < TILE * BK / (4 * THREADS); ++q) {
      const int e = tid + THREADS * q, kk = e >> 5, x = (e & 31) * 4;
      const int gx = x0 + x, gk = k0 + kk, left = o.rows - gx;
      const int bytes = gk < K && left > 0 ? 4 * (left < 4 ? left : 4) : 0;
      cp_async16(st + kk * LD + x, bytes ? o.p + (size_t)gk * o.sk + gx : o.p, bytes);
    }
  } else {
#pragma unroll
    for (int q = 0; q < TILE * BK / THREADS; ++q) {
      const int e = tid + THREADS * q, kk = e / TILE, x = e % TILE;
      const int gx = x0 + x, gk = k0 + kk;
      const bool ok = gx < o.rows && gk < K;
      cp_async4(st + kk * LD + x, ok ? o.p + (size_t)gk * o.sk + gx : o.p, ok);
    }
  }
}

// whether an M/N-major operand's rows (k) all start on 16 bytes
__device__ __forceinline__ bool rows_aligned(const Operand& o) {
  return o.sk % 4 == 0 && (reinterpret_cast<uintptr_t>(o.p) & 15) == 0;
}

// The sums of the tile of out at (i0, j0) into acc: X K-major when XK, Y
// K-major when YK. acc[r][c] is out(i, j) at row i = i0 + 64 (r / 4) + 4 ty
// + r % 4 and column j = j0 + 64 (c / 4) + 4 tx + c % 4 of thread (ty, tx) =
// (tid / 16, tid % 16), whatever lies beyond the operands included (zeros).
// pre() runs once the first stages are in flight (work that overlaps their
// loads). smem: SMEM_BYTES, 16-byte aligned. Starts and ends with every
// thread past a block barrier.
template <bool XK, bool YK, class Pre>
__device__ __forceinline__ void tile_accumulate(const Operand& X, const Operand& Y, int K, int i0,
                                                int j0, float* smem, Pre pre,
                                                float (&acc)[8][8]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool xvec = !XK && rows_aligned(X), yvec = !YK && rows_aligned(Y);
  const int KT = (K + BK - 1) / BK;
  auto load = [&](int kt) {
    float* st = smem + (kt % STAGES) * STAGE_FLOATS;
    load_stage<XK>(st, X, i0, kt * BK, K, xvec);
    load_stage<YK>(st + BK * LD, Y, j0, kt * BK, K, yvec);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s);
    cp_commit();
  }
  pre();
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();   // stage kt has landed (this thread's copies)
    __syncthreads();         // ... everyone's; and stage kt - 1 is consumed
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1);
    cp_commit();
    const float* Xs = smem + (kt % STAGES) * STAGE_FLOATS;
    const float* Ys = Xs + BK * LD;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(Xs + kk * LD + 4 * ty);
      const float4 x1 = *reinterpret_cast<const float4*>(Xs + kk * LD + 64 + 4 * ty);
      const float4 y0 = *reinterpret_cast<const float4*>(Ys + kk * LD + 4 * tx);
      const float4 y1 = *reinterpret_cast<const float4*>(Ys + kk * LD + 64 + 4 * tx);
      const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float b[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring may be reused after return
}

// The tile of out at (i0, j0) (tile_accumulate's layout and pre); epi(i, j,
// v) gets the four outputs (i, j .. j + 3) for every row i < X.rows and every
// j < Y.rows that is a multiple of 4 (v[c] for j + c beyond Y.rows is to be
// dropped).
template <bool XK, bool YK, class Pre, class Epi>
__device__ __forceinline__ void tile_product(const Operand& X, const Operand& Y, int K, int i0,
                                             int j0, float* smem, Pre pre, Epi epi) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
  tile_accumulate<XK, YK>(X, Y, K, i0, j0, smem, pre, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + 64 * (r >> 2) + 4 * ty + (r & 3);
    if (i >= X.rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + 64 * h + 4 * tx;
      if (j < Y.rows) {
        const float v[4] = {acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                            acc[r][4 * h + 3]};
        epi(i, j, v);
      }
    }
  }
}

// out[i * ld + j + c] = s * v[c] for the j + c < N, float4 when vec
__device__ __forceinline__ void store4(float* out, size_t ld, int i, int j, int N, float s,
                                       const float (&v)[4], bool vec) {
  float* o = out + (size_t)i * ld + j;
  if (vec && j + 3 < N) {
    *reinterpret_cast<float4*>(o) = make_float4(s * v[0], s * v[1], s * v[2], s * v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j + c < N) o[c] = s * v[c];
  }
}

// tiles of TILE covering x
__host__ __device__ inline int tiles(int x) { return (x + TILE - 1) / TILE; }

}  // namespace madeleine_gemm_f32
