// A streaming bf16 GEMM for Hopper: TMA loads, wgmma math, one persistent
// block per SM.
//
//   C[M, N] (bf16) = A[M, K] . B[N, K]^T + bias[N]   (f32 accumulation and bias)
//
// A and B are both K-major (row-major with K contiguous): wgmma's native bf16
// "TN" case, so nothing is transposed. The token projector (linear_tok.cu)
// is its first user: y [M, E] times Wt [dout, E].
//
// Design (Hopper's usual shape, hopper-kernels guide section 1):
//   - output tiles of 64 rows x 128 columns, k tiles of 64 (128 bytes of
//     bf16: one row of the 128-byte swizzle), a ring of STAGES stages of A
//     [64, 64] and B [128, 64] tiles in shared memory, each stage with a
//     "full" and an "empty" mbarrier;
//   - warpgroup 0 is the producer: one thread starts cp.async.bulk.tensor
//     (TMA) loads with 128-byte swizzle, tile after tile; the hardware
//     zero-fills rows and columns outside the tensors, so the ragged M and N
//     tails and a K that is no multiple of 64 need no code;
//   - warpgroups 1 and 2 are the consumers and take the block's tiles in
//     turn ("ping-pong"): per k tile four wgmma.mma_async m64n128k16 from
//     shared-memory descriptors whose swizzle matches the TMA's, f32
//     accumulators in registers, one group kept in flight while the next
//     stage is awaited; then the epilogue adds the bias, rounds to bf16 and
//     stores, masking rows >= M and columns >= N, while the other warpgroup
//     runs the next tile's products. (With both warpgroups on one tile the
//     epilogue stalled the products: a fifth to a sixth of the consumers'
//     time on an H100.) An "order" mbarrier starts a warpgroup's tile only
//     once the other has taken every stage of the previous one, since a
//     parity wait can only look one phase ahead;
//   - gridDim = min(tiles, SMs): each block walks the tiles blockIdx.x,
//     + gridDim.x, ... with the producer running ahead across tiles.
// No split-K and no atomics: every output element comes from one warpgroup
// in a fixed k order, so two launches give bitwise-equal results.
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

namespace madeleine {
namespace wg {

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int STAGES = 6;
constexpr int THREADS = 384;                   // producer warpgroup + 2 consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;           // A tile [64, 64]: 8 KB
constexpr int B_BYTES = BN * BK * 2;           // B tile [128, 64]: 16 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// + full, empty and order barriers, + slack to align the ring to 1024 bytes
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8 + 1024;

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

// One 2-D tile (coordinates innermost first) into shared memory; completion
// is reported to the mbarrier as transaction bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile as TMA writes it with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (stride byte offset),
// leading byte offset unused (1), layout type 1 (128B swizzle). The tile
// base is 1024-byte aligned; a k16 step advances the address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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

// d (+)= A[64 x 16] . B[128 x 16]^T, both from shared memory; scale_d 0
// overwrites d.
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
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_tn_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ C, int M, int N,
               int K) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // full[s] at bars + 8 s, empty[s] at + 8 (STAGES + s), order at + 16 STAGES
  const uint32_t bars = base + STAGES * STAGE_BYTES, order = bars + 16 * STAGES;
  const int tid = threadIdx.x, group = tid / 128;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int nk = (K + BK - 1) / BK;

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
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
          const uint32_t full = bars + 8 * s, dst = base + s * STAGE_BYTES;
          mbar_expect_tx(full, STAGE_BYTES);
          tma_load_2d(dst, &map_a, full, kt * BK, m0);
          tma_load_2d(dst + A_BYTES, &map_b, full, kt * BK, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup `half` takes the block's tiles j with j % 2 == half
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int half = group - 1, warp = (tid % 128) / 32, lane = tid % 32;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  int j = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
    if ((j & 1) != half) continue;   // the other warpgroup's tile
    // a parity wait sees only one phase ahead: start once the other
    // warpgroup has taken every stage of the previous tile
    if (j > 0) mbar_wait(order, (j - 1) & 1);
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    int it = j * nk;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(bars + 8 * s, (it / STAGES) & 1);
      const uint32_t a = base + s * STAGE_BYTES, b = a + A_BYTES;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma_m64n128k16(d, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k),
                         (kt > 0 || k > 0) ? 1 : 0);
      wgmma_commit();
      fence_acc(d);
      // the previous k tile's products are done: hand its stage back
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0) mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
    mbar_arrive(order);

    // epilogue: fragment i of the m64nN accumulator is row 16 warp + lane / 4
    // (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
    const int r = m0 + warp * 16 + lane / 4;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int c = n0 + q * 8 + (lane % 4) * 2;
      if (c >= N) continue;   // N is even, so c + 1 < N too
      const float b0 = bias ? bias[c] : 0.f, b1 = bias ? bias[c + 1] : 0.f;
      if (r < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (long long)r * N + c) =
            __floats2bfloat162_rn(d[4 * q] + b0, d[4 * q + 1] + b1);
      if (r + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (long long)(r + 8) * N + c) =
            __floats2bfloat162_rn(d[4 * q + 2] + b0, d[4 * q + 3] + b1);
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

// Tensor map of a row-major bf16 [rows, K] operand, boxes of [box_rows, 64 k].
inline bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* p, int rows, int K,
                     int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg

// C [M, N] bf16 = A [M, K] . B [N, K]^T + bias [N] (bias f32, may be null).
// Needs K % 8 == 0 (TMA's 16-byte row stride), N even, A and B 16-byte
// aligned and C 4-byte aligned; returns cudaErrorInvalidValue otherwise.
inline cudaError_t gemm_tn_wgmma(const __nv_bfloat16* A, const __nv_bfloat16* B,
                                 const float* bias, __nv_bfloat16* C, int M, int N, int K,
                                 cudaStream_t st) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || N % 2 || reinterpret_cast<uintptr_t>(A) % 16 ||
      reinterpret_cast<uintptr_t>(B) % 16 || reinterpret_cast<uintptr_t>(C) % 4)
    return cudaErrorInvalidValue;
  const wg::EncodeTiledFn enc = wg::encode_fn();
  if (!enc) return cudaErrorInitializationError;
  CUtensorMap map_a, map_b;
  if (!wg::make_map(enc, &map_a, A, M, K, wg::BM) || !wg::make_map(enc, &map_b, B, N, K, wg::BN))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // set on every launch: a function-local static would be one object for
  // every library of the process that includes this header
  err = cudaFuncSetAttribute(wg::gemm_tn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((M + wg::BM - 1) / wg::BM) * ((N + wg::BN - 1) / wg::BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  wg::gemm_tn_kernel<<<grid, wg::THREADS, wg::SMEM_BYTES, st>>>(map_a, map_b, bias, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace madeleine
