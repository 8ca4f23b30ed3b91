// f32-accurate products on Hopper's TF32 tensor cores: the three-term split,
// TF32 wgmma from shared memory, and f32 tensor maps with 128-byte swizzle.
//
// The split. A TF32 operand keeps f32's exponent and the top 10 mantissa
// bits. An f32 x is cut into two TF32 values,
//   x_hi = tf32(x)          (cvt.rna.tf32.f32: nearest, ties away from 0)
//   x_lo = tf32(x - x_hi)   (x - x_hi is exact in f32)
// with |x - x_hi - x_lo| <= 2^-22 |x|, and a product of two f32 operands is
//   y . W ~ y_lo . W_hi + y_hi . W_lo + y_hi . W_hi
// (the dropped y_lo . W_lo is below 2^-22 of the product), each term one
// TF32 wgmma. Every term multiplies exact TF32 values, so what the product
// loses is the dropped term and the accumulator's rounding, where the
// TPU's Precision.HIGHEST takes a similar multi-pass route over bf16.
//
// The accumulator. The tensor cores' f32 accumulation is not a chain of
// FMAs rounded to nearest: chained in one accumulator over a 512-deep
// product (192 TF32 wgmmas, three terms of 64 k8 steps), K2's pool missed
// its f32 bar (atol 1e-5) by 2.75e-5 where the logits spread by tens of
// units (an H100). So each 32-deep k tile starts a fresh partial
// (split_ktile: the small terms of all its k8 steps first, while the
// partial is small, then the four hi . hi steps), and the caller adds the
// partials in k order in registers, rounded to nearest: four steps of the
// large term in the tensor cores' accumulator a tile, not 192 in a chain.
// The same case then met the bar.
//
// TF32 wgmma takes both operands K-major from shared memory (no transpose
// immediates); a k8 step is 32 bytes deep, as bf16's k16, so the 128-byte
// swizzled tiles and descriptors of gemm_wgmma.cuh carry over unchanged with
// 32 floats where bf16 has 64 elements per swizzle row.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"   // mbarriers, TMA, descriptors, the tensor-map encoder

namespace madeleine {
namespace tf32 {

constexpr int KT = 32;   // f32 k per 128-byte swizzle row: one k tile

// x rounded to TF32 (its low 13 mantissa bits zero), nearest, ties away.
__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// (hi, lo) of the split in place: v becomes hi, lo gets tf32(v - hi).
__device__ __forceinline__ void split(float& v, float& lo) {
  const float hi = round_tf32(v);
  lo = round_tf32(v - hi);
  v = hi;
}

// Shared-memory writes of the generic proxy made visible to the async proxy
// (wgmma's operand reads, and later TMA writes to the same bytes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One 3-D box (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// d (+)= A[64 x 8] . B[128 x 8]^T in TF32, both K-major tiles in shared
// memory (descriptors of wg::desc_sw128<false>, one k8 step = index k);
// scale_d 0 overwrites d. The accumulator layout is the bf16 m64n128's.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
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

// The three-term split product of one k tile (KT deep) into a fresh d: the
// A rows (hi at a_hi, lo at a_lo) times the B rows (b_hi, b_lo), the terms
// lo.hi and hi.lo of every k8 step first, then hi.hi (see above).
__device__ __forceinline__ void split_ktile(float (&d)[64], uint32_t a_hi, uint32_t a_lo,
                                            uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int k = 0; k < KT / 8; ++k) {
    wgmma_m64n128k8(d, wg::desc_sw128<false>(a_lo, k), wg::desc_sw128<false>(b_hi, k),
                    k == 0 ? 0 : 1);
    wgmma_m64n128k8(d, wg::desc_sw128<false>(a_hi, k), wg::desc_sw128<false>(b_lo, k), 1);
  }
#pragma unroll
  for (int k = 0; k < KT / 8; ++k)
    wgmma_m64n128k8(d, wg::desc_sw128<false>(a_hi, k), wg::desc_sw128<false>(b_hi, k), 1);
}

// Tensor map of a row-major f32 tensor of `rank` (2 or 3) dimensions,
// innermost first (dims[0] contiguous), strides in bytes of dims 1.., boxes
// of [32 floats, box[1] (, box[2])] with 128-byte swizzle; zeros outside.
inline bool make_map_f32(wg::EncodeTiledFn enc, CUtensorMap* map, const float* p, int rank,
                         const long long* dims, const long long* strides_bytes,
                         const int* box) {
  cuuint64_t d[3], s[2];
  cuuint32_t bx[3], elem[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    if (i) s[i - 1] = (cuuint64_t)strides_bytes[i - 1];
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(p), d, s, bx, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tf32
}  // namespace madeleine
