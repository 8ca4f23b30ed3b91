// Device helpers shared by the train kernels' forward (K6) and backward (K7).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "philox.cuh"

namespace madeleine {

constexpr float TRAIN_LN_EPS = 1e-5f;
constexpr float INV_SQRT2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;
// A masked logit carries a bias of -1e30; anything at or below this is masked.
constexpr float TRAIN_MASKED = -1e29f;
constexpr int ROW_TILE = 64;  // rows per block of the column-sum kernels

// The most rows (b t) one call of a train kernel takes: rows are counted in
// 32 bits, and the launches round them up to a tile of at most 256 rows
// (the grids' (M + rows - 1) / rows) without leaving int. Every element
// offset is 64-bit. ops/encoder_train.py::MAX_BLOCK_ROWS mirrors it.
constexpr long long MAX_TRAIN_ROWS = INT_MAX - 255;

// Whether a call of b bags of t rows at global bag offset row_offset fits
// the train kernels' 32-bit counts: at most MAX_TRAIN_ROWS rows and the
// global bags row_offset + b below 2^31. A larger call is refused as
// cudaErrorInvalidValue and runs in blocks of whole bags
// (ops/encoder_train.py::whole_bag_blocks).
inline bool rows_fit(long long b, long long t, long long row_offset) {
  return b >= 1 && t >= 1 && row_offset >= 0 && b * t <= MAX_TRAIN_ROWS &&
         row_offset + b <= INT_MAX;
}

// Gaussian CDF: gelu(v) = v * Phi(v) (exact erf); gelu'(v) = Phi(v) + v * phi(v).
__device__ __forceinline__ float gauss_cdf(float v) { return 0.5f * (1.f + erff(v * INV_SQRT2)); }
__device__ __forceinline__ float gauss_pdf(float v) { return expf(-0.5f * v * v) * INV_SQRT_2PI; }

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&a);
  r.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the warps [w0, w0 + nw) of the block, the same fixed order
// in every thread. red holds one float per warp; ends synchronised, so red
// may be reused by the next call.
__device__ __forceinline__ float group_sum(float v, float* red, int w0, int nw) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w0 + w];
  __syncthreads();
  return s;
}

// out[c] = sum over tiles of part[tile * ld + col0 + c] in a fixed order:
// thread row y of the 32 x 8 block sums tiles y, y + 8, ... in turn, then the
// 8 row sums are added in row order.
__global__ void colsum_reduce_kernel(const float* __restrict__ part, long long ld, int col0,
                                     int ncols, int ntiles, float* __restrict__ out) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x, y = threadIdx.y;
  float s = 0.f;
  if (c < ncols)
    for (int i = y; i < ntiles; i += 8) s += part[(long long)i * ld + col0 + c];
  red[y][threadIdx.x] = s;
  __syncthreads();
  if (y == 0 && c < ncols) {
    float t = 0.f;
    for (int r = 0; r < 8; ++r) t += red[r][threadIdx.x];
    out[c] = t;
  }
}

inline cudaError_t colsum_reduce(const float* part, long long ld, int col0, int ncols,
                                 int ntiles, float* out, cudaStream_t stream) {
  colsum_reduce_kernel<<<(ncols + 31) / 32, dim3(32, 8), 0, stream>>>(part, ld, col0, ncols,
                                                                       ntiles, out);
  return cudaGetLastError();
}

}  // namespace madeleine
