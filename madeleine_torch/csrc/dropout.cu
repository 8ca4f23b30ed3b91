// Standalone inverted dropout (row 21), bf16 or f32, forward and backward.
//
// Replaces madeleine_tpu/ops/dropout.py::_dropout_kernel (called from
// _dropout_pallas; the custom VJP's backward calls it again on the
// cotangent with the same seed). Over x [m, n], row i of n columns:
//   out[i, c] = x[i, c] * keep(c), computed in f32 and cast to x's dtype,
//   keep(c) = scale when bits >= thr, else 0,
//   bits = word (c % 4) of Philox4x32-10(counter (c / 4, 0, row_offset + i,
//          stream), key (seed, 0))   (philox.cuh, ops/prng.py)
// The backward is the same kernel on the cotangent: the mask is a function
// of (seed, global row, stream, column), so nothing is saved.
//
// What bounds it on an H100: bytes, x read and out written once: 0.326 ms
// for [133120, 2048] bf16 at 3.35 TB/s. Ten Philox rounds per four columns
// are about 0.8 integer operations per byte in bf16, within the card's rate.
// Design: one thread per four columns of a row, all four Philox words used,
// with one 8-byte (bf16) or 16-byte (f32) load and store when n is a
// multiple of 4, element loads otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long m, int n,
               madeleine::Dropout d, long long row_offset, uint32_t stream) {
  const int n4 = (n + 3) / 4;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= m * n4) return;
  const long long i = idx / n4;
  const int c4 = (int)(idx - i * n4);
  float k[4];
  madeleine::keep4(d, c4, 0, (int)(row_offset + i), (int)stream, k);
  const size_t base = (size_t)i * n + (size_t)c4 * 4;
  if (VEC) {
    float v[4];
    load4(x + base, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] *= k[j];
    store4(out + base, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c4 * 4 + j < n) from_f32(out + base + j, to_f32(x[base + j]) * k[j]);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long m, int n, madeleine::Dropout d,
                   long long row_offset, uint32_t stream, cudaStream_t st) {
  const long long groups = m * ((n + 3) / 4);
  const unsigned blocks = (unsigned)((groups + THREADS - 1) / THREADS);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  if (vec)
    dropout_kernel<T, true><<<blocks, THREADS, 0, st>>>(static_cast<const T*>(x),
                                                         static_cast<T*>(out), m, n, d,
                                                         row_offset, stream);
  else
    dropout_kernel<T, false><<<blocks, THREADS, 0, st>>>(static_cast<const T*>(x),
                                                          static_cast<T*>(out), m, n, d,
                                                          row_offset, stream);
  return cudaGetLastError();
}

}  // namespace

// p: x [m, n], out [m, n], both bf16 when is_bf16, else f32. dims: m, n,
// is_bf16, seed, row_offset, threshold, stream; scales: the keep scale.
// Returns a cudaError_t.
extern "C" int dropout_forward(void** p, const long long* dims, const float* scales,
                               void* stream) {
  const long long m = dims[0];
  const int n = (int)dims[1], is_bf16 = (int)dims[2];
  const madeleine::Dropout d{(uint32_t)dims[3], (uint32_t)dims[5], scales[0]};
  if (m < 1 || n < 1 || d.thr == 0u) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(p[0], p[1], m, n, d, dims[4], (uint32_t)dims[6], st);
  return (int)launch<float>(p[0], p[1], m, n, d, dims[4], (uint32_t)dims[6], st);
}
