// Streaming masked softmax pool (kernel K3), bf16 or f32 token features.
//
// Replaces madeleine_tpu/ops/attn_pool.py::_pool_kernel (called from
// _pool_pallas). Input: y [b, t, E = nh*e] head-major and the pre-masked f32
// logits l [b, t, nh] (masked and padded tokens at NEG_INF). Per bag and head:
//   pooled[b, h*e:(h+1)*e] = sum_t softmax_t(l[b, :, h]) * y[b, t, h*e:(h+1)*e]
// accumulated in f32 and written in y's dtype.
//
// What bounds it on an H100: bytes. Each token row of y is read once and used
// for one multiply-add per element (0.5 FLOP per byte in bf16), so the bound
// is y plus l over 3.35 TB/s: 0.163 ms for [65, 2048, 2048] bf16.
//
// Design: the TPU kernel carries (max, sum, weighted sum) across token blocks
// of one sequential grid. Here each block owns a tile of 64 tokens and up to
// 256 * VEC columns of one bag, so a bag's tiles run in parallel: the block
// stages the tile's logits in shared memory, one warp per head forms the
// tile's max over unmasked tokens and the weights p = exp(l - max) with their
// sum (a fixed butterfly order), then each thread streams its VEC columns
// (16-byte loads, neighbouring threads on neighbouring addresses) over the
// tile's rows and writes the tile's weighted sum. pool_combine.cuh (K1/K2's
// merge) then combines the tiles in index order: no atomics, so two launches
// give bitwise-equal output. A tile with no unmasked token reads no y, and a
// bag with none at all pools to 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_combine.cuh"

namespace {

constexpr int TM = 64;        // tokens per block
constexpr int THREADS = 256;
constexpr int MAX_NH = 32;    // heads per bag (the wrapper checks)
constexpr int UNROLL = 4;     // token rows whose loads are in flight at once

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
attn_pool_partial(const T* __restrict__ y, const float* __restrict__ l,
                  float* __restrict__ part_m, float* __restrict__ part_s,
                  float* __restrict__ part_w, int t, int nh, int e) {
  const int tile = blockIdx.x, ctile = blockIdx.y, bi = blockIdx.z;
  const int ntiles = gridDim.x;
  const int tok0 = tile * TM;
  const int rows = min(TM, t - tok0);
  const int E = nh * e;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ float p_s[TM * MAX_NH];   // the tile's logits, then its weights [row][head]
  __shared__ int live_s;

  const float* lb = l + ((size_t)bi * t + tok0) * nh;
  for (int i = tid; i < rows * nh; i += THREADS) p_s[i] = lb[i];
  if (tid == 0) live_s = 0;
  __syncthreads();

  // per head: the tile's max over unmasked tokens, weights and their sum
  const size_t pbase = ((size_t)bi * ntiles + tile) * nh;
  for (int h = warp; h < nh; h += THREADS / 32) {
    float mx = -INFINITY;
    for (int r = lane; r < rows; r += 32) {
      const float v = p_s[r * nh + h];
      if (v > madeleine::MASKED_BIAS) mx = fmaxf(mx, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float s = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float v = p_s[r * nh + h];
      const float p = v > madeleine::MASKED_BIAS ? expf(v - mx) : 0.f;
      p_s[r * nh + h] = p;
      s += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      if (ctile == 0) {
        part_m[pbase + h] = mx;
        part_s[pbase + h] = s;
      }
      if (mx != -INFINITY) live_s = 1;
    }
  }
  __syncthreads();

  const int c = (ctile * THREADS + tid) * VEC;
  if (c >= E) return;
  float* pw = part_w + ((size_t)bi * ntiles + tile) * E + c;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  if (live_s) {
    const int h = c / e;
    const T* yb = y + ((size_t)bi * t + tok0) * E + c;
    int r = 0;
    for (; r + UNROLL <= rows; r += UNROLL) {
      float v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load_vec(yb + (size_t)(r + u) * E, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = p_s[(r + u) * nh + h];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = fmaf(p, v[u][j], acc[j]);
      }
    }
    for (; r < rows; ++r) {
      float v[VEC];
      load_vec(yb + (size_t)r * E, v);
      const float p = p_s[r * nh + h];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(p, v[j], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; j += 4)
    *reinterpret_cast<float4*>(pw + j) = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
}

template <typename T, int VEC>
cudaError_t launch(const void* y, const float* l, float* part_m, float* part_s, float* part_w,
                   void* out, int b, int t, int nh, int e, cudaStream_t s) {
  const int ntiles = (t + TM - 1) / TM;
  const int E = nh * e;
  const int ctiles = (E + THREADS * VEC - 1) / (THREADS * VEC);
  attn_pool_partial<T, VEC><<<dim3(ntiles, ctiles, b), THREADS, 0, s>>>(
      static_cast<const T*>(y), l, part_m, part_s, part_w, t, nh, e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return madeleine::launch_pool_combine<T>(part_m, part_s, part_w, static_cast<T*>(out), b,
                                           ntiles, nh, e, s);
}

}  // namespace

extern "C" int attn_pool_tile_rows() { return TM; }

// Returns the cudaError_t of the launches (0 = success). Pointers are device
// pointers; y and out are bf16 when is_bf16, else f32; shapes as in
// ops/attn_pool.py::attn_pool_cuda.
extern "C" int attn_pool_forward(const void* y, const float* l, float* part_m, float* part_s,
                                 float* part_w, void* out, int b, int t, int nh, int e,
                                 int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nh < 1 || nh > MAX_NH || e % (is_bf16 ? 8 : 4) != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch<__nv_bfloat16, 8>(y, l, part_m, part_s, part_w, out, b, t, nh, e, s);
  return (int)launch<float, 4>(y, l, part_m, part_s, part_w, out, b, t, nh, e, s);
}
