// Streaming masked softmax pool (kernel K3), bf16 or f32 token features, and
// the training pool built on it: the pool with its softmax stats (row 4) and
// the pool's backward (row 5).
//
// K3 replaces madeleine_tpu/ops/attn_pool.py::_pool_kernel (called from
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
//
// Row 4 replaces _pool_ms_kernel (called from _pool_pallas_ms): K3's launches
// unchanged, and the merge also writes each (bag, head)'s max m and clamped
// denominator s = max(S, 1e-30), the stats of the weights the output used
// (pool_combine.cuh). Bound: K3's, 0.163 ms at [65, 2048, 2048] bf16.
//
// Row 5 replaces _pool_bwd_kernel (called from _pool_bwd_call). With
// a = exp(l - m) / s per token and head (0 for a masked token, l at or below
// MASKED_BIAS, so a bag with no unmasked token, stats (-1e30, 1e-30), gives
// 0), g [b, E] the pooled output's cotangent and inner [b, nh] = sum_e g *
// pooled (formed outside, from the saved output, as on the TPU):
//   dx[t, h*e + j] = a[t, h] g[h*e + j]        (y's dtype)
//   dl[t, h]       = a[t, h] (sum_j g[h*e + j] y[t, h*e + j] - inner[h])  (f32)
// Bound: bytes, y read and dx written once: 0.327 ms at [65, 2048, 2048]
// bf16. Design: tokens are independent, so each block takes BWD_ROWS tokens
// of one bag and each warp one token at a time; per head the warp streams
// the head's columns of y in 16-byte loads, writes dx, and sums g * y in a
// fixed order (each lane in column order, then a butterfly), so two launches
// are bitwise equal. A (token, head) whose weight is 0 reads no y.

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
                   void* out, int b, int t, int nh, int e, cudaStream_t s,
                   float* stat_m = nullptr, float* stat_s = nullptr) {
  const int ntiles = (t + TM - 1) / TM;
  const int E = nh * e;
  const int ctiles = (E + THREADS * VEC - 1) / (THREADS * VEC);
  attn_pool_partial<T, VEC><<<dim3(ntiles, ctiles, b), THREADS, 0, s>>>(
      static_cast<const T*>(y), l, part_m, part_s, part_w, t, nh, e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return madeleine::launch_pool_combine<T>(part_m, part_s, part_w, static_cast<T*>(out), b,
                                           ntiles, nh, e, s, stat_m, stat_s);
}

// ---- row 5: the pool's backward ----

constexpr int BWD_ROWS = 32;   // tokens per block, THREADS / 32 warps

__device__ __forceinline__ void load_g(const float* p, float (&v)[8]) {
  const float4 u0 = __ldg(reinterpret_cast<const float4*>(p));
  const float4 u1 = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
  v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
}

__device__ __forceinline__ void load_g(const float* p, float (&v)[4]) { load_vec(p, v); }

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
attn_pool_bwd_kernel(const T* __restrict__ y, const float* __restrict__ l,
                     const float* __restrict__ m, const float* __restrict__ s,
                     const float* __restrict__ g, const float* __restrict__ inner,
                     T* __restrict__ dx, float* __restrict__ dl, int t, int nh, int e) {
  const int bi = blockIdx.y;
  const int E = nh * e;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (int)blockIdx.x * BWD_ROWS;
  const int end = min(t, row0 + BWD_ROWS);
  const float* gb = g + (size_t)bi * E;
  for (int r = row0 + warp; r < end; r += THREADS / 32) {
    const size_t row = (size_t)bi * t + r;
    const T* yr = y + row * E;
    T* dxr = dx + row * E;
    for (int h = 0; h < nh; ++h) {
      const float lv = l[row * nh + h];
      const float a = lv > madeleine::MASKED_BIAS
                          ? expf(lv - m[(size_t)bi * nh + h]) / s[(size_t)bi * nh + h] : 0.f;
      float acc = 0.f;
      for (int c = h * e + lane * VEC; c < (h + 1) * e; c += 32 * VEC) {
        float gv[VEC], o[VEC];
        load_g(gb + c, gv);
        if (a != 0.f) {
          float v[VEC];
          load_vec(yr + c, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc = fmaf(gv[j], v[j], acc);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = a * gv[j];
        store_vec(dxr + c, o);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) dl[row * nh + h] = a * (acc - inner[(size_t)bi * nh + h]);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* y, const float* l, const float* m, const float* s,
                       const float* g, const float* inner, void* dx, float* dl, int b, int t,
                       int nh, int e, cudaStream_t st) {
  const dim3 grid((t + BWD_ROWS - 1) / BWD_ROWS, b);
  attn_pool_bwd_kernel<T, VEC><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(y), l, m, s, g, inner, static_cast<T*>(dx), dl, t, nh, e);
  return cudaGetLastError();
}

// b is a grid extent (z of the forward's partials, y of the combine and of
// the backward): at most MAX_BAGS bags a call, a larger one runs in blocks
// of whole bags (models/abmil.py::abmil_embed_train). Every element offset
// is 64-bit (size_t).
constexpr int MAX_BAGS = 65535;

bool bad_shape(const void* y, int b, int t, int nh, int e, int is_bf16) {
  return b < 1 || b > MAX_BAGS || t < 1 || nh < 1 || nh > MAX_NH || e % (is_bf16 ? 8 : 4) != 0 ||
         reinterpret_cast<uintptr_t>(y) % 16 != 0;
}

}  // namespace

extern "C" int attn_pool_tile_rows() { return TM; }

// K3 and row 4. Returns the cudaError_t of the launches (0 = success).
// Pointers are device pointers; y and out are bf16 when is_bf16, else f32;
// shapes as in ops/attn_pool.py::attn_pool_cuda. stat_m and stat_s [b, nh]
// f32 receive row 4's merged softmax stats; both null for K3.
extern "C" int attn_pool_forward(const void* y, const float* l, float* part_m, float* part_s,
                                 float* part_w, void* out, float* stat_m, float* stat_s, int b,
                                 int t, int nh, int e, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(y, b, t, nh, e, is_bf16)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch<__nv_bfloat16, 8>(y, l, part_m, part_s, part_w, out, b, t, nh, e, s,
                                         stat_m, stat_s);
  return (int)launch<float, 4>(y, l, part_m, part_s, part_w, out, b, t, nh, e, s, stat_m,
                               stat_s);
}

// Row 5. p: y [b, t, E], l [b, t, nh] f32 (pre-masked), m, s [b, nh] f32,
// g [b, E] f32, inner [b, nh] f32, then the outputs dx [b, t, E] in y's
// dtype and dl [b, t, nh] f32. dims: b, t, nh, e, is_bf16. Returns a
// cudaError_t.
extern "C" int attn_pool_backward(void** p, const long long* dims, const float*,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = (int)dims[0], t = (int)dims[1], nh = (int)dims[2], e = (int)dims[3];
  const int is_bf16 = (int)dims[4];
  if (bad_shape(p[0], b, t, nh, e, is_bf16) || reinterpret_cast<uintptr_t>(p[6]) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p[4]) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float *l = (const float*)p[1], *m = (const float*)p[2], *s = (const float*)p[3];
  const float *g = (const float*)p[4], *inner = (const float*)p[5];
  if (is_bf16)
    return (int)launch_bwd<__nv_bfloat16, 8>(p[0], l, m, s, g, inner, p[6], (float*)p[7], b, t,
                                             nh, e, st);
  return (int)launch_bwd<float, 4>(p[0], l, m, s, g, inner, p[6], (float*)p[7], b, t, nh, e,
                                   st);
}
