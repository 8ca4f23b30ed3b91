// Deterministic combine of split-token softmax-pool partials, shared by
// encode_fused.cu (K1) and gated_pool.cu (K2).
//
// On the TPU the (m, s, w) online-softmax state is carried across token
// blocks by the sequential grid (encode_fused.py:134-140, gated_pool.py:50-56).
// Hopper blocks run in parallel, so each (bag, token tile, head) block writes
// its partial state and this second pass merges the tiles in index order,
// flash-decoding style, with no atomics:
//
//   M = max_i m_i,  S = sum_i s_i e^(m_i - M),  W = sum_i w_i e^(m_i - M)
//   out = W / max(S, 1e-30)
//
// A tile with no unmasked token is skipped by the partial kernels and leaves
// (m, s, w) = (-inf, 0, 0): it weighs e^-inf = 0 here, and a bag with no
// unmasked token at all (M = -inf) pools to 0.
//
// part_m, part_s: [b, ntiles, nh]; part_w: [b, ntiles, nh*e]; out: [b, nh*e].
// With stat_m and stat_s (the training pool, attn_pool.cu) the merge also
// writes each head's (M, max(S, 1e-30)) [b, nh], the stats of exactly the
// weights the output used; a bag with no unmasked token writes (NEG_FILL,
// 1e-30), which the backward reads as all weights 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace madeleine {

// A logit bias at or below this marks a masked token (the wrappers pass 0 or
// NEG_INF = -1e30, attn_pool.py).
constexpr float MASKED_BIAS = -1e29f;
constexpr float NEG_FILL = -1e30f;   // the wrappers' NEG_INF

// Empty partial state for a tile without unmasked tokens, head h (w has e entries).
__device__ __forceinline__ void write_empty_partial(float* part_m, float* part_s, float* w,
                                                    int e, int tid, int nthreads) {
  for (int c = tid; c < e; c += nthreads) w[c] = 0.f;
  if (tid == 0) {
    *part_m = -INFINITY;
    *part_s = 0.f;
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename OutT>
__global__ void pool_combine_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_s,
                                    const float* __restrict__ part_w,
                                    OutT* __restrict__ out, int ntiles, int nh, int e,
                                    float* __restrict__ stat_m, float* __restrict__ stat_s) {
  const int bi = blockIdx.y;
  const int E = nh * e;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= E) return;
  const int h = c / e;
  const bool stats = stat_m != nullptr && c == h * e;   // one thread per head
  const float* pm = part_m + (size_t)bi * ntiles * nh + h;
  const float* ps = part_s + (size_t)bi * ntiles * nh + h;
  const float* pw = part_w + (size_t)bi * ntiles * E + c;
  float M = pm[0];
  for (int i = 1; i < ntiles; ++i) M = fmaxf(M, pm[(size_t)i * nh]);
  if (M == -INFINITY) {
    store_out(out + (size_t)bi * E + c, 0.f);
    if (stats) {
      stat_m[(size_t)bi * nh + h] = NEG_FILL;
      stat_s[(size_t)bi * nh + h] = 1e-30f;
    }
    return;
  }
  float S = 0.f, W = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const float a = expf(pm[(size_t)i * nh] - M);
    S = fmaf(ps[(size_t)i * nh], a, S);
    W = fmaf(pw[(size_t)i * E], a, W);
  }
  const float Sc = fmaxf(S, 1e-30f);
  store_out(out + (size_t)bi * E + c, W / Sc);
  if (stats) {
    stat_m[(size_t)bi * nh + h] = M;
    stat_s[(size_t)bi * nh + h] = Sc;
  }
}

template <typename OutT>
inline cudaError_t launch_pool_combine(const float* part_m, const float* part_s,
                                       const float* part_w, OutT* out, int b, int ntiles,
                                       int nh, int e, cudaStream_t stream,
                                       float* stat_m = nullptr, float* stat_s = nullptr) {
  const int E = nh * e;
  dim3 grid((E + 255) / 256, b);
  pool_combine_kernel<OutT><<<grid, 256, 0, stream>>>(part_m, part_s, part_w, out, ntiles,
                                                      nh, e, stat_m, stat_s);
  return cudaGetLastError();
}

}  // namespace madeleine
