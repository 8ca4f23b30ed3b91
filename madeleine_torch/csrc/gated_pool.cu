// Gated-attention scoring + softmax pooling in f32 (kernel K2).
//
// Replaces madeleine_tpu/ops/gated_pool.py::_gated_pool_kernel. Input: the
// pre-attention MLP output y [b, t, nh*e] f32 (head-major) and the additive
// mask bias [b, t, nh]. Per head h and token:
//   l = sum_f tanh(y_h Wa_h^T + ba)[f] * sigmoid(y_h Wb_h^T + bb)[f] * wc[f] + bc + bias
// then the softmax over tokens pools y_h in f32.
//
// What bounds it on an H100: the two gate products, 4 * e * f multiply-adds
// per token and head (4.2 MFLOP per token at the published widths). They must
// run in full f32 (Precision.HIGHEST on the TPU, gated_pool.py:60-63) for the
// <=1e-4 checkpoint parity, so no TF32 or bf16 tensor cores: the bound is the
// 67 TFLOP/s of FP32 FMA, far above the 8 KB/token of y it reads.
//
// Design: one block per (token tile of 64, head, bag), so the heads and the
// tiles of a bag run in parallel. A register-tiled SGEMM (each thread 4
// tokens x 4 gate columns, for Wa and Wb at once, 16-deep k stages in shared
// memory) walks the gate width in 64-column passes; its epilogue folds
// tanh * sigmoid * wc into per-token partial logits, so the [t, f] gate
// activations never leave registers. The tile's softmax partial (m, s, w[e])
// goes to scratch, and pool_combine.cuh merges the tiles in a fixed order.
// Tokens past t are excluded by the kernel itself (no padding copy), and a
// tile whose tokens are all masked for its head is skipped, so bucket and
// batch padding cost almost nothing.

#include <cuda_runtime.h>

#include "pool_combine.cuh"

namespace {

constexpr int TM = 64;       // tokens per block
constexpr int TN = 64;       // gate columns per pass
constexpr int TK = 16;       // k depth per shared-memory stage
constexpr int THREADS = 256;

__device__ __forceinline__ float sigmoidf(float z) { return 1.f / (1.f + expf(-z)); }

__global__ void __launch_bounds__(THREADS)
gated_pool_partial(const float* __restrict__ y, const float* __restrict__ bias,
                   const float* __restrict__ wa, const float* __restrict__ ba,
                   const float* __restrict__ wb, const float* __restrict__ bb,
                   const float* __restrict__ wc, const float* __restrict__ bc,
                   float* __restrict__ part_m, float* __restrict__ part_s,
                   float* __restrict__ part_w, int t, int nh, int e, int f) {
  const int tile = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int ntiles = gridDim.x;
  const int tok0 = tile * TM;
  const int rows = min(TM, t - tok0);
  const int E = nh * e;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t pidx = ((size_t)bi * ntiles + tile) * nh + h;  // this block's partial slot
  float* pw = part_w + ((size_t)bi * ntiles + tile) * E + (size_t)h * e;

  // a tile with no unmasked token for this head adds nothing: skip its work
  int live = 0;
  for (int r = tid; r < rows; r += THREADS)
    live |= bias[((size_t)bi * t + tok0 + r) * nh + h] > madeleine::MASKED_BIAS;
  if (!__syncthreads_or(live)) {
    madeleine::write_empty_partial(part_m + pidx, part_s + pidx, pw, e, tid, THREADS);
    return;
  }

  __shared__ __align__(16) float Ys[TK][TM + 4];
  __shared__ __align__(16) float As[TK][TN + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];
  __shared__ float logit[TM];
  __shared__ float p_s[TM];

  const float* yb = y + ((size_t)bi * t + tok0) * E + (size_t)h * e;  // row r at r * E
  const float* wah = wa + (size_t)h * f * e;                          // [f][e]
  const float* wbh = wb + (size_t)h * f * e;
  const float* bah = ba + (size_t)h * f;
  const float* bbh = bb + (size_t)h * f;
  const float* wch = wc + (size_t)h * f;

  // loader: 64 rows x 16 k as 256 float4, stored k-major for the inner loop
  const int lr = tid >> 2, lk = (tid & 3) * 4;

  float lpart[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < f; n0 += TN) {
    float acc_a[4][4], acc_b[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_a[i][j] = acc_b[i][j] = 0.f;

    for (int k0 = 0; k0 < e; k0 += TK) {
      float4 yv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lr < rows) yv = __ldg(reinterpret_cast<const float4*>(yb + (size_t)lr * E + k0 + lk));
      const float4 av = __ldg(reinterpret_cast<const float4*>(wah + (size_t)(n0 + lr) * e + k0 + lk));
      const float4 bv = __ldg(reinterpret_cast<const float4*>(wbh + (size_t)(n0 + lr) * e + k0 + lk));
      Ys[lk + 0][lr] = yv.x; Ys[lk + 1][lr] = yv.y; Ys[lk + 2][lr] = yv.z; Ys[lk + 3][lr] = yv.w;
      As[lk + 0][lr] = av.x; As[lk + 1][lr] = av.y; As[lk + 2][lr] = av.z; As[lk + 3][lr] = av.w;
      Bs[lk + 0][lr] = bv.x; Bs[lk + 1][lr] = bv.y; Bs[lk + 2][lr] = bv.z; Bs[lk + 3][lr] = bv.w;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        const float4 y4 = *reinterpret_cast<const float4*>(&Ys[k][ty * 4]);
        const float4 a4 = *reinterpret_cast<const float4*>(&As[k][tx * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float yr[4] = {y4.x, y4.y, y4.z, y4.w};
        const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
        const float br[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_a[i][j] = fmaf(yr[i], ar[j], acc_a[i][j]);
            acc_b[i][j] = fmaf(yr[i], br[j], acc_b[i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      const float bav = bah[col], bbv = bbh[col], wcv = wch[col];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        lpart[i] += tanhf(acc_a[i][j] + bav) * sigmoidf(acc_b[i][j] + bbv) * wcv;
    }
  }

  // sum the partial logits over the 16 column threads of each token row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = lpart[i];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    const int r = ty * 4 + i;
    if (tx == 0)
      logit[r] = v + bc[h] + (r < rows ? bias[((size_t)bi * t + tok0 + r) * nh + h] : 0.f);
  }
  __syncthreads();

  // tile softmax state over the valid rows (warp 0)
  if (tid < 32) {
    const float l0 = tid < rows ? logit[tid] : -INFINITY;
    const float l1 = tid + 32 < rows ? logit[tid + 32] : -INFINITY;
    float m = fmaxf(l0, l1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float p0 = tid < rows ? expf(l0 - m) : 0.f;
    const float p1 = tid + 32 < rows ? expf(l1 - m) : 0.f;
    p_s[tid] = p0;
    p_s[tid + 32] = p1;
    float s = p0 + p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tid == 0) {
      part_m[pidx] = m;
      part_s[pidx] = s;
    }
  }
  __syncthreads();

  for (int c = tid; c < e; c += THREADS) {
    float w = 0.f;
    for (int r = 0; r < rows; ++r) w = fmaf(p_s[r], yb[(size_t)r * E + c], w);
    pw[c] = w;
  }
}

}  // namespace

extern "C" int gated_pool_tile_rows() { return TM; }

// Returns the cudaError_t of the launches (0 = success). Pointers are device
// pointers; shapes as in gated_pool.py::gated_pool_cuda.
extern "C" int gated_pool_forward(const float* y, const float* bias, const float* wa,
                                  const float* ba, const float* wb, const float* bb,
                                  const float* wc, const float* bc, float* part_m,
                                  float* part_s, float* part_w, float* out, int b, int t,
                                  int nh, int e, int f, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (t + TM - 1) / TM;
  gated_pool_partial<<<dim3(ntiles, nh, b), THREADS, 0, s>>>(
      y, bias, wa, ba, wb, bb, wc, bc, part_m, part_s, part_w, t, nh, e, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)madeleine::launch_pool_combine<float>(part_m, part_s, part_w, out, b, ntiles,
                                                    nh, e, s);
}
