// Gated-attention scoring + softmax pooling in f32 (kernel K2).
//
// Replaces madeleine_tpu/ops/gated_pool.py::_gated_pool_kernel. Input: the
// pre-attention MLP output y [b, t, nh*e] f32 (head-major) and the additive
// mask bias [b, t, nh]. Per head h and token:
//   l = sum_f tanh(y_h Wa_h^T + ba)[f] * sigmoid(y_h Wb_h^T + bb)[f] * wc[f] + bc + bias
// then the softmax over tokens pools y_h in f32.
//
// What bounds it on an H100: the two gate products, 4 * e * f multiply-adds
// per token and head (4.2 MFLOP per token at the published widths), far
// above the 8 KB/token of y it reads. They must be f32-accurate for the
// <=1e-4 checkpoint parity (Precision.HIGHEST on the TPU, gated_pool.py:
// 60-63, itself a multi-pass product on a narrower tensor-core type). On
// this card that is three TF32 products (wgmma_tf32.cuh): 3 x 2 x 4.2 MFLOP
// per token at 495 TFLOP/s, where plain FP32 FMA peaks at 67.
//
// Design (redesigned for Hopper): one block per (128-token tile, head,
// bag); a producer warp keeps TMA loads in flight in a 3-stage ring, two
// consumer warpgroups take 64 tokens each. A stage is one k tile, 32 floats
// deep: the y tile [128 tokens, 32] f32 (a 3-D map over [b, t, nh e], so
// tokens past t arrive as zeros) and the hi and lo halves of 128 rows of
// [Wa; Wb]_h, in K6's permuted row order (64 tanh rows, then the 64 sigmoid
// rows of the same gate columns j), split once per weight state by the
// wrapper's owner (models/abmil.py::kernel_operands). Each consumer splits
// its 64 rows of y in shared memory once the tile lands (hi in place, lo
// beside it, same offsets, so the swizzle is untouched) and runs the three
// TF32 wgmma terms of the k tile into a fresh m64n128 f32 partial, which it
// adds to its running sum in registers, to nearest (wgmma_tf32.cuh: one
// accumulator chained over the whole product missed the f32 bar). The gate
// width is walked in chunks of 64 columns (f / 64 chunks of e / 32 k tiles,
// one ring across them); each chunk's epilogue folds tanh * sigmoid * wc
// into per-token logit partials held in registers and added in chunk order,
// so the [t, f] gate products never leave registers. Both warpgroups share
// every weight tile: 128 tokens per tile halve the weights' L2 reads against
// 64-token tiles. The tile's softmax partial (m, s, w[e]) goes to scratch
// and pool_combine.cuh merges the tiles in a fixed order; tokens past t are
// excluded, and a tile whose tokens are all masked for its head is skipped.
//
// The first design (a register-tiled FP32 FMA kernel, 64-token tiles, each
// 16-deep k stage a synchronous load behind two barriers) stays as the
// check-only entry point gated_pool_ffma_forward.

#include <cuda_runtime.h>

#include "pool_combine.cuh"
#include "wgmma_tf32.cuh"

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

// The first design, kept as a check (no path calls it).
extern "C" int gated_pool_ffma_tile_rows() { return TM; }

// Returns the cudaError_t of the launches (0 = success). Pointers are device
// pointers; shapes as in gated_pool.py::gated_pool_ffma_cuda.
extern "C" int gated_pool_ffma_forward(const float* y, const float* bias, const float* wa,
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

namespace {

namespace k2 {

constexpr int TM = 128;                   // tokens per block: two consumer warpgroups of 64
constexpr int NC = 128;                   // weight rows per gate chunk: 64 tanh, 64 sigmoid
constexpr int KT = madeleine::tf32::KT;   // k per stage
constexpr int STAGES = 3;
constexpr int THREADS = 384;              // producer warpgroup + 2 consumer warpgroups
constexpr int Y_BYTES = TM * KT * 4;      // 16 KB
constexpr int W_BYTES = NC * KT * 4;      // 16 KB
// a stage: y (hi once split), y lo, W hi, W lo; TMA brings all but y lo
constexpr int STAGE_BYTES = 2 * Y_BYTES + 2 * W_BYTES;
constexpr int TX_BYTES = Y_BYTES + 2 * W_BYTES;
// ring, full and empty barriers, the tile's logits and weights, + slack to
// align the ring to 1024 bytes
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 2 * TM * 4 + 1024;

__device__ __forceinline__ float4 ld_shared4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared4(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// Fragment i of the m64n128 accumulator is row 16 warp + lane / 4 (+ 8 for
// i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) + i % 2: fragments q and
// q + 8 (q < 8) of a thread are a and g of one (row, j), j = 8 q + 2
// (lane % 4) + i % 2 of the chunk. Adds this chunk's logit terms of the
// thread's rows (hh = 0, 1: rows lane / 4 and + 8) to lsum: each thread sums
// its 16 j in (q, i) order, then the quad in a fixed xor order.
__device__ __forceinline__ void fold_chunk(const float (&d)[64], const float* __restrict__ bab,
                                           const float* __restrict__ wc, int lane,
                                           float (&lsum)[2]) {
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = q * 8 + (lane % 4) * 2 + i;
      const float ba = __ldg(bab + j), bb = __ldg(bab + 64 + j), w = __ldg(wc + j);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        part[hh] += tanhf(d[4 * q + 2 * hh + i] + ba) *
                    sigmoidf(d[4 * (q + 8) + 2 * hh + i] + bb) * w;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 1);
    part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 2);
    lsum[hh] += part[hh];
  }
}

}  // namespace k2

__global__ void __launch_bounds__(k2::THREADS, 1)
gated_pool_tf32_partial(const __grid_constant__ CUtensorMap map_y,
                        const __grid_constant__ CUtensorMap map_hi,
                        const __grid_constant__ CUtensorMap map_lo,
                        const float* __restrict__ y, const float* __restrict__ bias,
                        const float* __restrict__ bab, const float* __restrict__ wc,
                        const float* __restrict__ bc, float* __restrict__ part_m,
                        float* __restrict__ part_s, float* __restrict__ part_w, int t, int nh,
                        int e, int f) {
  namespace wg = madeleine::wg;
  extern __shared__ unsigned char smem_raw[];
  const int tile = blockIdx.x, h = blockIdx.y, bi = blockIdx.z, ntiles = gridDim.x;
  const int tok0 = tile * k2::TM, rows = min(k2::TM, t - tok0), E = nh * e;
  const int tid = threadIdx.x;
  const size_t pidx = ((size_t)bi * ntiles + tile) * nh + h;   // this block's partial slot
  float* pw = part_w + ((size_t)bi * ntiles + tile) * E + (size_t)h * e;

  // a tile with no unmasked token for this head adds nothing: skip its work
  int live = 0;
  for (int r = tid; r < rows; r += k2::THREADS)
    live |= bias[((size_t)bi * t + tok0 + r) * nh + h] > madeleine::MASKED_BIAS;
  if (!__syncthreads_or(live)) {
    madeleine::write_empty_partial(part_m + pidx, part_s + pidx, pw, e, tid, k2::THREADS);
    return;
  }

  // 128-byte swizzled tiles start on 1024-byte boundaries; full[s] at bars
  // + 8 s, empty[s] at + 8 (STAGES + s)
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + k2::STAGES * k2::STAGE_BYTES;
  float* logit = reinterpret_cast<float*>(smem_raw + (bars + 16 * k2::STAGES - raw));
  float* p_s = logit + k2::TM;
  if (tid == 0) {
    for (int s = 0; s < k2::STAGES; ++s) {
      wg::mbar_init(bars + 8 * s, 1);
      wg::mbar_init(bars + 8 * (k2::STAGES + s), 256);   // both consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = e / k2::KT, nchunks = f / 64;
  const int group = tid / 128;
  if (group == 0) {
    // producer: one thread keeps the ring full, (chunk, k tile) after
    // (chunk, k tile); y's columns of head h start at h e, [Wa; Wb]_h's rows
    // at h 2f
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int it = 0; it < nchunks * nk; ++it) {
        const int s = it % k2::STAGES, c = it / nk, kt = it - c * nk;
        wg::mbar_wait(bars + 8 * (k2::STAGES + s), ((it / k2::STAGES) & 1) ^ 1);
        const uint32_t full = bars + 8 * s, dst = base + s * k2::STAGE_BYTES;
        wg::mbar_expect_tx(full, k2::TX_BYTES);
        madeleine::tf32::tma_load_3d(dst, &map_y, full, h * e + kt * k2::KT, tok0, bi);
        const int wrow = h * 2 * f + c * k2::NC;
        wg::tma_load_2d(dst + 2 * k2::Y_BYTES, &map_hi, full, kt * k2::KT, wrow);
        wg::tma_load_2d(dst + 2 * k2::Y_BYTES + k2::W_BYTES, &map_lo, full, kt * k2::KT, wrow);
      }
    }
    return;
  }

  // consumers: warpgroup `half` takes the tile's rows 64 half .. 64 half + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int half = group - 1, ctid = tid - 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  // d: the k tile's partial product; acc: the partials added in k order
  float d[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = acc[i] = 0.f;
  float lsum[2] = {0.f, 0.f};
  int it = 0;
  for (int c = 0; c < nchunks; ++c) {
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % k2::STAGES;
      wg::mbar_wait(bars + 8 * s, (it / k2::STAGES) & 1);
      const uint32_t st = base + s * k2::STAGE_BYTES;
      const uint32_t yh = st + half * (k2::Y_BYTES / 2), yl = yh + k2::Y_BYTES;
      const uint32_t whi = st + 2 * k2::Y_BYTES, wlo = whi + k2::W_BYTES;
      // split the warpgroup's 64 rows x 32 floats in place: 4 float4 a thread
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t off = (uint32_t)(wt + 128 * i) * 16;
        float4 v = k2::ld_shared4(yh + off), lo;
        madeleine::tf32::split(v.x, lo.x);
        madeleine::tf32::split(v.y, lo.y);
        madeleine::tf32::split(v.z, lo.z);
        madeleine::tf32::split(v.w, lo.w);
        k2::st_shared4(yh + off, v);
        k2::st_shared4(yl + off, lo);
      }
      madeleine::tf32::fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
      wg::fence_acc(d);
      wg::wgmma_fence();
      madeleine::tf32::split_ktile(d, yh, yl, whi, wlo);
      wg::wgmma_commit();
      wg::fence_acc(d);
      // the tile's products are done: hand its stage back (the other
      // warpgroup keeps the tensor cores busy meanwhile), then add the
      // partial, rounded to nearest
      wg::wgmma_wait<0>();
      wg::fence_acc(d);
      wg::mbar_arrive(bars + 8 * (k2::STAGES + s));
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = kt == 0 ? d[i] : acc[i] + d[i];
    }
    k2::fold_chunk(acc, bab + (size_t)h * 2 * f + c * k2::NC, wc + (size_t)h * f + c * 64, lane,
                   lsum);
  }

  // the tile's logits (rows past t are excluded below)
  if (lane % 4 == 0) {
    const float bch = __ldg(bc + h);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = half * 64 + warp * 16 + lane / 4 + 8 * hh;
      logit[r] = lsum[hh] + bch +
                 (r < rows ? __ldg(bias + ((size_t)bi * t + tok0 + r) * nh + h) : 0.f);
    }
  }
  asm volatile("bar.sync 3, 256;\n" ::: "memory");

  // tile softmax state over the valid rows (the first consumer warp)
  if (ctid < 32) {
    float l[4], m = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ctid + 32 * i;
      l[i] = r < rows ? logit[r] : -INFINITY;
      m = fmaxf(m, l[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ctid + 32 * i;
      const float p = r < rows ? expf(l[i] - m) : 0.f;
      p_s[r] = p;
      s += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (ctid == 0) {
      part_m[pidx] = m;
      part_s[pidx] = s;
    }
  }
  asm volatile("bar.sync 3, 256;\n" ::: "memory");

  const float* yb = y + ((size_t)bi * t + tok0) * E + (size_t)h * e;   // row r at r * E
  for (int col = ctid; col < e; col += 256) {
    float w = 0.f;
    for (int r = 0; r < rows; ++r) w = fmaf(p_s[r], yb[(size_t)r * E + col], w);
    pw[col] = w;
  }
}

}  // namespace

extern "C" int gated_pool_tile_rows() { return k2::TM; }

// Returns the cudaError_t of the launches (0 = success; cudaErrorInvalidValue
// for a shape or operand the kernel cannot take: e % 32, f % 64, a base not
// on 16 bytes). Pointers are device pointers: y [b, t, nh e], bias [b, t, nh],
// wab_hi / wab_lo [nh, 2f, e] (the split of K6's permuted [Wa; Wb]), bab
// [nh, 2f] (permuted [ba; bb]), wc [nh, f], bc [nh], all f32; shapes as in
// gated_pool.py::gated_pool_cuda.
extern "C" int gated_pool_forward(const float* y, const float* bias, const float* wab_hi,
                                  const float* wab_lo, const float* bab, const float* wc,
                                  const float* bc, float* part_m, float* part_s, float* part_w,
                                  float* out, int b, int t, int nh, int e, int f, void* stream) {
  namespace wg = madeleine::wg;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (b < 1 || t < 1 || nh < 1 || e < k2::KT || e % k2::KT || f < 64 || f % 64 ||
      !aligned(y) || !aligned(wab_hi) || !aligned(wab_lo))
    return (int)cudaErrorInvalidValue;
  const wg::EncodeTiledFn enc = wg::encode_fn();
  if (!enc) return (int)cudaErrorInitializationError;
  const long long E = (long long)nh * e;
  const long long ydims[3] = {E, t, b}, ystrides[2] = {E * 4, (long long)t * E * 4};
  const long long wdims[2] = {e, 2LL * nh * f}, wstrides[1] = {(long long)e * 4};
  const int ybox[3] = {k2::KT, k2::TM, 1}, wbox[2] = {k2::KT, k2::NC};
  CUtensorMap map_y, map_hi, map_lo;
  if (!madeleine::tf32::make_map_f32(enc, &map_y, y, 3, ydims, ystrides, ybox) ||
      !madeleine::tf32::make_map_f32(enc, &map_hi, wab_hi, 2, wdims, wstrides, wbox) ||
      !madeleine::tf32::make_map_f32(enc, &map_lo, wab_lo, 2, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  // set on every launch: a function-local static would be one object for
  // every library of the process that includes the shared headers
  cudaError_t err = cudaFuncSetAttribute(
      gated_pool_tf32_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, k2::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (t + k2::TM - 1) / k2::TM;
  gated_pool_tf32_partial<<<dim3(ntiles, nh, b), k2::THREADS, k2::SMEM_BYTES, s>>>(
      map_y, map_hi, map_lo, y, bias, bab, wc, bc, part_m, part_s, part_w, t, nh, e, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)madeleine::launch_pool_combine<float>(part_m, part_s, part_w, out, b, ntiles,
                                                    nh, e, s);
}
