// GOT glue around the transport kernels: threshold_build forward (K11) and
// backward (K12), gw_trace forward (K13) and backward (K14), f32.
//
// Replaces madeleine_tpu/ops/got_glue.py (`_tb_fwd_kernel`, `_tb_bwd_kernel`,
// `_gwt_fwd_kernel`, `_gwt_bwd_kernel`; ref: loss.py:225-258, 288-292). Per
// problem p, with thresholds thr[p] = (t_C, t_s, t_t) computed by the caller:
//
//   K11  C = relu(C0 - t_C), Cs = relu(Cs0 - t_s), Ct = relu(Ct0 - t_t),
//        Cst[i, j] = (1/n) sum_k Cs[i, k]^2 + (1/m) sum_k Ct[j, k]^2
//   K12  dC0 = [C0 > t_C] dC
//        dCs0 = [Cs0 > t_s] (dCs + (2/n) Cs rowsum(dCst)[i])
//        dCt0 = [Ct0 > t_t] (dCt + (2/m) Ct colsum(dCst)[j])
//        dthr = -(sum dC0, sum dCs0, sum dCt0)
//   K13  out[p] = sum_ij (Cst - 2 Cs gamma Ct^T)_ij gamma_ij, never writing
//        the [n, m] C_final
//   K14  for the cotangent dv = dout[p], with P = gamma Ct^T:
//        dCs = -2 dv gamma P^T,  dCt = -2 dv (gamma^T Cs) gamma,  dCst = dv gamma
//        (gamma is detached by every caller: no cotangent for it)
//
// Shapes: C0, C, Cst, gamma [b, n, m]; Cs0, Cs [b, n, n]; Ct0, Ct [b, m, m];
// thr, dthr [b, 3]; out, dout [b].
//
// What bounds them on an H100 (each input read once, each output written
// once; at the train step's b = 260, n = m = 256 one tensor is 68.2 MB):
// K11 moves 7 tensors (0.142 ms at 3.35 TB/s), K12 10 tensors (0.203 ms):
// bytes. K13 does 2 products (17.4 GFLOP, 0.261 ms at the 67 TFLOP/s FP32
// peak), K14 4 products (34.9 GFLOP, 0.521 ms): operations. The products
// stay full f32 FFMA (the loss runs at Precision.HIGHEST; no TF32).
//
// Design of K11 and K12 (first version, simple and exact): one block of 512
// threads per problem, as K8-K10's global routes. K11 and K12 are row passes (a warp per row: lanes
// stride the row, then a butterfly) and, for K12's column sums of dCst,
// a column pass (threads across columns in four row groups, summed in order,
// then the groups in order); the per-row sums live in shared memory and the
// elementwise outputs follow.
//
// K13 (gwt_fwd_tiles_kernel): two products of 2 n^2 m and 2 n m^2 flops, cut
// into 128 x 128 output tiles over the whole card, each tile a task of one
// 256-thread block on gemm_f32.cuh, as K14's. Three launches: phase 1 t1 =
// Cs gamma [n, m] into a device scratch; phase 2 t1 Ct^T tile by tile (Ct
// read in place, as K14's P reads it) whose epilogue takes (Cst - 2 acc)
// gamma and sums it: each thread its 64 outputs in the engine's fixed
// order, then the block its threads in a fixed order (a warp butterfly,
// then the warps in order), one partial per tile into part[p, tile]; a
// third, small launch sums each problem's partials in tile order into
// out[p]. A ragged edge adds nothing: the engine hands the epilogue no row
// i >= n, and columns j >= m are skipped before Cst or gamma is read. No
// atomics, so two launches give bitwise-equal results. At [260, 256, 256]
// that is 1,040 tasks per phase, about 4 waves of 264 blocks. The first
// design (gwt_fwd_kernel: one block per problem, both products in series on
// ipot_common.cuh's block_gemm, 128 x 64 tiles at one block per SM) sums in
// another order, so the two agree to rounding (1e-5 relative) and not bit
// for bit; it stays as a check-only entry point, gw_trace_forward_rowblock.
// The trace is linear in the loss (ops/losses.py adds it), so K14's
// cotangent, and with it training, does not depend on K13's sum order.
//
// K14 (gwt_bwd_tiles_kernel): four products of 2 n m max(n, m) flops each,
// cut into 128 x 128 output tiles spread over the whole card, each tile a
// task of one 256-thread block on gemm_f32.cuh (cp.async ring, 8 x 8 FFMA
// outputs per thread, two blocks per SM). Two launches, the second reading
// what the first wrote: phase 1 P = gamma Ct^T [n, m] (whose tasks also write
// dCst = dv gamma over their tile) and G = gamma^T Cs [m, n] into device
// scratches; phase 2 dCs = -2 dv gamma P^T [n, n] and dCt = -2 dv G gamma
// [m, m]. At [260, 256, 256] that is 2,080 tasks per phase, about 8 waves of
// 264 blocks. The tile plan (each product's tile grid) comes from the caller
// (madeleine_torch/ops/got_glue.py::gwt_bwd_plan) and is checked here. Every
// sum over k runs in order from 0 with fmaf and the scale is applied after
// it, as in the first design's kernel (gwt_bwd_kernel: one block per
// problem, the four products in series on block_gemm), so the outputs are
// bitwise equal to it; that kernel stays as a check-only entry point,
// gw_trace_backward_rowblock.

#include "gemm_f32.cuh"
#include "ipot_common.cuh"

using namespace madeleine_ipot;
namespace gf = madeleine_gemm_f32;

namespace {

// The sum of v over the block, in a fixed order, returned to every thread.
// red: WARPS floats of shared memory. Starts and ends with a barrier-safe
// pattern: callers may call it back to back.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Y = relu(X0 - t) over a [rows, cols] problem, and rsq[i] = scale * sum_k Y[i, k]^2
// (a warp per row). rsq lives in shared memory.
__device__ __forceinline__ void relu_rows_sq(const float* __restrict__ X0, float* __restrict__ Y,
                                             float t, int rows, int cols, float scale,
                                             float* rsq) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += WARPS) {
    const float* xr = X0 + (size_t)i * cols;
    float* yr = Y + (size_t)i * cols;
    float acc = 0.f;
    for (int k = lane; k < cols; k += 32) {
      const float x = xr[k];
      const float y = x > t ? x - t : 0.f;
      yr[k] = y;
      acc = fmaf(y, y, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) rsq[i] = acc * scale;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
tb_fwd_kernel(const float* __restrict__ thr, const float* __restrict__ C0,
              const float* __restrict__ Cs0, const float* __restrict__ Ct0,
              float* __restrict__ C, float* __restrict__ Cs, float* __restrict__ Ct,
              float* __restrict__ Cst, int n, int m) {
  extern __shared__ float smem[];
  float* rs = smem;      // [n]: (1/n) sum_k Cs[i, k]^2
  float* rt = rs + n;    // [m]: (1/m) sum_k Ct[j, k]^2
  const size_t p = blockIdx.x, nm = (size_t)n * m;
  const float tc = thr[3 * p], ts = thr[3 * p + 1], tt = thr[3 * p + 2];
  relu_rows_sq(Cs0 + p * n * n, Cs + p * n * n, ts, n, n, 1.f / (float)n, rs);
  relu_rows_sq(Ct0 + p * m * m, Ct + p * m * m, tt, m, m, 1.f / (float)m, rt);
  __syncthreads();
  C0 += p * nm; C += p * nm; Cst += p * nm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += WARPS) {
    const size_t r = (size_t)i * m;
    const float ri = rs[i];
    for (int j = lane; j < m; j += 32) {
      const float x = C0[r + j];
      C[r + j] = x > tc ? x - tc : 0.f;
      Cst[r + j] = ri + rt[j];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
tb_bwd_kernel(const float* __restrict__ thr, const float* __restrict__ C0,
              const float* __restrict__ Cs0, const float* __restrict__ Ct0,
              const float* __restrict__ dC, const float* __restrict__ dCs,
              const float* __restrict__ dCt, const float* __restrict__ dCst,
              float* __restrict__ dC0, float* __restrict__ dCs0, float* __restrict__ dCt0,
              float* __restrict__ dthr, int n, int m) {
  extern __shared__ float smem[];
  float* rsum = smem;                // [n]: sum_j dCst[i, j]
  float* csum = rsum + n;            // [m]: sum_i dCst[i, j]
  float* part = csum + m;            // [GROUPS * COLW]
  float* red = part + GROUPS * COLW; // [WARPS]
  const size_t p = blockIdx.x, nm = (size_t)n * m, nn = (size_t)n * n, mm = (size_t)m * m;
  const float tc = thr[3 * p], ts = thr[3 * p + 1], tt = thr[3 * p + 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  dCst += p * nm;
  // row sums of dCst: a warp per row
  for (int i = warp; i < n; i += WARPS) {
    const float* r = dCst + (size_t)i * m;
    float acc = 0.f;
    for (int j = lane; j < m; j += 32) acc += r[j];
    acc = warp_sum(acc);
    if (lane == 0) rsum[i] = acc;
  }
  // column sums of dCst: threads across columns, GROUPS row groups each
  // summed in order, then the groups in order
  const int c = threadIdx.x % COLW, g = threadIdx.x / COLW;
  for (int j0 = 0; j0 < m; j0 += COLW) {
    const int j = j0 + c;
    float acc = 0.f;
    if (j < m)
      for (int i = g; i < n; i += GROUPS) acc += dCst[(size_t)i * m + j];
    part[g * COLW + c] = acc;
    __syncthreads();
    if (g == 0 && j < m) {
      float s = part[c];
#pragma unroll
      for (int q = 1; q < GROUPS; ++q) s += part[q * COLW + c];
      csum[j] = s;
    }
    __syncthreads();
  }
  // the masked cotangents (a warp per row), each thread summing its own
  // elements for dthr
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  C0 += p * nm; dC += p * nm; dC0 += p * nm;
  for (int i = warp; i < n; i += WARPS)
    for (int j = lane; j < m; j += 32) {
      const size_t e = (size_t)i * m + j;
      const float v = C0[e] > tc ? dC[e] : 0.f;
      dC0[e] = v;
      s0 += v;
    }
  Cs0 += p * nn; dCs += p * nn; dCs0 += p * nn;
  const float two_n = 2.f / (float)n, two_m = 2.f / (float)m;
  for (int i = warp; i < n; i += WARPS) {
    const float ri = rsum[i];
    for (int k = lane; k < n; k += 32) {
      const size_t e = (size_t)i * n + k;
      const float x = Cs0[e];
      const float v = x > ts ? dCs[e] + (two_n * (x - ts)) * ri : 0.f;
      dCs0[e] = v;
      s1 += v;
    }
  }
  Ct0 += p * mm; dCt += p * mm; dCt0 += p * mm;
  for (int j = warp; j < m; j += WARPS) {
    const float cj = csum[j];
    for (int k = lane; k < m; k += 32) {
      const size_t e = (size_t)j * m + k;
      const float x = Ct0[e];
      const float v = x > tt ? dCt[e] + (two_m * (x - tt)) * cj : 0.f;
      dCt0[e] = v;
      s2 += v;
    }
  }
  s0 = block_sum(s0, red);
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    dthr[3 * p] = -s0;
    dthr[3 * p + 1] = -s1;
    dthr[3 * p + 2] = -s2;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gwt_fwd_kernel(const float* __restrict__ Cs, const float* __restrict__ Ct,
               const float* __restrict__ Cst, const float* __restrict__ gamma, float* t1,
               float* __restrict__ out, int n, int m) {
  extern __shared__ float smem[];
  float* gsm = smem;                       // GEMM tiles
  float* red = gsm + gemm_smem_floats();   // [WARPS]
  const size_t p = blockIdx.x, nm = (size_t)n * m;
  Cs += p * n * n; Ct += p * m * m; Cst += p * nm; gamma += p * nm; t1 += p * nm;
  // t1 = Cs gamma: X = Cs (i, k) row-major, Y = gamma (k, j) row-major
  block_gemm(Cs, n, 1, gamma, m, 1, n, m, n, gsm,
             [&](int i, int j, float acc) { t1[(size_t)i * m + j] = acc; });
  __syncthreads();
  // sum (Cst - 2 t1 Ct^T) o gamma: X = t1 (i, k), Y(k, j) = Ct[j, k]
  float s = 0.f;
  block_gemm(t1, m, 1, Ct, 1, m, n, m, m, gsm, [&](int i, int j, float acc) {
    const size_t e = (size_t)i * m + j;
    s += (Cst[e] - 2.f * acc) * gamma[e];
  });
  s = block_sum(s, red);
  if (threadIdx.x == 0) out[p] = s;
}

__global__ void __launch_bounds__(THREADS, 1)
gwt_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ Cs,
               const float* __restrict__ Ct, const float* __restrict__ gamma, float* P,
               float* G, float* __restrict__ dCs, float* __restrict__ dCt,
               float* __restrict__ dCst, int n, int m) {
  extern __shared__ float smem[];
  const size_t p = blockIdx.x, nm = (size_t)n * m, nn = (size_t)n * n, mm = (size_t)m * m;
  const float dv = dout[p], scale = -2.f * dv;
  Cs += p * nn; Ct += p * mm; gamma += p * nm; P += p * nm; G += p * nm;
  dCs += p * nn; dCt += p * mm; dCst += p * nm;
  // P = gamma Ct^T [n, m]: X = gamma (i, k), Y(k, j) = Ct[j, k]
  block_gemm(gamma, m, 1, Ct, 1, m, n, m, m, smem,
             [&](int i, int j, float acc) { P[(size_t)i * m + j] = acc; });
  // G = gamma^T Cs [m, n]: X(i, k) = gamma[k, i], Y = Cs (k, j) row-major
  block_gemm(gamma, 1, m, Cs, n, 1, m, n, n, smem,
             [&](int i, int j, float acc) { G[(size_t)i * n + j] = acc; });
  for (size_t e = threadIdx.x; e < nm; e += THREADS) dCst[e] = dv * gamma[e];
  __syncthreads();
  // dCs = -2 dv gamma P^T [n, n]: X = gamma (i, k), Y(k, j) = P[j, k]
  block_gemm(gamma, m, 1, P, 1, m, n, n, m, smem,
             [&](int i, int j, float acc) { dCs[(size_t)i * n + j] = scale * acc; });
  // dCt = -2 dv G gamma [m, m]: X = G (i, k), Y = gamma (k, j) row-major
  block_gemm(G, n, 1, gamma, m, 1, m, m, n, smem,
             [&](int i, int j, float acc) { dCt[(size_t)i * m + j] = scale * acc; });
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K14's tile tasks of one phase (1: P and G, 2: dCs and dCt). (ai, aj) and
// (bi, bj) are the tile grids of the phase's first and second products;
// block x is task x % (ai aj + bi bj) of problem x / (ai aj + bi bj), the
// first product's tiles first, each product's tiles row by row.
template <int PHASE>
__global__ void __launch_bounds__(gf::THREADS, 2)
gwt_bwd_tiles_kernel(const float* __restrict__ dout, const float* __restrict__ Cs,
                     const float* __restrict__ Ct, const float* __restrict__ gamma, float* P,
                     float* G, float* __restrict__ dCs, float* __restrict__ dCt,
                     float* __restrict__ dCst, int n, int m, int ai, int aj, int bi, int bj) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ta = ai * aj, per = ta + bi * bj;
  const size_t p = blockIdx.x / per;
  int t = blockIdx.x % per;
  const bool first = t < ta;
  if (!first) t -= ta;
  const int cols = first ? aj : bj;
  const int i0 = (t / cols) * gf::TILE, j0 = (t % cols) * gf::TILE;
  const size_t nm = (size_t)n * m, nn = (size_t)n * n, mm = (size_t)m * m;
  const float dv = dout[p], scale = -2.f * dv;
  const float* g = gamma + p * nm;
  auto nothing = [] {};
  if (PHASE == 1 && first) {
    // P = gamma Ct^T [n, m]: X = gamma (i, k), Y(k, j) = Ct[j, k]; the
    // tile's dCst = dv gamma while the first stages load
    float* Pp = P + p * nm;
    float* D = dCst + p * nm;
    const bool vec = m % 4 == 0 && aligned16(Pp);
    gf::tile_product<true, true>(
        {g, m, 1, n}, {Ct + p * mm, m, 1, m}, m, i0, j0, smem,
        [&] {
          for (int e = threadIdx.x; e < gf::TILE * gf::TILE; e += gf::THREADS) {
            const int i = i0 + e / gf::TILE, j = j0 + e % gf::TILE;
            if (i < n && j < m) D[(size_t)i * m + j] = dv * g[(size_t)i * m + j];
          }
        },
        [&](int i, int j, const float(&v)[4]) { gf::store4(Pp, m, i, j, m, 1.f, v, vec); });
  } else if (PHASE == 1) {
    // G = gamma^T Cs [m, n]: X(i, k) = gamma[k, i], Y(k, j) = Cs[k, j]
    float* Gp = G + p * nm;
    const bool vec = n % 4 == 0 && aligned16(Gp);
    gf::tile_product<false, false>(
        {g, 1, m, m}, {Cs + p * nn, 1, n, n}, n, i0, j0, smem, nothing,
        [&](int i, int j, const float(&v)[4]) { gf::store4(Gp, n, i, j, n, 1.f, v, vec); });
  } else if (first) {
    // dCs = -2 dv gamma P^T [n, n]: X = gamma (i, k), Y(k, j) = P[j, k]
    float* O = dCs + p * nn;
    const bool vec = n % 4 == 0 && aligned16(O);
    gf::tile_product<true, true>(
        {g, m, 1, n}, {P + p * nm, m, 1, n}, m, i0, j0, smem, nothing,
        [&](int i, int j, const float(&v)[4]) { gf::store4(O, n, i, j, n, scale, v, vec); });
  } else {
    // dCt = -2 dv G gamma [m, m]: X = G (i, k), Y(k, j) = gamma[k, j]
    float* O = dCt + p * mm;
    const bool vec = m % 4 == 0 && aligned16(O);
    gf::tile_product<true, false>(
        {G + p * nm, n, 1, m}, {g, 1, m, m}, n, i0, j0, smem, nothing,
        [&](int i, int j, const float(&v)[4]) { gf::store4(O, m, i, j, m, scale, v, vec); });
  }
}

// K13's tile tasks of one phase (1: t1 = Cs gamma, 2: the trace partials of
// t1 Ct^T). (ti, tj) is the tile grid of the [n, m] output; block x is tile
// x % (ti tj) of problem x / (ti tj), row by row.
template <int PHASE>
__global__ void __launch_bounds__(gf::THREADS, 2)
gwt_fwd_tiles_kernel(const float* __restrict__ Cs, const float* __restrict__ Ct,
                     const float* __restrict__ Cst, const float* __restrict__ gamma, float* t1,
                     float* __restrict__ part, int n, int m, int ti, int tj) {
  extern __shared__ float4 smem4[];
  __shared__ float red[gf::THREADS / 32];
  float* smem = reinterpret_cast<float*>(smem4);
  const int per = ti * tj, t = blockIdx.x % per;
  const size_t p = blockIdx.x / per, nm = (size_t)n * m;
  const int i0 = (t / tj) * gf::TILE, j0 = (t % tj) * gf::TILE;
  const float* g = gamma + p * nm;
  float* T1 = t1 + p * nm;
  auto nothing = [] {};
  if (PHASE == 1) {
    // t1 = Cs gamma [n, m]: X = Cs (i, k), Y(k, j) = gamma[k, j] (N-major)
    const bool vec = m % 4 == 0 && aligned16(T1);
    gf::tile_product<true, false>(
        {Cs + p * n * n, n, 1, n}, {g, 1, m, m}, n, i0, j0, smem, nothing,
        [&](int i, int j, const float(&v)[4]) { gf::store4(T1, m, i, j, m, 1.f, v, vec); });
  } else {
    // the tile's sum of (Cst - 2 t1 Ct^T) o gamma: X = t1 (i, k), Y(k, j) = Ct[j, k]
    const float* S = Cst + p * nm;
    float s = 0.f;
    gf::tile_product<true, true>(
        {T1, m, 1, n}, {Ct + p * (size_t)m * m, m, 1, m}, m, i0, j0, smem, nothing,
        [&](int i, int j, const float(&v)[4]) {
          const size_t e = (size_t)i * m + j;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (j + c < m) s += (S[e + c] - 2.f * v[c]) * g[e + c];
        });
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < gf::THREADS / 32; ++w) tot += red[w];
      part[blockIdx.x] = tot;
    }
  }
}

// out[p] = sum of problem p's `per` tile partials, in tile order.
__global__ void gwt_fwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                   int per, int b) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= b) return;
  float s = 0.f;
  for (int t = 0; t < per; ++t) s += part[(size_t)p * per + t];
  out[p] = s;
}

}  // namespace

// Shared memory one block needs, the largest of the four kernels.
extern "C" size_t got_glue_smem_bytes(int n, int m) {
  const size_t rows = (size_t)n + m + GROUPS * COLW + WARPS;   // K11, K12
  const size_t gemm = (size_t)gemm_smem_floats() + WARPS;      // K13, K14
  return sizeof(float) * (rows > gemm ? rows : gemm);
}

// Each entry point returns the cudaError_t of its launch (0 = success).
// Device pointers, f32, contiguous, shapes as in the header.
extern "C" int threshold_build_forward(const float* thr, const float* C0, const float* Cs0,
                                       const float* Ct0, float* C, float* Cs, float* Ct,
                                       float* Cst, int b, int n, int m, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)n + m);
  cudaError_t err = allow_smem(tb_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tb_fwd_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(thr, C0, Cs0, Ct0, C,
                                                                         Cs, Ct, Cst, n, m);
  return (int)cudaGetLastError();
}

extern "C" int threshold_build_backward(const float* thr, const float* C0, const float* Cs0,
                                        const float* Ct0, const float* dC, const float* dCs,
                                        const float* dCt, const float* dCst, float* dC0,
                                        float* dCs0, float* dCt0, float* dthr, int b, int n,
                                        int m, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)n + m + GROUPS * COLW + WARPS);
  cudaError_t err = allow_smem(tb_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tb_bwd_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      thr, C0, Cs0, Ct0, dC, dCs, dCt, dCst, dC0, dCs0, dCt0, dthr, n, m);
  return (int)cudaGetLastError();
}

// K13. t1: [b, n, m] scratch; part: [b, plan[0] plan[1]] scratch, the tile
// partials. plan: the tile grid (tiles_i, tiles_j) of the [n, m] products;
// a plan other than 128 x 128 tiles covering them is refused as
// cudaErrorInvalidValue.
extern "C" int gw_trace_forward(const float* Cs, const float* Ct, const float* Cst,
                                const float* gamma, float* t1, float* part, float* out, int b,
                                int n, int m, const long long* plan, void* stream) {
  if (plan[0] != gf::tiles(n) || plan[1] != gf::tiles(m)) return (int)cudaErrorInvalidValue;
  const long long per = plan[0] * plan[1];
  if ((long long)b * per >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gwt_fwd_tiles_kernel<1>, gf::SMEM_BYTES);
  if (err == cudaSuccess) err = allow_smem(gwt_fwd_tiles_kernel<2>, gf::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)(b * per);
  gwt_fwd_tiles_kernel<1><<<blocks, gf::THREADS, gf::SMEM_BYTES, st>>>(
      Cs, Ct, Cst, gamma, t1, part, n, m, (int)plan[0], (int)plan[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gwt_fwd_tiles_kernel<2><<<blocks, gf::THREADS, gf::SMEM_BYTES, st>>>(
      Cs, Ct, Cst, gamma, t1, part, n, m, (int)plan[0], (int)plan[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gwt_fwd_sum_kernel<<<(b + 255) / 256, 256, 0, st>>>(part, out, (int)per, b);
  return (int)cudaGetLastError();
}

// The first design of K13 (gwt_fwd_kernel, one block per problem), kept as a
// check: chip_smoke.py and the GPU tests hold gw_trace_forward's output to
// it at 1e-5 relative (another sum order). t1: [b, n, m] scratch.
extern "C" int gw_trace_forward_rowblock(const float* Cs, const float* Ct, const float* Cst,
                                         const float* gamma, float* t1, float* out, int b,
                                         int n, int m, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)gemm_smem_floats() + WARPS);
  cudaError_t err = allow_smem(gwt_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gwt_fwd_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(Cs, Ct, Cst, gamma,
                                                                          t1, out, n, m);
  return (int)cudaGetLastError();
}

// K14. P: [b, n, m] and G: [b, m, n] scratch. plan: the tile grids
// (tiles_i, tiles_j) of P, G, dCs and dCt (8 values); a plan other than
// 128 x 128 tiles covering each output is refused as cudaErrorInvalidValue.
extern "C" int gw_trace_backward(const float* dout, const float* Cs, const float* Ct,
                                 const float* gamma, float* P, float* G, float* dCs, float* dCt,
                                 float* dCst, int b, int n, int m, const long long* plan,
                                 void* stream) {
  const long long want[8] = {gf::tiles(n), gf::tiles(m), gf::tiles(m), gf::tiles(n),
                             gf::tiles(n), gf::tiles(n), gf::tiles(m), gf::tiles(m)};
  for (int k = 0; k < 8; ++k)
    if (plan[k] != want[k]) return (int)cudaErrorInvalidValue;
  const long long per1 = plan[0] * plan[1] + plan[2] * plan[3];
  const long long per2 = plan[4] * plan[5] + plan[6] * plan[7];
  if ((long long)b * (per1 > per2 ? per1 : per2) >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gwt_bwd_tiles_kernel<1>, gf::SMEM_BYTES);
  if (err == cudaSuccess) err = allow_smem(gwt_bwd_tiles_kernel<2>, gf::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gwt_bwd_tiles_kernel<1><<<(unsigned)(b * per1), gf::THREADS, gf::SMEM_BYTES, st>>>(
      dout, Cs, Ct, gamma, P, G, dCs, dCt, dCst, n, m, (int)plan[0], (int)plan[1],
      (int)plan[2], (int)plan[3]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gwt_bwd_tiles_kernel<2><<<(unsigned)(b * per2), gf::THREADS, gf::SMEM_BYTES, st>>>(
      dout, Cs, Ct, gamma, P, G, dCs, dCt, dCst, n, m, (int)plan[4], (int)plan[5],
      (int)plan[6], (int)plan[7]);
  return (int)cudaGetLastError();
}

// The first design of K14 (gwt_bwd_kernel, one block per problem), kept as a
// check: chip_smoke.py and the GPU tests hold gw_trace_backward's outputs
// bitwise equal to it. Same arguments as gw_trace_backward, without the plan.
extern "C" int gw_trace_backward_rowblock(const float* dout, const float* Cs, const float* Ct,
                                          const float* gamma, float* P, float* G, float* dCs,
                                          float* dCt, float* dCst, int b, int n, int m,
                                          void* stream) {
  const size_t smem = sizeof(float) * (size_t)gemm_smem_floats();
  cudaError_t err = allow_smem(gwt_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gwt_bwd_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      dout, Cs, Ct, gamma, P, G, dCs, dCt, dCst, n, m);
  return (int)cudaGetLastError();
}
