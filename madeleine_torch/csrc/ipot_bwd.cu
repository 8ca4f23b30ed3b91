// IPOT transport plan, backward (kernel K9).
//
// Replaces madeleine_tpu/ops/ipot.py::_bwd_kernel: the exact adjoint of the
// unrolled forward loop (the derivative that autodiff through the loop
// computes; the reference differentiates through the unconverged iterations).
// Given C [b, n, m] and the plan's cotangent G [b, n, m], returns dC.
//
// First the forward is replayed, storing each iteration's input T_k (a
// history in device memory: 2.0 GB at the train step's [260, 256, 256] and 30
// iterations; the TPU kept it in VMEM, which no SM can), its delta_k and
// sigma_k. Then, for k = iters-1 .. 0, with Q = A o T_k, delta = delta_k,
// sigma1 = sigma_{k+1} and the incoming dT, dsig:
//   dsig1  = dsig + colsum((delta o dT) o Q)
//   da     = -m sigma1^2 dsig1
//   ddelta = rowsum(Q o (dT sigma1)) + rowsum(Q o da)    (the two adjoint terms)
//   du     = -n delta^2 ddelta
//   dQ     = dT delta sigma1 + delta da + du sigma_k
//   dsig   = colsum(du o Q);  dT = dQ o A;  dA += dQ o T_k
// and finally dC = dA o A * (-1 / beta).
//
// What bounds it on an H100: the TPU kernel's CostEstimate, 6 * b * iters *
// 7 * n * m flops (43 GFLOP at [260, 256, 256] x 30), 0.64 ms at the FP32
// peak. The history this design must write and read back (2.0 GB twice) is a
// floor of its own, about 1.2 ms at 3.35 TB/s.
//
// Two routes, chosen by shape in madeleine_torch/ops/ipot.py::transport_route.
//
// The cluster route (ipot_bwd_cluster_kernel, the train step's): one cluster
// of c blocks per problem (ipot_cluster.cuh; c = 8 at [256, 256]), the block
// of rank r keeping its slice of rows of A, dT and dA in shared memory for
// the whole launch, plus two slices of T_k (5 x 32 KB at [256, 256]). The
// replay writes each T_k slice to the history once, with ordinary stores; the
// adjoint reads each back once, with a 1-D bulk copy (cp.async.bulk with an
// mbarrier) issued one iteration ahead into the other T_k slice (T_{iters-1}
// is still in shared memory when the replay ends). delta_k stays per row in
// device memory, sigma_k per block (each block reads back only what it
// wrote). Per adjoint iteration one cluster exchange combines two column
// partials, each in rank order: this iteration's dsig1 and the previous
// one's dsig. On the fast path (m <= 256, m % 4 == 0) one sweep per
// iteration then computes du, dQ, dT and dA and both partials of the next
// exchange (the dsig1 partial needs T_{k-1}, whose copy has landed by
// then); per replay iteration one sweep and one exchange. The general path
// makes a column pass, a row pass and a column pass per adjoint iteration,
// a row and a column pass per replay iteration. G and C are read once, dC
// written once. At the step's shape
// 15 clusters of 8 fit the card at once, so 260 problems take 18 waves, each
// set by the latency of its 60 iteration chains.
//
// The global route (ipot_bwd_kernel, the first design, for problems whose
// state does not fit a cluster): one block of 512 threads per problem, A, dT
// and the dA accumulator (in the dC buffer) in device memory; per backward
// iteration two column passes and a row pass over A, T_k and dT, so it is
// bound by memory traffic far above the operations bound (sums in a fixed
// order, no atomics, so two launches are bitwise equal).

#include "ipot_cluster.cuh"
#include "ipot_common.cuh"

using namespace madeleine_ipot;

namespace {

__global__ void __launch_bounds__(THREADS, 2)
ipot_bwd_kernel(const float* __restrict__ C, const float* __restrict__ G, float* A, float* Th,
                float* Dh, float* Sh, float* dT, float* dC, int n, int m, float beta,
                int iters) {
  extern __shared__ float smem[];
  float* delta = smem;          // [n]
  float* du = delta + n;        // [n]
  float* sigma = du + n;        // [m]  sigma_k
  float* sigma1 = sigma + m;    // [m]  sigma_{k+1}
  float* da = sigma1 + m;       // [m]
  float* dsig = da + m;         // [m]
  float* part = dsig + m;       // [GROUPS * COLW]
  const int tid = threadIdx.x;
  const int c = tid % COLW, g = tid / COLW;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t nm = (size_t)n * m, off = (size_t)blockIdx.x * nm;
  A += off; dT += off; dC += off;
  Th += (size_t)blockIdx.x * iters * nm;
  Dh += (size_t)blockIdx.x * iters * n;
  Sh += (size_t)blockIdx.x * (iters + 1) * m;
  exp_cost(C + off, A, nm, beta);
  for (size_t e = tid; e < nm; e += THREADS) {
    dT[e] = G[off + e];
    dC[e] = 0.f;
  }
  for (int j = tid; j < m; j += THREADS) {
    sigma[j] = 1.f / (float)m;
    Sh[j] = sigma[j];
    dsig[j] = 0.f;
  }
  __syncthreads();

  // ---- replay: the row pass of iteration k writes T_k into Th[k] ----------
  for (int k = 0; k < iters; ++k) {
    row_pass(A, Th + (k > 0 ? (size_t)(k - 1) * nm : 0), Th + (size_t)k * nm, delta, sigma, n,
             m, k == 0, true);
    __syncthreads();
    col_pass(A, Th + (size_t)k * nm, delta, sigma, part, n, m);
    for (int i = tid; i < n; i += THREADS) Dh[(size_t)k * n + i] = delta[i];
    for (int j = tid; j < m; j += THREADS) Sh[(size_t)(k + 1) * m + j] = sigma[j];
    __syncthreads();   // the next row pass rewrites delta in place
  }

  // ---- adjoint, last iteration first --------------------------------------
  for (int k = iters - 1; k >= 0; --k) {
    const float* Tk = Th + (size_t)k * nm;
    for (int i = tid; i < n; i += THREADS) delta[i] = Dh[(size_t)k * n + i];
    for (int j = tid; j < m; j += THREADS) {
      sigma[j] = Sh[(size_t)k * m + j];
      sigma1[j] = Sh[(size_t)(k + 1) * m + j];
    }
    __syncthreads();
    // da_j from dsig1_j = dsig_j + colsum((delta o dT) o Q)
    for (int j0 = 0; j0 < m; j0 += COLW) {
      const int j = j0 + c;
      float acc = 0.f;
      if (j < m)
        for (int i = g; i < n; i += GROUPS) {
          const size_t e = (size_t)i * m + j;
          acc += (delta[i] * dT[e]) * (A[e] * Tk[e]);
        }
      part[g * COLW + c] = acc;
      __syncthreads();
      if (g == 0 && j < m) {
        float s = part[c];
#pragma unroll
        for (int q = 1; q < GROUPS; ++q) s += part[q * COLW + c];
        const float dsig1 = dsig[j] + s;
        da[j] = ((-(float)m * sigma1[j]) * sigma1[j]) * dsig1;
      }
      __syncthreads();
    }
    // du_i from ddelta_i = rowsum(Q o (dT sigma1)) + rowsum(Q o da)
    for (int i = warp; i < n; i += WARPS) {
      const size_t r = (size_t)i * m;
      float acc1 = 0.f, acc2 = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float q = A[r + j] * Tk[r + j];
        acc1 += q * (dT[r + j] * sigma1[j]);
        acc2 += q * da[j];
      }
      acc1 = warp_sum(acc1);
      acc2 = warp_sum(acc2);
      if (lane == 0) du[i] = ((-(float)n * delta[i]) * delta[i]) * (acc1 + acc2);
    }
    __syncthreads();
    // dQ, then dT <- dQ o A, dA += dQ o T_k, dsig <- colsum(du o Q)
    for (int j0 = 0; j0 < m; j0 += COLW) {
      const int j = j0 + c;
      float acc = 0.f;
      if (j < m)
        for (int i = g; i < n; i += GROUPS) {
          const size_t e = (size_t)i * m + j;
          const float a = A[e], t = Tk[e], q = a * t;
          const float dq = (dT[e] * delta[i]) * sigma1[j] + delta[i] * da[j] + du[i] * sigma[j];
          acc += du[i] * q;
          dT[e] = dq * a;
          dC[e] += dq * t;
        }
      part[g * COLW + c] = acc;
      __syncthreads();
      if (g == 0 && j < m) {
        float s = part[c];
#pragma unroll
        for (int q = 1; q < GROUPS; ++q) s += part[q * COLW + c];
        dsig[j] = s;
      }
      __syncthreads();
    }
  }
  const float scale = -1.f / beta;
  for (size_t e = tid; e < nm; e += THREADS) dC[e] = (dC[e] * A[e]) * scale;
}

namespace cl = madeleine_ipot::cluster;

// shared memory of the cluster route: A, dT, dA and two T_k slices; delta_k,
// du (the general path) or delta_{k-1} (the fast path) [rows]; sigma_k,
// sigma_{k+1} and da [m]; the receive buffers (two parities of two vectors
// of c slots); the column-sum scratch; two mbarriers
__host__ __device__ inline size_t cluster_smem_floats(int n, int m, int c) {
  return 5 * cl::slice_floats(n, m, c) + 2 * cl::round4(cl::max_rows(n, c)) +
         (3 + 4 * (size_t)c) * cl::round4(m) + cl::red_floats(m) + 4;
}

// FAST: cl::fast_path(m). The replay runs ipot_loop_fast; each adjoint
// iteration is one sweep (a warp per row, two rows at a time, lane l holding
// columns cl::fcol(l, t)) that computes du, updates dT and dA, and
// accumulates in registers both column partials of the next exchange:
// dsig's, and the next iteration's colsum((delta_{k-1} o dT) o (A o
// T_{k-1})), whose T_{k-1} slice was copied in during the iteration before.
// The general path (any other m) makes a column pass, a row pass and a
// column pass per adjoint iteration.
template <bool FAST>
__global__ void __launch_bounds__(cl::CTHREADS, 1)
ipot_bwd_cluster_kernel(const float* __restrict__ C, const float* __restrict__ G, float* Th,
                        float* Dh, float* Sh, float* __restrict__ dC, int n, int m, float beta,
                        int iters) {
  cl::cg::cluster_group cluster = cl::cg::this_cluster();
  const int c = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int p = blockIdx.x / c, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = cl::row0(n, c, r), nr = cl::row0(n, c, r + 1) - r0;
  const size_t S = cl::slice_floats(n, m, c), mp = cl::round4(m);
  const size_t rp = cl::round4(cl::max_rows(n, c));
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // [nr, m] each
  float* dT = A + S;
  float* dA = dT + S;
  float* Tb[2] = {dA + S, dA + 2 * S};          // T_k slices
  float* delta = dA + 3 * S;                    // [nr]  delta_k
  float* du = delta + rp;                       // [nr]  du, or delta_{k-1} (FAST)
  float* sigma = du + rp;                       // [m]  sigma_k
  float* sigma1 = sigma + mp;                   // [m]  sigma_{k+1}
  float* da = sigma1 + mp;                      // [m]
  float* recv = da + mp;                        // [2 parities][2 vectors][c][mp]
  float* red = recv + 4 * c * mp;               // column-sum scratch
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + cl::red_floats(m));   // [2]
  const size_t nm = (size_t)n * m, nrm = (size_t)nr * m;
  const size_t off = (size_t)p * nm + (size_t)r0 * m;
  float* hist = Th + (size_t)p * iters * c * S + (size_t)r * S;   // + k * c * S
  float* Dp = Dh + (size_t)p * iters * n + r0;                     // + k * n + i
  float* Sp = Sh + ((size_t)p * c + r) * (size_t)(iters + 1) * m;  // + k * m + j
  if (tid == 0) {
    cl::mbar_init(&bar[0], 1);
    cl::mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (size_t e = tid; e < nrm; e += cl::CTHREADS) {
    A[e] = expf(-C[off + e] / beta);
    dT[e] = G[off + e];
    dA[e] = 0.f;
  }
  for (int j = tid; j < m; j += cl::CTHREADS) {
    sigma[j] = 1.f / (float)m;
    Sp[j] = sigma[j];
  }
  __syncthreads();

  // ---- replay: iteration k writes T_k (Tb[0] and the history) -------------
  int par = 0;
  if (FAST) {
    cl::ipot_loop_fast(cluster, A, Tb[0], delta, sigma, recv, 2 * c * mp, red, nr, n, m, iters,
                       par, false, hist, (size_t)c * S, Dp, Sp);
  } else {
    for (int k = 0; k < iters; ++k) {
      cl::row_update(A, Tb[0], delta, sigma, nr, n, m, k == 0, true,
                     hist + (size_t)k * c * S);
      __syncthreads();
      float* rv = recv + par * 2 * c * mp;
      cl::col_partial(red, nr, m, [&](int i, size_t e) { return (A[e] * Tb[0][e]) * delta[i]; },
                      [&](int j, float s) { cl::push(cluster, rv, r, c, mp, j, s); });
      for (int i = tid; i < nr; i += cl::CTHREADS) Dp[(size_t)k * n + i] = delta[i];
      cluster.sync();
      for (int j = tid; j < m; j += cl::CTHREADS) {
        sigma[j] = 1.f / ((float)m * cl::recv_sum(rv, c, mp, j));
        Sp[(size_t)(k + 1) * m + j] = sigma[j];
      }
      __syncthreads();   // the next row pass reads sigma and rewrites delta
      par ^= 1;
    }
  }
  // the stores to the history and to Tb (generic proxy) before the bulk
  // copies (async proxy) that read the one and overwrite the other
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();

  // ---- adjoint, last iteration first ---------------------------------------
  // T_k is in Tb[(iters - 1 - k) & 1]; T_{iters-1} is Tb[0] from the replay
  uint32_t phase[2] = {0u, 0u};
  const uint32_t slice_bytes = (uint32_t)(S * sizeof(float));
  if (FAST && iters > 0) {
    // iteration iters-1's dsig1 partial (delta_{iters-1} is still in delta)
    float ca[cl::JPL];
#pragma unroll
    for (int t = 0; t < cl::JPL; ++t) ca[t] = 0.f;
    for (int i = warp; i < nr; i += cl::CWARPS) {
      const float d = delta[i];
      const size_t row = (size_t)i * m;
#pragma unroll
      for (int t = 0; t < cl::JPL; ++t) {
        const int j = cl::fcol(lane, t);
        if (j < m) ca[t] += (d * dT[row + j]) * (A[row + j] * Tb[0][row + j]);
      }
    }
    float* rv0 = recv + par * 2 * c * mp;
    cl::lanes_to_part(ca, red, m, [&](int j, float s) { cl::push(cluster, rv0, r, c, mp, j, s); });
    if (iters > 1 && tid == 0)
      cl::bulk_load(Tb[1], hist + (size_t)(iters - 2) * c * S, slice_bytes, &bar[1]);
    for (int k = iters - 1; k >= 0; --k) {
      const int cur = (iters - 1 - k) & 1;
      const float* Tk = Tb[cur];
      const float* Tn = Tb[cur ^ 1];   // T_{k-1}, in flight
      for (int i = tid; i < nr; i += cl::CTHREADS) {
        delta[i] = Dp[(size_t)k * n + i];
        if (k > 0) du[i] = Dp[(size_t)(k - 1) * n + i];
      }
      cluster.sync();
      const float* rv = recv + par * 2 * c * mp;   // the dsig1 partials, then dsig's
      for (int j = tid; j < m; j += cl::CTHREADS) {
        const float s = cl::recv_sum(rv, c, mp, j);
        const float dsig = k == iters - 1 ? 0.f : cl::recv_sum(rv + c * mp, c, mp, j);
        const float s1 = Sp[(size_t)(k + 1) * m + j];
        sigma[j] = Sp[(size_t)k * m + j];
        sigma1[j] = s1;
        da[j] = ((-(float)m * s1) * s1) * (dsig + s);
      }
      __syncthreads();
      par ^= 1;
      float sk[cl::JPL], s1[cl::JPL], dav[cl::JPL], ca2[cl::JPL], cd[cl::JPL];
      cl::lane_load(sk, sigma, m);
      cl::lane_load(s1, sigma1, m);
      cl::lane_load(dav, da, m);
#pragma unroll
      for (int t = 0; t < cl::JPL; ++t) ca2[t] = cd[t] = 0.f;
      if (k > 0) {
        cl::mbar_wait(&bar[cur ^ 1], phase[cur ^ 1]);
        phase[cur ^ 1] ^= 1u;
      }
      // two rows of the warp at a time (i and i + CWARPS), so that their
      // dependency chains overlap; each row's sums keep their order
      for (int i = warp; i < nr; i += 2 * cl::CWARPS) {
        const int ii[2] = {i, i + cl::CWARPS};
        float q[2][cl::JPL], acc1[2] = {0.f, 0.f}, acc2[2] = {0.f, 0.f};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const size_t row = (size_t)ii[p] * m;
#pragma unroll
          for (int t2 = 0; t2 < cl::JPL / 4; ++t2) {
            const int j = 4 * lane + 128 * t2;
            float* qq = q[p] + 4 * t2;
            qq[0] = qq[1] = qq[2] = qq[3] = 0.f;
            if (ii[p] < nr && j < m) {
              const float4 a4 = *reinterpret_cast<const float4*>(A + row + j);
              const float4 t4 = *reinterpret_cast<const float4*>(Tk + row + j);
              const float4 g4 = *reinterpret_cast<const float4*>(dT + row + j);
              const float a[4] = {a4.x, a4.y, a4.z, a4.w}, x[4] = {t4.x, t4.y, t4.z, t4.w};
              const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int t = 4 * t2 + u;
                qq[u] = a[u] * x[u];
                acc1[p] += qq[u] * (g[u] * s1[t]);
                acc2[p] += qq[u] * dav[t];
              }
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {   // warp_sum of the four sums, interleaved
          acc1[0] += __shfl_xor_sync(0xffffffffu, acc1[0], o);
          acc1[1] += __shfl_xor_sync(0xffffffffu, acc1[1], o);
          acc2[0] += __shfl_xor_sync(0xffffffffu, acc2[0], o);
          acc2[1] += __shfl_xor_sync(0xffffffffu, acc2[1], o);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (ii[p] >= nr) continue;
          const float d = delta[ii[p]], dn = k > 0 ? du[ii[p]] : 0.f;
          const float dui = ((-(float)n * d) * d) * (acc1[p] + acc2[p]);
          const size_t row = (size_t)ii[p] * m;
#pragma unroll
          for (int t2 = 0; t2 < cl::JPL / 4; ++t2) {
            const int j = 4 * lane + 128 * t2;
            if (j < m) {
              const size_t e = row + j;
              const float4 a4 = *reinterpret_cast<const float4*>(A + e);
              const float4 t4 = *reinterpret_cast<const float4*>(Tk + e);
              const float4 g4 = *reinterpret_cast<const float4*>(dT + e);
              const float4 h4 = *reinterpret_cast<const float4*>(dA + e);
              const float4 n4 = k > 0 ? *reinterpret_cast<const float4*>(Tn + e) : a4;
              const float a[4] = {a4.x, a4.y, a4.z, a4.w}, x[4] = {t4.x, t4.y, t4.z, t4.w};
              const float gi[4] = {g4.x, g4.y, g4.z, g4.w}, tn[4] = {n4.x, n4.y, n4.z, n4.w};
              float go[4], h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int t = 4 * t2 + u;
                const float dq = (gi[u] * d) * s1[t] + d * dav[t] + dui * sk[t];
                go[u] = dq * a[u];
                h[u] += dq * x[u];
                if (k > 0) {
                  cd[t] += dui * q[p][t];
                  ca2[t] += (dn * go[u]) * (a[u] * tn[u]);
                }
              }
              *reinterpret_cast<float4*>(dT + e) = make_float4(go[0], go[1], go[2], go[3]);
              *reinterpret_cast<float4*>(dA + e) = make_float4(h[0], h[1], h[2], h[3]);
            }
          }
        }
      }
      if (k > 0) {
        float* rn = recv + par * 2 * c * mp;
        cl::lanes_to_part(ca2, red, m,
                          [&](int j, float s) { cl::push(cluster, rn, r, c, mp, j, s); });
        __syncthreads();
        cl::lanes_to_part(cd, red, m, [&](int j, float s) {
          cl::push(cluster, rn + c * mp, r, c, mp, j, s);
        });
      }
      __syncthreads();   // Tk, delta and du are free
      if (k > 1 && tid == 0)
        cl::bulk_load(Tb[cur], hist + (size_t)(k - 2) * c * S, slice_bytes, &bar[cur]);
    }
  } else {
    for (int k = iters - 1; k >= 0; --k) {
      const int cur = (iters - 1 - k) & 1;
      float* Tk = Tb[cur];
      if (k < iters - 1) {
        cl::mbar_wait(&bar[cur], phase[cur]);
        phase[cur] ^= 1u;
      }
      // prefetch T_{k-1} into the other slice (last read in iteration k + 1)
      if (k > 0 && tid == 0)
        cl::bulk_load(Tb[cur ^ 1], hist + (size_t)(k - 1) * c * S, slice_bytes, &bar[cur ^ 1]);
      for (int i = tid; i < nr; i += cl::CTHREADS) delta[i] = Dp[(size_t)k * n + i];
      for (int j = tid; j < m; j += cl::CTHREADS) {
        sigma[j] = Sp[(size_t)k * m + j];
        sigma1[j] = Sp[(size_t)(k + 1) * m + j];
      }
      __syncthreads();
      // the dsig1 partial: colsum((delta o dT) o Q)
      float* rv = recv + par * 2 * c * mp;   // this partial, then dsig's (iteration k + 1)
      cl::col_partial(red, nr, m,
                      [&](int i, size_t e) { return (delta[i] * dT[e]) * (A[e] * Tk[e]); },
                      [&](int j, float s) { cl::push(cluster, rv, r, c, mp, j, s); });
      cluster.sync();
      for (int j = tid; j < m; j += cl::CTHREADS) {
        const float s = cl::recv_sum(rv, c, mp, j);
        const float dsig = k == iters - 1 ? 0.f : cl::recv_sum(rv + c * mp, c, mp, j);
        da[j] = ((-(float)m * sigma1[j]) * sigma1[j]) * (dsig + s);
      }
      __syncthreads();
      par ^= 1;
      // du_i from ddelta_i = rowsum(Q o (dT sigma1)) + rowsum(Q o da)
      for (int i = warp; i < nr; i += cl::CWARPS) {
        const size_t row = (size_t)i * m;
        float acc1 = 0.f, acc2 = 0.f;
        for (int j = lane; j < m; j += 32) {
          const float q = A[row + j] * Tk[row + j];
          acc1 += q * (dT[row + j] * sigma1[j]);
          acc2 += q * da[j];
        }
        acc1 = warp_sum(acc1);
        acc2 = warp_sum(acc2);
        if (lane == 0) du[i] = ((-(float)n * delta[i]) * delta[i]) * (acc1 + acc2);
      }
      __syncthreads();
      // dQ, then dT <- dQ o A, dA += dQ o T_k, and (for iteration k - 1) the
      // partial of dsig = colsum(du o Q) into the next exchange's second vector
      auto update = [&](int i, size_t e) {
        const int j = (int)(e - (size_t)i * m);
        const float a = A[e], t = Tk[e], q = a * t;
        const float dq = (dT[e] * delta[i]) * sigma1[j] + delta[i] * da[j] + du[i] * sigma[j];
        dT[e] = dq * a;
        dA[e] += dq * t;
        return du[i] * q;
      };
      if (k > 0) {
        float* rn = recv + par * 2 * c * mp + c * mp;
        cl::col_partial(red, nr, m, update,
                        [&](int j, float s) { cl::push(cluster, rn, r, c, mp, j, s); });
      } else {
        for (size_t e = tid; e < nrm; e += cl::CTHREADS) update((int)(e / m), e);
      }
      __syncthreads();
    }
  }
  const float scale = -1.f / beta;
  for (size_t e = tid; e < nrm; e += cl::CTHREADS) dC[off + e] = (dA[e] * A[e]) * scale;
  cluster.sync();   // no block leaves while a peer may still read its shared memory
}

}  // namespace

extern "C" size_t ipot_bwd_smem_bytes(int n, int m) {
  return sizeof(float) * (2 * (size_t)n + 4 * (size_t)m + GROUPS * COLW);
}

// Returns the cudaError_t of the launch (0 = success). Device pointers, all
// f32 and contiguous: C, G, A (scratch), dT (scratch) and dC [b, n, m]; the
// history Th [b, iters, n, m], Dh [b, iters, n], Sh [b, iters + 1, m].
extern "C" int ipot_backward(const float* C, const float* G, float* A, float* Th, float* Dh,
                             float* Sh, float* dT, float* dC, int b, int n, int m, float beta,
                             int iters, void* stream) {
  const size_t smem = ipot_bwd_smem_bytes(n, m);
  cudaError_t err = allow_smem(ipot_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ipot_bwd_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      C, G, A, Th, Dh, Sh, dT, dC, n, m, beta, iters);
  return (int)cudaGetLastError();
}

extern "C" size_t ipot_bwd_cluster_smem_bytes(int n, int m, int c) {
  return sizeof(float) * cluster_smem_floats(n, m, c);
}

// floats of the cluster route's T_k history: [b, iters, c, slice]
extern "C" size_t ipot_bwd_cluster_history_floats(int b, int n, int m, int c, int iters) {
  return (size_t)b * iters * c * cl::slice_floats(n, m, c);
}

// The cluster route: C, G [b, n, m] in, dC [b, n, m] out; Th the history
// (ipot_bwd_cluster_history_floats), Dh [b, iters, n], Sh [b, c, iters + 1, m]
// scratch; device pointers, f32, contiguous, Th 16-byte aligned; c blocks per
// problem. Returns the cudaError_t of the launch (0 = success).
extern "C" int ipot_bwd_cluster(const float* C, const float* G, float* Th, float* Dh, float* Sh,
                                float* dC, int b, int n, int m, int c, float beta, int iters,
                                void* stream) {
  const size_t smem = ipot_bwd_cluster_smem_bytes(n, m, c);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cl::fast_path(m))
    return (int)cl::launch_clusters(ipot_bwd_cluster_kernel<true>, b, c, smem, st, C, G, Th, Dh,
                                    Sh, dC, n, m, beta, iters);
  return (int)cl::launch_clusters(ipot_bwd_cluster_kernel<false>, b, c, smem, st, C, G, Th, Dh,
                                  Sh, dC, n, m, beta, iters);
}

// cudaOccupancyMaxActiveClusters of the cluster route at (n, m, c)
extern "C" int ipot_bwd_cluster_occupancy(int n, int m, int c) {
  const size_t smem = ipot_bwd_cluster_smem_bytes(n, m, c);
  return cl::fast_path(m) ? cl::active_clusters(ipot_bwd_cluster_kernel<true>, c, smem)
                         : cl::active_clusters(ipot_bwd_cluster_kernel<false>, c, smem);
}
