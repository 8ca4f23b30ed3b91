// The TMA + wgmma GEMM of gemm_wgmma.cuh behind one entry point, for its
// own tests and timings (ops/gemm.py): every layout and epilogue the
// whole-encoder kernels K6 and K7 instantiate, and kernel 19's. K6 and K7
// call the GEMM from their own libraries; nothing on the model's path calls
// this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"

namespace {

using madeleine::bf16;
using madeleine::WgOperand;
namespace wg = madeleine::wg;

template <bool A_MN, bool B_MN>
cudaError_t run(int epi, const WgOperand& a, const WgOperand& b, const wg::Params& p,
                cudaStream_t st) {
  switch (epi) {
    case wg::EPI_BF16: return madeleine::wg_gemm<A_MN, B_MN, wg::EPI_BF16>(a, b, p, st);
    case wg::EPI_F32: return madeleine::wg_gemm<A_MN, B_MN, wg::EPI_F32>(a, b, p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: layout (0: A and B K-major, 1: A K-major and B MN-major, 2: both
// MN-major), epilogue (0 bf16, 1 f32, 2 the gate logits: layout 0 only),
// wgrad (1: layout 2 with wg_wgrad's split plan, f32 into C through the
// workspace), M, N, K, batches, beta, act_split, then A's ld, rows, cols,
// off_mn, off_k, B's five, ldc, strideC, strideBias, and for the gate
// epilogue f, t, row_offset, seed, thr. scales: the gate dropout's keep
// scale. p: A, B, C, bias, ap, bp, lpart, wc, work (null where unused).
// Returns a cudaError_t.
extern "C" int gemm_wgmma_run(void** p, const long long* dims, const float* scales,
                              void* stream_) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const int layout = (int)dims[0], epi = (int)dims[1], wgrad = (int)dims[2];
  const int M = (int)dims[3], N = (int)dims[4], K = (int)dims[5], batches = (int)dims[6];
  const WgOperand a{(const bf16*)p[0], dims[9], dims[10], dims[11], (int)dims[12],
                    (int)dims[13]};
  const WgOperand b{(const bf16*)p[1], dims[14], dims[15], dims[16], (int)dims[17],
                    (int)dims[18]};
  if (wgrad)
    return layout == 2 ? (int)madeleine::wg_wgrad(a, b, M, N, K, batches, (float*)p[2],
                                                  (float*)p[8], st)
                       : (int)cudaErrorInvalidValue;
  wg::Params q = madeleine::wg_params(p[2], dims[19], (const float*)p[3], M, N, K);
  q.strideC = dims[20];
  q.strideBias = dims[21];
  q.batches = batches;
  q.beta = (int)dims[7];
  q.act_split = (int)dims[8];
  if (epi == wg::EPI_GATES) {
    if (layout != 0) return (int)cudaErrorInvalidValue;
    q.ap = (bf16*)p[4];
    q.bp = (bf16*)p[5];
    q.lpart = (float*)p[6];
    q.wc = (const float*)p[7];
    q.f = (int)dims[22];
    q.t = (int)dims[23];
    q.row_offset = (int)dims[24];
    q.d = madeleine::Dropout{(uint32_t)dims[25], (uint32_t)dims[26], scales[0]};
    return (int)madeleine::wg_gemm<false, false, wg::EPI_GATES>(a, b, q, st);
  }
  switch (layout) {
    case 0: return (int)run<false, false>(epi, a, b, q, st);
    case 1: return (int)run<false, true>(epi, a, b, q, st);
    case 2: return (int)run<true, true>(epi, a, b, q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Floats of workspace a wgrad run of gemm_wgmma_run needs.
extern "C" long long gemm_wgmma_wgrad_work(long long M, long long N, long long K,
                                           long long batches) {
  return madeleine::wg_wgrad_work_floats((int)M, (int)N, (int)K, (int)batches);
}
