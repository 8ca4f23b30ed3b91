// The TMA + wgmma GEMM of gemm_wgmma.cuh behind one entry point, for its
// own tests and timings (ops/gemm.py): every layout and epilogue the
// whole-encoder kernels K6 and K7 instantiate, and kernel 19's; and the
// split-TF32 GEMM of gemm_tf32.cuh (K6 / K7 with f32 operands) behind a
// second, with its weight split. K6 and K7 call the GEMMs from their own
// libraries; nothing on the model's path calls these.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tf32.cuh"
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

// The split-TF32 GEMM. dims: form (0: A K-major and B pre-split, gemm_tf32.cuh's
// form K with an f32 epilogue; 1: the weight gradient t32::wgrad, both
// operands token-major, split over the tokens by t32::wgrad_chunk), M, N, K,
// batches, beta, then A's ld, rows, cols, off_mn, off_k, B's five (form 0:
// B's hi rows, its lo rows after them), ldc, strideC, strideBias. p: A, B,
// C, bias, work (null where unused). Returns a cudaError_t.
extern "C" int gemm_tf32_run(void** p, const long long* dims, const float*, void* stream_) {
  namespace t32 = madeleine::t32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream_);
  const int form = (int)dims[0], M = (int)dims[1], N = (int)dims[2], K = (int)dims[3];
  const int batches = (int)dims[4];
  const t32::Operand a{(const float*)p[0], dims[6], dims[7], dims[8], (int)dims[9],
                       (int)dims[10]};
  const t32::Operand b{(const float*)p[1], dims[11], dims[12], dims[13], (int)dims[14],
                       (int)dims[15]};
  if (form == 1)
    return (int)t32::wgrad(a.p, a.ld, a.off_mn, b.p, b.ld, b.off_mn, M, N, K, batches,
                           (float*)p[2], (float*)p[4], st);
  if (form != 0) return (int)cudaErrorInvalidValue;
  t32::Params q = t32::params(p[2], dims[16], (const float*)p[3], M, N, K);
  q.g.strideC = dims[17];
  q.g.strideBias = dims[18];
  q.g.batches = batches;
  q.g.beta = (int)dims[5];
  return (int)t32::gemm<false, t32::EPI_F32>(a, b, q, st);
}

// Floats of workspace a form-1 run of gemm_tf32_run needs.
extern "C" long long gemm_tf32_wgrad_work(long long M, long long N, long long K,
                                          long long batches) {
  return madeleine::t32::wgrad_work_floats((int)M, (int)N, (int)K, (int)batches);
}

// t32::split_weights: p = {w [batches, R, C] f32, dst}, dims = {batches,
// R, C, transpose}: dst gets hi then lo, each [batches, R, C], or [batches,
// C, R] with transpose. Returns a cudaError_t.
extern "C" int gemm_tf32_split(void** p, const long long* dims, const float*, void* stream) {
  return (int)madeleine::t32::split_weights((const float*)p[0], (float*)p[1], (int)dims[0],
                                            (int)dims[1], (int)dims[2], dims[3] != 0,
                                            static_cast<cudaStream_t>(stream));
}
