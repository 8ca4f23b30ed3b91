// Philox4x32-10 dropout masks for the train kernels (K6, K7).
//
// Same bits as madeleine_torch/ops/prng.py (the plain versions' masks):
//   key = (seed, 0), counter = (column / 4, token, global row, stream),
//   bits of column c = word (c % 4) of the output.
// Streams: 0..2 the pre-attention layers, 3 + 2*h + branch the gate branches.
// A site is kept when bits >= thr (32-bit threshold) and then scaled by
// `scale`, which the wrapper derives from thr; thr == 0 means no dropout.
#pragma once

#include <stdint.h>

namespace madeleine {

struct Philox4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                                 uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return {c0, c1, c2, c3};
}

struct Dropout {
  uint32_t seed, thr;
  float scale;
};

// Keep-scales of columns 4*c4 .. 4*c4+3 of one site row.
__device__ __forceinline__ void keep4(const Dropout& d, int c4, int tok, int row, int stream,
                                      float (&k)[4]) {
  if (d.thr == 0u) {
    k[0] = k[1] = k[2] = k[3] = 1.f;
    return;
  }
  const Philox4 r = philox4x32_10((uint32_t)c4, (uint32_t)tok, (uint32_t)row,
                                  (uint32_t)stream, d.seed, 0u);
  k[0] = r.x >= d.thr ? d.scale : 0.f;
  k[1] = r.y >= d.thr ? d.scale : 0.f;
  k[2] = r.z >= d.thr ? d.scale : 0.f;
  k[3] = r.w >= d.thr ? d.scale : 0.f;
}

}  // namespace madeleine
