// Philox4x32-10 and its 24-bit uniforms: the internal noise of the draw
// kernels (fused_kernel.cu, sample_kernel.cu).  Both key it per sweep and
// count (token slot, topic group of 4, 0, 0), so a token's bits depend only
// on its place in the stream; ops/fused_kernel.philox_uniforms is the same
// function in PyTorch.
#pragma once

#include <stdint.h>

namespace lda {

__device__ __forceinline__ void mulhilo(uint32_t a, uint32_t b, uint32_t& hi,
                                        uint32_t& lo) {
  const uint64_t p = static_cast<uint64_t>(a) * static_cast<uint64_t>(b);
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// Philox4x32-10 (Salmon et al., SC'11), as in Random123
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(0xD2511F53u, c.x, hi0, lo0);
    mulhilo(0xCD9E8D57u, c.z, hi1, lo1);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the bits of topic group g of stream slot `slot`
__device__ __forceinline__ uint4 philox_group(unsigned long long slot, int g,
                                              uint32_t k0, uint32_t k1) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(slot),
                                  static_cast<uint32_t>(slot >> 32),
                                  static_cast<uint32_t>(g), 0u),
                       k0, k1);
}

// low 24 bits -> (bits + 0.5) * 2^-24, as at pallas_gibbs.py:161
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return static_cast<float>(bits & 0xFFFFFFu) * 5.9604644775390625e-8f +
         2.98023223876953125e-8f;
}

}  // namespace lda
