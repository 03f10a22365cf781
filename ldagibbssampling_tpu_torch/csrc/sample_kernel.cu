// K3 of the v1-draw sweep: the log-space Gumbel draw of one block, against
// the block-start counts.
//
// Replaces ldagibbssampling_tpu/ops/pallas_gibbs.py::_sample_kernel (lines
// 311-342), reached through pallas_sample_block (349-417) from the XLA sweep
// with use_pallas=True (ops/gibbs.py:170-194).  For each token:
//
//   e     = (k == z_old)                      self-exclusion, unmasked as at :320
//   score = ((log(nwk - e + beta) + log(ndk - e + alpha)) - log(nk - e + V*beta))
//           + (-log(-log u))                  (no noise in deterministic mode)
//   z_new = first argmax over the real topics
//
// in float32, in that order.  The reference gathers [B, K] float32 copies of
// the token's nwk and ndk rows before the call; this kernel reads the rows
// straight from the int32 tables by word and doc id (int32 counts below 2^24
// convert to float32 exactly, as the reference's .astype(f32) gathers do).
// The reference scores pad topics (k >= K) -1e30; they never win, so the
// kernel does not visit them.  NaN scores (only a masked token's exclusion
// can drive a count negative) win as in jnp.argmax, at their first index;
// the caller discards masked tokens' draws.  No count is updated: the whole
// block draws against the block-start counts, so a block is one launch (the
// reference's row_tile is only a grid tile) and the sweep's count move
// (fused_kernel.cu, lda_count_move) follows it.
//
// What bounds it on an H100: per token one nwk row and one ndk row of K int32
// (the rows of frequent words and of the block's few documents stay in the
// 50 MB L2), and per (token, topic) three or four logf on the SFUs plus, in
// internal mode, a share of a Philox4x32-10.  Operations bound it; the
// design gives each token a warp (lane l takes topic groups l, l + 32, ...),
// so a block of 65,536 tokens fills the card many times over, and reduces
// the argmax with warp shuffles.
//
// Noise modes: 0 deterministic, 1 external (caller uniforms [n, K]), 2
// internal (Philox4x32-10 keyed by a per-sweep seed, counter (token slot,
// topic group of 4), philox.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// is (s, k) ahead of (best, best_k) in jnp.argmax's order: NaN first, then
// the larger value, then the lower topic
__device__ __forceinline__ bool ahead(float s, int k, float best, int best_k) {
  const bool sn = isnan(s), bn = isnan(best);
  if (sn != bn) return sn;
  if (!sn && s != best) return s > best;
  return k < best_k;
}

template <int kMode>
__global__ void gibbs_block_sample(
    const int* __restrict__ nwk, const int* __restrict__ ndk,
    const int* __restrict__ nk, int k_real, const int* __restrict__ z_old,
    int* __restrict__ z_new, const int* __restrict__ word,
    const int* __restrict__ doc, const float* __restrict__ uniforms, int n,
    float alpha, float beta, float vbeta, uint32_t key0, uint32_t key1,
    long long slot0) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // whole warp
  const int zo = z_old[i];
  const int* wrow = nwk + static_cast<long long>(word[i]) * k_real;
  const int* drow = ndk + static_cast<long long>(doc[i]) * k_real;
  const unsigned long long slot = static_cast<unsigned long long>(slot0 + i);

  float best = -INFINITY;
  int best_k = k_real;
  for (int g = lane; 4 * g < k_real; g += 32) {
    float u[4] = {0.5f, 0.5f, 0.5f, 0.5f};
    if (kMode == 2) {
      const uint4 b = lda::philox_group(slot, g, key0, key1);
      u[0] = lda::bits_to_uniform(b.x);
      u[1] = lda::bits_to_uniform(b.y);
      u[2] = lda::bits_to_uniform(b.z);
      u[3] = lda::bits_to_uniform(b.w);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * g + j;
      if (k >= k_real) break;
      const float e = (k == zo) ? 1.0f : 0.0f;
      float s = (logf(static_cast<float>(wrow[k]) - e + beta) +
                 logf(static_cast<float>(drow[k]) - e + alpha)) -
                logf(static_cast<float>(nk[k]) - e + vbeta);
      if (kMode == 1) {
        s = s + (-logf(-logf(uniforms[static_cast<long long>(i) * k_real + k])));
      } else if (kMode == 2) {
        s = s + (-logf(-logf(u[j])));
      }
      if (ahead(s, k, best, best_k)) {
        best = s;
        best_k = k;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int ok = __shfl_down_sync(0xffffffffu, best_k, off);
    if (ahead(ov, ok, best, best_k)) {
      best = ov;
      best_k = ok;
    }
  }
  if (lane == 0) z_new[i] = best_k;
}

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Draw every token of [0, n_tokens) against the given counts in one launch;
// returns cudaGetLastError.
extern "C" int lda_block_sample(const void* nwk, const void* ndk,
                                const void* nk, int k_real, const void* z_old,
                                void* z_new, const void* word, const void* doc,
                                const void* uniforms, long long n_tokens,
                                float alpha, float beta, float vbeta,
                                int noise_mode, unsigned long long seed,
                                long long slot0, void* stream) {
  if (noise_mode < 0 || noise_mode > 2 || k_real <= 0 ||
      n_tokens >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tokens == 0) return static_cast<int>(cudaGetLastError());
  const int n = static_cast<int>(n_tokens);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int*>(nwk);
  const auto* d = static_cast<const int*>(ndk);
  const auto* t = static_cast<const int*>(nk);
  const auto* zo = static_cast<const int*>(z_old);
  auto* zn = static_cast<int*>(z_new);
  const auto* wd = static_cast<const int*>(word);
  const auto* dc = static_cast<const int*>(doc);
  const auto* un = static_cast<const float*>(uniforms);
  const uint32_t key0 = static_cast<uint32_t>(seed);
  const uint32_t key1 = static_cast<uint32_t>(seed >> 32);
  if (noise_mode == 0) {
    gibbs_block_sample<0><<<grid, block, 0, s>>>(
        w, d, t, k_real, zo, zn, wd, dc, un, n, alpha, beta, vbeta, key0, key1,
        slot0);
  } else if (noise_mode == 1) {
    gibbs_block_sample<1><<<grid, block, 0, s>>>(
        w, d, t, k_real, zo, zn, wd, dc, un, n, alpha, beta, vbeta, key0, key1,
        slot0);
  } else {
    gibbs_block_sample<2><<<grid, block, 0, s>>>(
        w, d, t, k_real, zo, zn, wd, dc, un, n, alpha, beta, vbeta, key0, key1,
        slot0);
  }
  return static_cast<int>(cudaGetLastError());
}
