// K1 of the deferred collapsed-Gibbs sweep: per-tile draw + count update.
//
// Replaces ldagibbssampling_tpu/ops/pallas_gibbs.py::_fused_kernel (lines
// 58-192) as the deferred tier calls it through pallas_fused_block
// (emit_delta=False, compute_dtype="float32").  For each token of a tile:
//
//   e     = (k == z_old)                      self-exclusion
//   r     = 1 / bf16(nk + V*beta),  rr = r * r
//   p     = ((nwk - e + beta) * (ndk - e + alpha)) * (r + e * rr)
//   score = p * (1 / bf16(-log u))            (p alone in deterministic mode)
//   z_new = first argmax over the real topics (pad topics score -1);
//           masked tokens keep z_old
//
// then -1 at (doc, z_old) and +1 at (doc, z_new) in ndk and nk before the
// next tile.  The two reciprocals are what the reference computes for
// pl.reciprocal(approx=True) under the CPU interpreter: the float32
// reciprocal of the bf16-cast input (jax/_src/pallas/primitives.py lowers it
// as reciprocal(x.astype(bf16)).astype(f32), and XLA keeps the quotient in
// float32), not the TPU's hardware estimate.
// No FMA contraction can change a rounding here: the only products that feed
// an add are e * rr with e in {0, 1} and bits * 2^-24, both exact.
//
// What bounds it on an H100: per token the kernel reads one bf16 snapshot
// row (k_pad * 2 bytes, gathered by word id; this replaces the XLA gather at
// ops/gibbs.py:605) and one int32 doc row; the snapshot mostly stays in the
// 50 MB L2 under Zipf word statistics.  The arithmetic is ~2 transcendentals
// per (token, topic) on the SFUs.  Both are far below what launches cost:
// tiles must run in order (a tile's draws read the doc counts the previous
// tile wrote), so a sweep is 2 launches per tile of row_tile tokens, and at
// the main path's shape the launch count, not bytes or operations, bounds
// the sweep.  The design keeps each launch cheap (one warp per token,
// coalesced 8-byte loads of the row, a warp argmax; integer atomics for the
// update) and issues the whole walk from one host call.  A persistent kernel
// or a CUDA graph that removes the per-tile launches is later work.
//
// Noise modes: 0 deterministic (no noise), 1 external (caller uniforms
// [n, k_pad]), 2 internal (Philox4x32-10 keyed by a per-sweep seed, counter
// (token slot, topic group of 4); 24-bit uniforms as at pallas_gibbs.py:161).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUpdateThreads = 256;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// pl.reciprocal(x, approx=True) as the reference computes it on the CPU
__device__ __forceinline__ float approx_recip(float x) {
  return 1.0f / bf16_round(x);
}

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

__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return static_cast<float>(bits & 0xFFFFFFu) * 5.9604644775390625e-8f +
         2.98023223876953125e-8f;
}

// One warp per token; lane l covers topic groups l, l + 32, ... of 4 topics.
template <int kMode>
__global__ void gibbs_tile_sample(
    const __nv_bfloat16* __restrict__ mirror, int k_pad,
    const int* __restrict__ ndk, int k_real, const int* __restrict__ nk,
    const int* __restrict__ z_old, int* __restrict__ z_new,
    const int* __restrict__ word, const int* __restrict__ doc,
    const int* __restrict__ mask, const float* __restrict__ uniforms,
    long long t0, int n, float alpha, float beta, float vbeta, uint32_t key0,
    uint32_t key1, long long slot0) {
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n) return;  // whole warp
  const long long i = t0 + w;
  const int zo = z_old[i];
  if (mask[i] == 0) {  // whole warp
    if (lane == 0) z_new[i] = zo;
    return;
  }
  const __nv_bfloat16* wrow = mirror + static_cast<long long>(word[i]) * k_pad;
  const int* drow = ndk + static_cast<long long>(doc[i]) * k_real;
  const unsigned long long slot = static_cast<unsigned long long>(slot0 + i);

  float best = -INFINITY;
  int best_k = k_pad;
  for (int g = lane; g < (k_pad >> 2); g += 32) {
    float inv_e[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (kMode == 2) {
      const uint4 b = philox4x32_10(
          make_uint4(static_cast<uint32_t>(slot),
                     static_cast<uint32_t>(slot >> 32),
                     static_cast<uint32_t>(g), 0u),
          key0, key1);
      inv_e[0] = approx_recip(-logf(bits_to_uniform(b.x)));
      inv_e[1] = approx_recip(-logf(bits_to_uniform(b.y)));
      inv_e[2] = approx_recip(-logf(bits_to_uniform(b.z)));
      inv_e[3] = approx_recip(-logf(bits_to_uniform(b.w)));
    } else if (kMode == 1) {
      const float* urow = uniforms + i * k_pad + 4 * g;
#pragma unroll
      for (int j = 0; j < 4; ++j) inv_e[j] = approx_recip(-logf(urow[j]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * g + j;
      float s = -1.0f;
      if (k < k_real) {
        const float e = (k == zo) ? 1.0f : 0.0f;
        const float r = approx_recip(static_cast<float>(nk[k]) + vbeta);
        const float rr = r * r;
        const float p =
            ((__bfloat162float(wrow[k]) - e + beta) *
             (static_cast<float>(drow[k]) - e + alpha)) *
            (r + e * rr);
        s = (kMode == 0) ? p : p * inv_e[j];
      }
      if (s > best) {  // strict: the lane keeps its first maximum
        best = s;
        best_k = k;
      }
    }
  }
  // warp argmax; ties go to the lower topic, as jnp.argmax does
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int ok = __shfl_down_sync(0xffffffffu, best_k, off);
    if (ov > best || (ov == best && ok < best_k)) {
      best = ov;
      best_k = ok;
    }
  }
  if (lane == 0) z_new[i] = best_k;
}

// One thread per token: move the token's count from z_old to z_new.
__global__ void gibbs_tile_update(int* __restrict__ ndk, int k_real,
                                  int* __restrict__ nk,
                                  const int* __restrict__ z_old,
                                  const int* __restrict__ z_new,
                                  const int* __restrict__ doc,
                                  const int* __restrict__ mask, long long t0,
                                  int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long long i = t0 + j;
  const int zo = z_old[i];
  const int zn = z_new[i];
  if (mask[i] == 0 || zo == zn) return;
  int* drow = ndk + static_cast<long long>(doc[i]) * k_real;
  atomicSub(drow + zo, 1);
  atomicAdd(drow + zn, 1);
  atomicSub(nk + zo, 1);
  atomicAdd(nk + zn, 1);
}

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Walk the tiles of [0, n_tokens) in order.  phases: 1 = sample only,
// 2 = update only, 3 = both per tile (the sweep).  Returns cudaGetLastError.
extern "C" int lda_gibbs_tiles(
    const void* mirror, int k_pad, void* ndk, int k_real, void* nk,
    const void* z_old, void* z_new, const void* word, const void* doc,
    const void* mask, const void* uniforms, long long n_tokens, int row_tile,
    float alpha, float beta, float vbeta, int noise_mode,
    unsigned long long seed, long long slot0, int phases, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise_mode < 0 || noise_mode > 2 || row_tile <= 0 || (k_pad & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t key0 = static_cast<uint32_t>(seed);
  const uint32_t key1 = static_cast<uint32_t>(seed >> 32);
  const auto* mir = static_cast<const __nv_bfloat16*>(mirror);
  auto* ndk_i = static_cast<int*>(ndk);
  auto* nk_i = static_cast<int*>(nk);
  const auto* zo = static_cast<const int*>(z_old);
  auto* zn = static_cast<int*>(z_new);
  const auto* wd = static_cast<const int*>(word);
  const auto* dc = static_cast<const int*>(doc);
  const auto* mk = static_cast<const int*>(mask);
  const auto* un = static_cast<const float*>(uniforms);
  for (long long t0 = 0; t0 < n_tokens; t0 += row_tile) {
    const int n = static_cast<int>(
        n_tokens - t0 < row_tile ? n_tokens - t0 : row_tile);
    if (phases & 1) {
      const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
      const dim3 block(32 * kWarpsPerBlock);
      if (noise_mode == 0) {
        gibbs_tile_sample<0><<<grid, block, 0, s>>>(
            mir, k_pad, ndk_i, k_real, nk_i, zo, zn, wd, dc, mk, un, t0, n,
            alpha, beta, vbeta, key0, key1, slot0);
      } else if (noise_mode == 1) {
        gibbs_tile_sample<1><<<grid, block, 0, s>>>(
            mir, k_pad, ndk_i, k_real, nk_i, zo, zn, wd, dc, mk, un, t0, n,
            alpha, beta, vbeta, key0, key1, slot0);
      } else {
        gibbs_tile_sample<2><<<grid, block, 0, s>>>(
            mir, k_pad, ndk_i, k_real, nk_i, zo, zn, wd, dc, mk, un, t0, n,
            alpha, beta, vbeta, key0, key1, slot0);
      }
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (phases & 2) {
      gibbs_tile_update<<<(n + kUpdateThreads - 1) / kUpdateThreads,
                          kUpdateThreads, 0, s>>>(ndk_i, k_real, nk_i, zo, zn,
                                                  dc, mk, t0, n);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
