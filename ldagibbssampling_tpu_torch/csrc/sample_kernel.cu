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
// What bounds it on an H100: operations.  Per (token, topic) the draw needs
// the two logf of the Gumbel noise, in internal mode a quarter of a
// Philox4x32-10 and a uniform, and the score and the argmax; the rows of
// frequent words and of the block's few documents stay in the 50 MB L2.  The
// conditional's three logf are not part of that work, and the design takes
// them out of the per-element loop (no --use_fast_math: every logf below is
// the accurate libdevice one, so the bits are those of the formula above):
//
// - log tables in shared memory, built by each CTA from alpha, beta, V*beta
//   and nk as the launch finds them on the device (a Minka update between
//   sweeps reaches the next launch; nothing is kept across launches):
//     L_nk[e][k] = logf((float)nk[k] - e + V*beta), e in {0, 1}: the nk term
//       takes 2K values in a launch, as nk is the block-start total;
//     L_beta[j + 1] = logf((float)j + beta), L_alpha[j + 1] = logf((float)j +
//       alpha) for j in [-1, kLogTable - 1): for a count c below 2^24,
//       (float)c - e is exactly (float)(c - e), so logf((float)c - e + beta)
//       is L_beta[c - e + 1] to the bit.  A count whose c - e + 1 falls
//       outside the table (a hot word's cell) computes that logf instead.
//       j = -1 gives logf(c - 1) (NaN below 1): a masked token's empty cell
//       takes the NaN path it always did;
// - a persistent grid: as many CTAs as the occupancy query fits at once
//   (one of 1,024 threads per SM), each walking tokens with a warp per
//   token, so the tables' prologue (2 * kLogTable + 2K logf) is paid once
//   per SM rather than once per 8 tokens.  A CTA's warps take neighbouring
//   tokens (the sweep's blocks are word-sorted, so they share nwk rows in
//   L1), and each warp loads its next token's ids while it draws this one;
// - vector loads: lane l reads topic groups l, l + 32, ... of 4, each row's
//   4 counts as one int4 (and the 4 L_nk[0] entries as one float4) where
//   K % 4 == 0 and the tables are 16-byte aligned, 4 scalar loads otherwise;
// - one warp vote per step: where every count of the warp's 32 groups lies
//   in the tables (__all_sync), the lookups take no bound check; otherwise
//   each count checks, and one past the tables takes its logf.
// Where K is too large for L_nk in shared memory (K over ~27,000), the nk
// term is the logf of the formula, per element.  What remains per element
// besides the noise (the two logf and Philox, ~half the time at K = 500)
// is integer work, the exclusion, the indices and the argmax's compares and
// selects, which Hopper issues at half the float32 rate.

// Noise modes: 0 deterministic, 1 external (caller uniforms [n, K]), 2
// internal (Philox4x32-10 keyed by a per-sweep seed, counter (token slot,
// topic group of 4), philox.cuh).
//
// alpha, beta, V*beta and the seed are device values, read through
// pointers when the kernel starts (thread 0 of each CTA reads them into
// shared memory before the tables are built): a CUDA graph of a sweep
// keeps the pointers, and the values written there before each replay
// reach the draw (the host forms them as float32, as the reference forms
// its f32 hyperparameters; the arithmetic on them is unchanged).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

// one CTA of 1,024 threads per SM (measured on the H100 against 512 x 2,
// 512 x 3 and 256 x 4-6: the fewest table prologues, and the most warps)
constexpr int kSampleThreads = 1024;
constexpr int kSampleWarps = kSampleThreads / 32;
// CTAs per SM that the registers must allow (__launch_bounds__)
constexpr int kSampleMinBlocks = 1;
// entries of L_beta and L_alpha: counts c - e from -1 to kLogTable - 2
constexpr int kLogTable = 2048;
// the most shared memory a CTA of the H100 can take (227 KB)
constexpr size_t kMaxSmem = 232448;

struct SampleArgs {
  const int* nwk;
  const int* ndk;
  const int* nk;
  int k_real;
  int k4;  // k_real rounded up to 4: the row length of L_nk
  const int* z_old;
  int* z_new;
  const int* word;
  const int* doc;
  const float* uniforms;
  int n;
  const float* scalars;  // alpha, beta, V*beta (device)
  const unsigned long long* key;  // the Philox key (device; internal mode)
  long long slot0;
  bool nk_table;  // L_nk in shared memory
  bool vec;       // int4 row loads (K % 4 == 0, 16-byte aligned tables)
  bool vec_noise;  // float4 uniform loads (external mode)
};

// the launch's hyperparameters and key, read from the device at the start
struct Hyper {
  float alpha, beta, vbeta;
  uint32_t key0, key1;
};

// is (s, k) ahead of (best, best_k) in jnp.argmax's order: NaN first, then
// the larger value, then the lower topic
__device__ __forceinline__ bool ahead(float s, int k, float best, int best_k) {
  const bool sn = isnan(s), bn = isnan(best);
  if (sn != bn) return sn;
  if (!sn && s != best) return s > best;
  return k < best_k;
}

// logf((float)c - e + shift), from the table where c - e lies in it
__device__ __forceinline__ float log_count(const float* tab, int c, int e,
                                           float shift) {
  const unsigned idx = static_cast<unsigned>(c) - static_cast<unsigned>(e) + 1u;
  if (idx < static_cast<unsigned>(kLogTable)) return tab[idx];
  return logf(static_cast<float>(c) - static_cast<float>(e) + shift);
}

// entries k0..k0+3 of a row (0 past k_real)
__device__ __forceinline__ int4 load4(const int* row, int k0, int k_real,
                                      bool vec) {
  if (vec) return __ldg(reinterpret_cast<const int4*>(row + k0));
  int4 r;
  r.x = __ldg(row + k0);
  r.y = k0 + 1 < k_real ? __ldg(row + k0 + 1) : 0;
  r.z = k0 + 2 < k_real ? __ldg(row + k0 + 2) : 0;
  r.w = k0 + 3 < k_real ? __ldg(row + k0 + 3) : 0;
  return r;
}

__device__ __forceinline__ float4 load4f(const float* row, int k0, int k_real,
                                         bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + k0));
  float4 r;
  r.x = __ldg(row + k0);
  r.y = k0 + 1 < k_real ? __ldg(row + k0 + 1) : 0.5f;
  r.z = k0 + 2 < k_real ? __ldg(row + k0 + 2) : 0.5f;
  r.w = k0 + 3 < k_real ? __ldg(row + k0 + 3) : 0.5f;
  return r;
}

// one topic group of a token: its scores, each taken by the lane's argmax
// or not, in increasing topic order.  kTable: every count's log is in the
// tables (the warp checked); otherwise a count past them takes logf.
template <int kMode, bool kTable>
__device__ __forceinline__ void score_group(
    const SampleArgs& a, const Hyper& h, const float* s_beta,
    const float* s_alpha, const float* s_nk, long long i, unsigned long long slot, int zo, int g,
    const int (&cw)[4], const int (&cd)[4], float& best, int& best_k) {
  const int k0 = 4 * g;
  const int k_real = a.k_real;
  float lnk[4];
  if (a.nk_table) {
    const float4 l = *reinterpret_cast<const float4*>(s_nk + k0);
    lnk[0] = l.x;
    lnk[1] = l.y;
    lnk[2] = l.z;
    lnk[3] = l.w;
  }
  float u[4] = {0.5f, 0.5f, 0.5f, 0.5f};
  if (kMode == 2) {
    const uint4 b = lda::philox_group(slot, g, h.key0, h.key1);
    u[0] = lda::bits_to_uniform(b.x);
    u[1] = lda::bits_to_uniform(b.y);
    u[2] = lda::bits_to_uniform(b.z);
    u[3] = lda::bits_to_uniform(b.w);
  } else if (kMode == 1) {
    const float4 v = load4f(a.uniforms + i * k_real, k0, k_real, a.vec_noise);
    u[0] = v.x;
    u[1] = v.y;
    u[2] = v.z;
    u[3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + j;
    if (k >= k_real) break;
    const int e = k == zo ? 1 : 0;
    float nk_term;
    if (a.nk_table) {
      nk_term = e ? s_nk[a.k4 + k] : lnk[j];
    } else {
      nk_term = logf(static_cast<float>(__ldg(a.nk + k)) -
                     static_cast<float>(e) + h.vbeta);
    }
    float lw, ld;
    if (kTable) {
      lw = s_beta[cw[j] - e + 1];
      ld = s_alpha[cd[j] - e + 1];
    } else {
      lw = log_count(s_beta, cw[j], e, h.beta);
      ld = log_count(s_alpha, cd[j], e, h.alpha);
    }
    float s = (lw + ld) - nk_term;
    if (kMode != 0) s = s + (-logf(-logf(u[j])));
    if (ahead(s, k, best, best_k)) {
      best = s;
      best_k = k;
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kSampleThreads, kSampleMinBlocks)
    gibbs_block_sample(const SampleArgs a) {
  // L_beta [kLogTable], L_alpha [kLogTable], then L_nk [2][k4] if it fits
  extern __shared__ float4 s_tab4[];
  float* s_beta = reinterpret_cast<float*>(s_tab4);
  float* s_alpha = s_beta + kLogTable;
  float* s_nk = s_alpha + kLogTable;
  // the launch's values, read once per CTA into shared memory
  __shared__ Hyper s_h;
  if (threadIdx.x == 0) {
    s_h.alpha = __ldg(a.scalars);
    s_h.beta = __ldg(a.scalars + 1);
    s_h.vbeta = __ldg(a.scalars + 2);
    s_h.key0 = s_h.key1 = 0;
    if (kMode == 2) {
      const unsigned long long key = __ldg(a.key);
      s_h.key0 = static_cast<uint32_t>(key);
      s_h.key1 = static_cast<uint32_t>(key >> 32);
    }
  }
  __syncthreads();
  const Hyper& h = s_h;
  for (int t = threadIdx.x; t < kLogTable; t += blockDim.x) {
    const float j = static_cast<float>(t - 1);
    s_beta[t] = logf(j + h.beta);
    s_alpha[t] = logf(j + h.alpha);
  }
  if (a.nk_table) {
    for (int k = threadIdx.x; k < a.k4; k += blockDim.x) {
      const float c = k < a.k_real ? static_cast<float>(__ldg(a.nk + k)) : 0.0f;
      s_nk[k] = logf(c - 0.0f + h.vbeta);
      s_nk[a.k4 + k] = logf(c - 1.0f + h.vbeta);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int k_real = a.k_real;
  const int groups = (k_real + 3) / 4;
  const long long step = static_cast<long long>(gridDim.x) * kSampleWarps;
  long long i = static_cast<long long>(blockIdx.x) * kSampleWarps +
                (threadIdx.x >> 5);
  // the token's ids, loaded a token ahead
  int zo = 0, w = 0, d = 0;
  if (i < a.n) {
    zo = __ldg(a.z_old + i);
    w = __ldg(a.word + i);
    d = __ldg(a.doc + i);
  }
  for (; i < a.n; i += step) {  // warp-uniform
    const int* wrow = a.nwk + static_cast<long long>(w) * k_real;
    const int* drow = a.ndk + static_cast<long long>(d) * k_real;
    const int z_tok = zo;
    if (i + step < a.n) {
      zo = __ldg(a.z_old + i + step);
      w = __ldg(a.word + i + step);
      d = __ldg(a.doc + i + step);
    }
    const unsigned long long slot =
        static_cast<unsigned long long>(a.slot0 + i);
    float best = -INFINITY;
    int best_k = k_real;
    // every lane takes the same number of steps (the votes need the warp)
    for (int g0 = 0; g0 < groups; g0 += 32) {
      const int g = g0 + lane;
      const bool valid = g < groups;
      int4 w4 = make_int4(0, 0, 0, 0), d4 = make_int4(0, 0, 0, 0);
      if (valid) {
        w4 = load4(wrow, 4 * g, k_real, a.vec);
        d4 = load4(drow, 4 * g, k_real, a.vec);
      }
      const int cw[4] = {w4.x, w4.y, w4.z, w4.w};
      const int cd[4] = {d4.x, d4.y, d4.z, d4.w};
      // c - e + 1 inside the tables for each of the group's counts?
      bool inside = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned e = 4 * g + j == z_tok ? 1u : 0u;
        inside = inside &&
                 static_cast<unsigned>(cw[j]) - e + 1u < static_cast<unsigned>(kLogTable) &&
                 static_cast<unsigned>(cd[j]) - e + 1u < static_cast<unsigned>(kLogTable);
      }
      const bool all_inside = __all_sync(0xffffffffu, inside || !valid);
      if (valid) {
        if (all_inside) {
          score_group<kMode, true>(a, h, s_beta, s_alpha, s_nk, i, slot,
                                   z_tok, g, cw, cd, best, best_k);
        } else {
          score_group<kMode, false>(a, h, s_beta, s_alpha, s_nk, i, slot,
                                    z_tok, g, cw, cd, best, best_k);
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
    if (lane == 0) a.z_new[i] = best_k;
  }
}

using SampleKernel = void (*)(SampleArgs);

SampleKernel sample_kernel(int noise_mode) {
  if (noise_mode == 0) return gibbs_block_sample<0>;
  if (noise_mode == 1) return gibbs_block_sample<1>;
  return gibbs_block_sample<2>;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch of a draw of n tokens at k_real topics: its CTAs (as many as
// fit on the card at once, and no more than the tokens' warps), dynamic
// shared memory, and whether L_nk is in it.
cudaError_t sample_config(SampleKernel kernel, int k_real, int n, int* grid,
                          size_t* smem, bool* nk_table) {
  const int k4 = (k_real + 3) & ~3;
  *smem = static_cast<size_t>(2 * kLogTable) * sizeof(float);
  *nk_table = *smem + static_cast<size_t>(2 * k4) * sizeof(float) <= kMaxSmem;
  if (*nk_table) *smem += static_cast<size_t>(2 * k4) * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && *smem > 48 * 1024)
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), kSampleThreads, *smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long warps = (static_cast<long long>(n) + kSampleWarps - 1) /
                          kSampleWarps;
  *grid = static_cast<int>(warps < static_cast<long long>(per_sm) * sms
                               ? warps
                               : static_cast<long long>(per_sm) * sms);
  return cudaSuccess;
}

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch lda_block_sample takes for n_tokens at k_real topics on the
// current device: *grid CTAs of *threads, *smem bytes of dynamic shared
// memory (allowed to the kernel here), *nk_table 1 where L_nk is in it.
// The caller keeps it: it costs device queries that a launch should not.
extern "C" int lda_block_sample_config(int noise_mode, int k_real,
                                       long long n_tokens, int* grid,
                                       int* threads, int* smem, int* nk_table) {
  if (noise_mode < 0 || noise_mode > 2 || k_real <= 0 || n_tokens <= 0 ||
      n_tokens >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  bool table = false;
  const cudaError_t err =
      sample_config(sample_kernel(noise_mode), k_real,
                    static_cast<int>(n_tokens), grid, &bytes, &table);
  *threads = kSampleThreads;
  *smem = static_cast<int>(bytes);
  *nk_table = table ? 1 : 0;
  return static_cast<int>(err);
}

// Draw every token of [0, n_tokens) against the given counts in one launch
// of grid CTAs with smem bytes of tables (nk_table 1: L_nk among them), as
// lda_block_sample_config gave them on this device for this noise_mode,
// k_real and n_tokens (it also lets the kernel take that much shared
// memory); scalars points to float32 alpha, beta, V*beta and key to the
// uint64 Philox key (internal mode only), both on the device and read when
// the kernel starts; returns the launch's CUDA error.
extern "C" int lda_block_sample(const void* nwk, const void* ndk,
                                const void* nk, int k_real, const void* z_old,
                                void* z_new, const void* word, const void* doc,
                                const void* uniforms, long long n_tokens,
                                const void* scalars, const void* key,
                                int noise_mode, long long slot0, int grid,
                                int smem, int nk_table, void* stream) {
  if (noise_mode < 0 || noise_mode > 2 || k_real <= 0 ||
      n_tokens >= (1LL << 31) || scalars == nullptr ||
      (noise_mode == 2 && key == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tokens <= 0) return static_cast<int>(cudaGetLastError());
  if (grid <= 0 || smem <= 0) return static_cast<int>(cudaErrorInvalidValue);
  SampleArgs a;
  a.nk_table = nk_table != 0;
  a.nwk = static_cast<const int*>(nwk);
  a.ndk = static_cast<const int*>(ndk);
  a.nk = static_cast<const int*>(nk);
  a.k_real = k_real;
  a.k4 = (k_real + 3) & ~3;
  a.z_old = static_cast<const int*>(z_old);
  a.z_new = static_cast<int*>(z_new);
  a.word = static_cast<const int*>(word);
  a.doc = static_cast<const int*>(doc);
  a.uniforms = static_cast<const float*>(uniforms);
  a.n = static_cast<int>(n_tokens);
  a.scalars = static_cast<const float*>(scalars);
  a.key = static_cast<const unsigned long long*>(key);
  a.slot0 = slot0;
  a.vec = k_real % 4 == 0 && aligned16(nwk) && aligned16(ndk);
  a.vec_noise = k_real % 4 == 0 && aligned16(uniforms);
  sample_kernel(noise_mode)<<<grid, kSampleThreads, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
