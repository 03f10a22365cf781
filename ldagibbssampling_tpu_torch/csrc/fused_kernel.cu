// K1 of the deferred and fused collapsed-Gibbs sweeps: per-tile draw + count
// update, and the count move that applies a block's word-topic moves.
//
// Replaces ldagibbssampling_tpu/ops/pallas_gibbs.py::_fused_kernel (lines
// 58-192), in both of its modes:
//
// - deferred (emit_delta=False): rows are the sweep-stale snapshot
//   [v_pad, k_pad] of nwk, bf16 or float32 (row stride k_pad), and the
//   draw runs in one of three chains (compute_dtype, below);
// - fused (emit_delta=True): rows are the live int32 table nwk [V, K] (row
//   stride K) as it stood at the start of the block.  The dense [B, Kp]
//   delta of the reference never leaves the card: its only consumer is the
//   word-topic scatter (ops/gibbs.py:394), and lda_count_move applies the
//   same integer moves sparsely after the block's last tile.
//
// For each token of a tile:
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
// Chains (pallas_gibbs.py:88-89, :140-177): kF32 runs the lines above in
// float32.  kBf16 and kBf16p cast e, the two count rows, alpha and beta to
// bf16, take r = bf16(r), rr = bf16(r * r) from the float32 r, and round
// every op of p to bf16; kBf16 also rounds 1/E to bf16 and the score to bf16
// (score = bf16(p * bf16(1/E))), kBf16p scores p * (1/E) in float32.  Each
// bf16 op is a float32 op (__fadd_rn and friends: no contraction) followed
// by a round to nearest even, which is what the reference computes with
// excess precision off and what PyTorch's bf16 ops compute.  Where both
// operands are bf16 values that is also what one native bf16 op computes:
// float32's 24-bit significand is at least 2*8+2 bits for bf16's 8
// (Figueroa's double-rounding condition), and the K4 probe's packed
// __hadd2/__hmul2 chain matches the float32-then-round chain bitwise on the
// card.  Only rr = bf16(r * r) takes the float32 r, as the reference does.
// An FMA would drop a rounding.  Ties are common in bf16: the first index
// wins, as below.
//
// What bounds it on an H100: per token the kernel reads one row of nwk
// (gathered by word id: k_pad * 2 or k_pad * 4 bytes of the bf16 or float32
// snapshot, or K * 4 bytes of the live table; this replaces the XLA gathers
// at ops/gibbs.py:385 and
// :605) and one int32 doc row; under Zipf word statistics the rows mostly
// stay in the 50 MB L2.  The arithmetic is ~2 transcendentals per (token,
// topic) on the SFUs.  Both are far below what launches cost: tiles must run
// in order (a tile's draws read the doc counts the previous tile wrote), so
// a sweep is 2 launches per tile of row_tile tokens (plus one count move per
// block in the fused tier), and at the main path's shape the launch count,
// not bytes or operations, bounds the sweep.  The design keeps each launch
// cheap (one warp per token, a warp argmax; integer atomics for the update)
// and issues a block's walk from one host call.  A persistent kernel or a
// CUDA graph that removes the per-tile launches is later work.
//
// Noise modes: 0 deterministic (no noise), 1 external (caller uniforms
// [n, k_pad]), 2 internal (Philox4x32-10 keyed by a per-sweep seed, counter
// (token slot, topic group of 4); 24-bit uniforms, philox.cuh).
// alpha, beta and V*beta arrive as launch arguments, so a hyperparameter
// update between sweeps reaches the next launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUpdateThreads = 256;
// the draw's chains, in the order of ops/fused_kernel.CHAINS
constexpr int kF32 = 0;
constexpr int kBf16 = 1;
constexpr int kBf16p = 2;
// row kinds of lda_gibbs_tiles, in the order of ops/fused_kernel._ROWS_KIND
constexpr int kRowsBf16 = 0;
constexpr int kRowsInt32 = 1;
constexpr int kRowsF32 = 2;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// pl.reciprocal(x, approx=True) as the reference computes it on the CPU
__device__ __forceinline__ float approx_recip(float x) {
  return 1.0f / bf16_round(x);
}

__device__ __forceinline__ float count_value(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// int32 counts below 2^24 convert exactly (guarded in ops/gibbs.make_sweep_fn)
__device__ __forceinline__ float count_value(int x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float count_value(float x) { return x; }

// p of one (token, topic) in a bf16 chain, every op rounded to bf16
__device__ __forceinline__ float bf16_chain_p(float w, float d, float e,
                                              float r32, float alpha_c,
                                              float beta_c) {
  const float r = bf16_round(r32);
  const float rr = bf16_round(__fmul_rn(r32, r32));
  const float a = bf16_round(__fadd_rn(bf16_round(__fsub_rn(bf16_round(w), e)),
                                       beta_c));
  const float b = bf16_round(__fadd_rn(bf16_round(__fsub_rn(bf16_round(d), e)),
                                       alpha_c));
  const float c = bf16_round(__fadd_rn(r, __fmul_rn(e, rr)));
  return bf16_round(__fmul_rn(bf16_round(__fmul_rn(a, b)), c));
}

// One warp per token; lane l covers topic groups l, l + 32, ... of 4 topics.
template <int kMode, int kChain, typename RowT>
__global__ void gibbs_tile_sample(
    const RowT* __restrict__ rows, long long row_stride, int k_pad,
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
  const RowT* wrow = rows + static_cast<long long>(word[i]) * row_stride;
  const int* drow = ndk + static_cast<long long>(doc[i]) * k_real;
  const unsigned long long slot = static_cast<unsigned long long>(slot0 + i);
  const float alpha_c = kChain == kF32 ? alpha : bf16_round(alpha);
  const float beta_c = kChain == kF32 ? beta : bf16_round(beta);

  float best = -INFINITY;
  int best_k = k_pad;
  for (int g = lane; g < (k_pad >> 2); g += 32) {
    float inv_e[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (kMode == 2) {
      const uint4 b = lda::philox_group(slot, g, key0, key1);
      inv_e[0] = approx_recip(-logf(lda::bits_to_uniform(b.x)));
      inv_e[1] = approx_recip(-logf(lda::bits_to_uniform(b.y)));
      inv_e[2] = approx_recip(-logf(lda::bits_to_uniform(b.z)));
      inv_e[3] = approx_recip(-logf(lda::bits_to_uniform(b.w)));
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
        if (kChain == kF32) {
          const float rr = r * r;
          const float p = ((count_value(wrow[k]) - e + beta) *
                           (static_cast<float>(drow[k]) - e + alpha)) *
                          (r + e * rr);
          s = (kMode == 0) ? p : p * inv_e[j];
        } else {
          const float p =
              bf16_chain_p(count_value(wrow[k]), static_cast<float>(drow[k]),
                           e, r, alpha_c, beta_c);
          if (kMode == 0)
            s = p;
          else if (kChain == kBf16)
            s = bf16_round(__fmul_rn(p, bf16_round(inv_e[j])));
          else
            s = __fmul_rn(p, inv_e[j]);
        }
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

// One thread per token: move an unmasked token's count from z_old to z_new
// in each table that is given (null pointers are skipped).
__global__ void gibbs_tile_update(int* __restrict__ nwk, int* __restrict__ ndk,
                                  int* __restrict__ nk, int k_real,
                                  const int* __restrict__ word,
                                  const int* __restrict__ doc,
                                  const int* __restrict__ mask,
                                  const int* __restrict__ z_old,
                                  const int* __restrict__ z_new, long long t0,
                                  long long n) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= n) return;
  const long long i = t0 + j;
  const int zo = z_old[i];
  const int zn = z_new[i];
  if (mask[i] == 0 || zo == zn) return;
  if (nwk != nullptr) {
    int* wrow = nwk + static_cast<long long>(word[i]) * k_real;
    atomicSub(wrow + zo, 1);
    atomicAdd(wrow + zn, 1);
  }
  if (ndk != nullptr) {
    int* drow = ndk + static_cast<long long>(doc[i]) * k_real;
    atomicSub(drow + zo, 1);
    atomicAdd(drow + zn, 1);
  }
  if (nk != nullptr) {
    atomicSub(nk + zo, 1);
    atomicAdd(nk + zn, 1);
  }
}

template <int kChain, typename RowT>
cudaError_t launch_sample(int noise_mode, dim3 grid, dim3 block,
                          cudaStream_t s, const RowT* rows,
                          long long row_stride, int k_pad, const int* ndk,
                          int k_real, const int* nk, const int* zo, int* zn,
                          const int* wd, const int* dc, const int* mk,
                          const float* un, long long t0, int n, float alpha,
                          float beta, float vbeta, uint32_t key0,
                          uint32_t key1, long long slot0) {
  if (noise_mode == 0) {
    gibbs_tile_sample<0, kChain, RowT><<<grid, block, 0, s>>>(
        rows, row_stride, k_pad, ndk, k_real, nk, zo, zn, wd, dc, mk, un, t0,
        n, alpha, beta, vbeta, key0, key1, slot0);
  } else if (noise_mode == 1) {
    gibbs_tile_sample<1, kChain, RowT><<<grid, block, 0, s>>>(
        rows, row_stride, k_pad, ndk, k_real, nk, zo, zn, wd, dc, mk, un, t0,
        n, alpha, beta, vbeta, key0, key1, slot0);
  } else {
    gibbs_tile_sample<2, kChain, RowT><<<grid, block, 0, s>>>(
        rows, row_stride, k_pad, ndk, k_real, nk, zo, zn, wd, dc, mk, un, t0,
        n, alpha, beta, vbeta, key0, key1, slot0);
  }
  return cudaGetLastError();
}

#define LDA_SAMPLE_ARGS                                                    \
  noise_mode, grid, block, s, static_cast<const RowT*>(rows), row_stride, \
      k_pad, ndk, k_real, nk, zo, zn, wd, dc, mk, un, t0, n, alpha, beta, \
      vbeta, key0, key1, slot0

// the chain's instantiation for rows of type RowT
template <typename RowT>
cudaError_t launch_chain(int chain, int noise_mode, dim3 grid, dim3 block,
                         cudaStream_t s, const void* rows,
                         long long row_stride, int k_pad, const int* ndk,
                         int k_real, const int* nk, const int* zo, int* zn,
                         const int* wd, const int* dc, const int* mk,
                         const float* un, long long t0, int n, float alpha,
                         float beta, float vbeta, uint32_t key0,
                         uint32_t key1, long long slot0) {
  if (chain == kBf16) return launch_sample<kBf16, RowT>(LDA_SAMPLE_ARGS);
  if (chain == kBf16p) return launch_sample<kBf16p, RowT>(LDA_SAMPLE_ARGS);
  return launch_sample<kF32, RowT>(LDA_SAMPLE_ARGS);
}

#undef LDA_SAMPLE_ARGS

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Walk the tiles of [0, n_tokens) in order.  rows_kind: 0 = bf16 snapshot,
// 1 = live int32 table (float32 chain only), 2 = float32 snapshot.  chain:
// 0 = float32, 1 = bfloat16, 2 = bf16p.  phases: 1 = sample only, 2 =
// update only, 3 = both per tile (the sweep).  Returns cudaGetLastError.
extern "C" int lda_gibbs_tiles(
    const void* rows, int rows_kind, long long row_stride, int k_pad,
    void* ndk, int k_real, void* nk, const void* z_old, void* z_new,
    const void* word, const void* doc, const void* mask, const void* uniforms,
    long long n_tokens, int row_tile, float alpha, float beta, float vbeta,
    int noise_mode, int chain, unsigned long long seed, long long slot0,
    int phases, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise_mode < 0 || noise_mode > 2 || row_tile <= 0 ||
      ((phases & 1) &&
       ((k_pad & 3) || k_real > k_pad ||
        (rows_kind != kRowsBf16 && rows_kind != kRowsInt32 &&
         rows_kind != kRowsF32) ||
        chain < kF32 || chain > kBf16p ||
        (rows_kind == kRowsInt32 && chain != kF32))))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t key0 = static_cast<uint32_t>(seed);
  const uint32_t key1 = static_cast<uint32_t>(seed >> 32);
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
      cudaError_t err;
      if (rows_kind == kRowsInt32)
        err = launch_sample<kF32, int>(
            noise_mode, grid, block, s, static_cast<const int*>(rows),
            row_stride, k_pad, ndk_i, k_real, nk_i, zo, zn, wd, dc, mk, un,
            t0, n, alpha, beta, vbeta, key0, key1, slot0);
      else if (rows_kind == kRowsF32)
        err = launch_chain<float>(chain, noise_mode, grid, block, s, rows,
                                  row_stride, k_pad, ndk_i, k_real, nk_i, zo,
                                  zn, wd, dc, mk, un, t0, n, alpha, beta,
                                  vbeta, key0, key1, slot0);
      else
        err = launch_chain<__nv_bfloat16>(
            chain, noise_mode, grid, block, s, rows, row_stride, k_pad, ndk_i,
            k_real, nk_i, zo, zn, wd, dc, mk, un, t0, n, alpha, beta, vbeta,
            key0, key1, slot0);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (phases & 2) {
      gibbs_tile_update<<<(n + kUpdateThreads - 1) / kUpdateThreads,
                          kUpdateThreads, 0, s>>>(nullptr, ndk_i, nk_i,
                                                  k_real, wd, dc, mk, zo, zn,
                                                  t0, n);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch: move every unmasked token of [0, n_tokens) from z_old to z_new
// in each of nwk (by word), ndk (by doc) and nk that is not null.
extern "C" int lda_count_move(void* nwk, void* ndk, void* nk, int k_real,
                              const void* word, const void* doc,
                              const void* mask, const void* z_old,
                              const void* z_new, long long n_tokens,
                              void* stream) {
  if (n_tokens <= 0) return static_cast<int>(cudaGetLastError());
  const long long grid = (n_tokens + kUpdateThreads - 1) / kUpdateThreads;
  gibbs_tile_update<<<static_cast<unsigned int>(grid), kUpdateThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(nwk), static_cast<int*>(ndk), static_cast<int*>(nk),
      k_real, static_cast<const int*>(word), static_cast<const int*>(doc),
      static_cast<const int*>(mask), static_cast<const int*>(z_old),
      static_cast<const int*>(z_new), 0, n_tokens);
  return static_cast<int>(cudaGetLastError());
}
