// K1 of the deferred and fused collapsed-Gibbs sweeps: one persistent,
// cooperatively launched walk that draws each tile and moves its counts, tile
// after tile, on the whole card; and the count move that applies a block's
// word-topic moves.
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
//   same integer moves sparsely after the block's walk.
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
// (score = bf16(p * bf16(1/E))), kBf16p scores p * (1/E) in float32.  p runs
// on packed bf16x2 pairs of topics (__hsub2_rn, __hadd2_rn, __hmul2_rn: one
// rounding per op, no FMA), which gives the bits of the reference's float32
// op followed by a round to bf16 (what it computes with excess precision off
// and what PyTorch's bf16 ops compute): every operand is a bf16 value, and
// float32's 24-bit significand is at least 2*8+2 bits for bf16's 8
// (Figueroa's double-rounding condition; the K4 probe's packed chain matches
// the float32-then-round chain bitwise on the card).  Only rr = bf16(r * r)
// takes the float32 r, as the reference does.  Ties are common in bf16: the
// first index wins, as below.
//
// The walk (gibbs_walk).  Tiles must run in order: a tile's draws read the
// doc counts and nk that the previous tile left.  The TPU's sequential grid
// becomes a loop over tiles inside one cooperative launch of as many CTAs as
// fit on the card at once (one per SM at the walk's registers).  A tile is
// spread over the whole card: each token goes to a team of `team` threads
// (a power of two from 32 to a CTA, chosen per launch so that the grid holds
// a tile's tokens) inside one CTA, each thread scanning topic groups of 4 in
// increasing order with a strict >, so a token's argmax is a warp shuffle and
// one step through shared memory, and ties keep the lowest topic however the
// groups are spread.  A group's 4 row entries, doc counts and uniforms are
// one load each where the row stride and alignment allow it (the snapshots
// always; the live table and ndk, stride K, when K % 4 == 0).  Two forms,
// the same chain to the bit:
//
// - walk_general, any shape: each CTA computes the tile's nk reciprocal of
//   each real topic once, into shared memory; every draw of the tile reads
//   the counts; grid barrier; the tile's unmasked tokens move their ndk and
//   nk counts with integer atomics; grid barrier; the next tile.  The grid
//   barrier is a sense-reversing arrival counter in an int32 that the caller
//   zeroes (cooperative_groups' grid barrier, written out so that no -rdc
//   build is needed): after a __syncthreads one thread per CTA arrives with
//   a release add, and waits with acquire loads before the next
//   __syncthreads;
// - walk_pipelined, where every tile is one pass (a team per token of a
//   tile, at most a topic group per thread: the deferred and fused tiers'
//   tiles at every K up to k_pad 2,048 on a grid of 132 SMs) and the caller
//   gives the second ndk buffer (ops/fused_kernel.py takes it where the
//   launch's tiles repay its copy): no grid barrier.  Each leader writes its
//   token's move as a tagged record, each CTA releases once a tile its count
//   of finished tiles, and the next tile waits on those counts and records
//   themselves.
//
// walk_pipelined's records and counts.  The caller zeroes, at every launch
// (a memset node of a graph that holds the walk), a ring a.moves of two
// tiles of 64-bit records and after it one uint32 per CTA.  A record holds
// the token's zo (bits 0-10) and zn (11-21; k_pad <= 2,048), a tag (22-31)
// and its doc (32-63); a masked token's record moves nothing (zo == zn).
// Tile t's tag is t % 1023 + 1: never 0, so a zeroed slot never passes, and
// never tile t - 2's, whose record the slot held before; a replay starts
// from a zeroed ring, so nothing of an earlier one passes either.  Leaders
// write records with relaxed stores; after a __syncthreads thread 0
// releases its CTA's count, t + 1 after tile t.  One release a CTA a tile:
// a release fence stalls its warp, and a release per leader stalls every
// warp that holds a team (on an H100 it cost more than the grid barrier it
// replaced).  At tile t, thread i of each busy CTA polls CTA i's count with
// acquire loads until it reaches t, while each thread polls its share of
// tile t - 1's records (ceil(tile / kWalkThreads), at most kFoldBatch) with
// relaxed loads and folds each into the CTA's shared nk as soon as it
// carries tile t - 1's tag: a record carries all of its move, so the fold
// needs no acquire and runs while the counts settle.  No arrival counter is
// shared by the CTAs: each count has one writer.  A wait of more than ~2^26
// polls (tens of seconds) traps: the launch fails with an error instead of
// hanging.  The cooperative launch keeps every CTA resident, so a count's
// writer always runs.
//
// Why readers and writers of ndk never meet.  ndk is double-buffered: X0 =
// ndk, X1 its copy at the start.  Tile t's draws read X[t % 2], loaded after
// the wait, which holds the counts after tile t - 1; each leader adds its
// moves of tiles t - 1 and t to X[(t + 1) % 2] after its argmax.  That buffer
// was last read for tile t - 1's draws, which every CTA finished before it
// released t, and it is next read for tile t + 1's, after the wait on the
// counts of t + 1, which cover the adds.  So each tile draws against exactly
// the counts the previous tile left, as walk_general does.  Where X1 was
// written last, each leader adds its last move to X0 once every count has
// reached the last tile.  nk lives in each CTA's shared memory, which folds
// every tile's moves; CTA 0 folds the last tile's records and writes it
// back.  A ring slot is rewritten at tile t + 2, after the wait on the
// counts of t + 2, whose releasers had read the slot before.  A thread
// prefetches its next token's doc counts into L2 a tile ahead (the moves
// land in L2, so the load after the wait finds the line there).
//
// ndk, nk, z_new and the move records change during the launch, so they
// are read through L2 (__ldcg, the acquire loads), never through the
// non-coherent read-only path, which could return a previous tile's values.
// The rows (only read during a walk), the tokens and the noise take __ldg.
//
// What bounds it on an H100: the chain of dependent tiles.  A tile of 512
// tokens at K = 500 is ~0.2 us of operations for the whole card; what a
// tile of walk_pipelined costs is the chain from the argmax through thread
// 0's release and the readers' polls to their doc counts' load and their
// draws, and the work of each CTA's tile (the noise, the fold of 2,048
// moves into nk, the score and the argmax), none of which more parallelism
// hides.  Per token the walk
// reads one row of nwk (k_pad * 2 or * 4 bytes of a snapshot, K * 4 of the
// live table; under Zipf word statistics mostly from the 50 MB L2) and one
// int32 doc row.
//
// Noise modes: 0 deterministic (no noise), 1 external (caller uniforms
// [n, k_pad]), 2 internal (Philox4x32-10 keyed by a per-sweep seed, counter
// (token slot, topic group of 4); 24-bit uniforms, philox.cuh).
// alpha, beta, V*beta and the internal mode's Philox key are device values
// (scalars: float32 alpha, beta, V*beta, as ops/_device.sweep_scalars lays
// them out; key: the seed's 64 bits): thread 0 of each CTA reads them into
// shared memory before the first tile, and every thread then keeps them in
// registers.  A CUDA graph of a sweep (ops/graphs.py) replays the launch with
// the values its buffers hold then, so a hyperparameter update and each
// sweep's seed reach the next replay.
//
// The count move (gibbs_tile_update, launched by lda_count_move): -1 at
// z_old and +1 at z_new of every unmasked token that moved, in each of nwk
// (by word), ndk (by doc) and nk that is given, with integer atomics (exact
// in any order).  What bounds it on an H100 is not bytes (a block's token
// arrays and the cells it changes are well under a megabyte) but atomics:
// every moved token adds to nk, whose K totals share a few L2 lines, and
// same-line atomics queue.  So where nk is moved, each CTA sums its tokens'
// nk moves in a shared histogram of K ints; a cluster of CTAs adds its
// histograms into its first CTA's over distributed shared memory, and that
// CTA flushes one global atomic per non-zero topic.  nwk and ndk cells take
// one atomic per moved token and sign, as without nk (one thread per token).
// Optionally the move also writes z_out[i] = mask ? z_new : z_old, the
// sweep's new assignments, which may be z_old itself (each thread reads its
// token's z_old before it writes z_out).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "philox.cuh"

namespace {

constexpr int kWalkThreads = 512;
constexpr int kWalkWarps = kWalkThreads / 32;
// walk_pipelined: the most records of a tile a thread waits on and folds (a
// tile has at most kFoldBatch * kWalkThreads tokens)
constexpr int kFoldBatch = 4;
// a move record (64 bits): zo in bits 0-10 and zn in 11-21 (k_pad <= 2,048),
// the tile's tag in 22-31, the doc in 32-63; tile t's tag is t % 1023 + 1,
// never 0 (the zeroed ring) and never tile t - 2's (the same ring slot)
constexpr int kTopicBits = 11;
constexpr unsigned int kTopicMask = (1u << kTopicBits) - 1;
constexpr int kTagShift = 2 * kTopicBits;
constexpr unsigned int kTagWrap = (1u << 10) - 1;
// the count move: one thread per token in CTAs of kMoveThreads; nk goes
// through the shared histograms of clusters of kMoveCluster CTAs up to
// kMaxHistTopics topics (48 KB), straight to global atomics above
constexpr int kMoveThreads = 256;
constexpr int kMoveCluster = 2;
constexpr int kMaxHistTopics = 12288;
// the draw's chains, in the order of ops/fused_kernel.CHAINS
constexpr int kF32 = 0;
constexpr int kBf16 = 1;
constexpr int kBf16p = 2;
// row kinds of lda_gibbs_tiles, in the order of ops/fused_kernel._ROWS_KIND
constexpr int kRowsBf16 = 0;
constexpr int kRowsInt32 = 1;
constexpr int kRowsF32 = 2;

struct WalkArgs {
  const void* rows;
  long long row_stride;
  int k_pad;
  int* ndk;
  int* ndk_copy;     // a copy of ndk: walk_pipelined's second buffer (null
                     // in walk_general)
  int k_real;
  int* nk;
  const int* z_old;
  int* z_new;
  const int* word;
  const int* doc;
  const int* mask;
  const float* uniforms;
  long long n_tokens;
  int row_tile;
  const float* scalars;           // alpha, beta, V*beta (device)
  const unsigned long long* key;  // the Philox key (device; internal mode)
  long long slot0;
  int phases;        // 1 draw only, 3 draw and count move per tile
  int team;          // threads per token: a power of two, 32 .. kWalkThreads
  bool vec_rows;     // a group's 4 row entries in one load
  bool vec_ndk;      // a group's 4 doc counts in one load
  bool vec_noise;    // a group's 4 uniforms in one load
  bool pipelined;    // walk_pipelined: a sweep whose tiles are one pass each
  unsigned int* barrier;         // walk_general's grid barrier (else null)
  unsigned long long* moves;     // walk_pipelined's ring [2][row_tile] of
                                 // tagged move records (else null)
};

// the launch's hyperparameters and key, read from the device at the start
struct Hyper {
  float alpha, beta, vbeta;
  uint32_t key0, key1;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// pl.reciprocal(x, approx=True) as the reference computes it on the CPU
__device__ __forceinline__ float approx_recip(float x) {
  return __frcp_rn(bf16_round(x));  // 1.0f / x, correctly rounded
}

__device__ __forceinline__ float bf16_bits(uint32_t hi16) {
  return __uint_as_float(hi16 & 0xFFFF0000u);
}

// The row entries of topics 4g .. 4g+3 as float32 (0 past k_real where the
// row ends there).  Snapshot rows have k_pad columns; the live table K.
__device__ __forceinline__ void load_row4(const __nv_bfloat16* row, int g,
                                          int k_real, bool vec, float w[4]) {
  if (vec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row) + g);
    w[0] = bf16_bits(v.x << 16);
    w[1] = bf16_bits(v.x);
    w[2] = bf16_bits(v.y << 16);
    w[3] = bf16_bits(v.y);
    return;
  }
  const auto* bits = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * g + j;
    w[j] = k < k_real ? bf16_bits(static_cast<uint32_t>(__ldg(bits + k)) << 16)
                      : 0.0f;
  }
}

__device__ __forceinline__ void load_row4(const float* row, int g, int k_real,
                                          bool vec, float w[4]) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row) + g);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * g + j;
    w[j] = k < k_real ? __ldg(row + k) : 0.0f;
  }
}

// int32 counts below 2^24 convert exactly (guarded in ops/gibbs.make_sweep_fn)
__device__ __forceinline__ void load_row4(const int* row, int g, int k_real,
                                          bool vec, float w[4]) {
  if (vec) {  // K % 4 == 0: a group lies wholly inside the row or past it
    const int4 v = 4 * g < k_real ? __ldg(reinterpret_cast<const int4*>(row) + g)
                                  : make_int4(0, 0, 0, 0);
    w[0] = static_cast<float>(v.x);
    w[1] = static_cast<float>(v.y);
    w[2] = static_cast<float>(v.z);
    w[3] = static_cast<float>(v.w);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * g + j;
    w[j] = k < k_real ? static_cast<float>(__ldg(row + k)) : 0.0f;
  }
}

// doc counts of topics 4g .. 4g+3 (0 past k_real): they change during the
// walk, so through L2
__device__ __forceinline__ void load_ndk4(const int* row, int g, int k_real,
                                          bool vec, int d[4]) {
  if (vec) {
    const int4 v = 4 * g < k_real ? __ldcg(reinterpret_cast<const int4*>(row) + g)
                                  : make_int4(0, 0, 0, 0);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * g + j;
    d[j] = k < k_real ? __ldcg(row + k) : 0;
  }
}

// p of topics (k, k + 1) in a bf16 chain: one native bf16 op per op
__device__ __forceinline__ float2 bf16_chain_p2(float w0, float w1, float d0,
                                                float d1, float e0, float e1,
                                                float r0, float r1,
                                                __nv_bfloat162 alpha2,
                                                __nv_bfloat162 beta2) {
  const __nv_bfloat162 e = __floats2bfloat162_rn(e0, e1);
  const __nv_bfloat162 r = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 rr =
      __floats2bfloat162_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1));
  const __nv_bfloat162 a =
      __hadd2_rn(__hsub2_rn(__floats2bfloat162_rn(w0, w1), e), beta2);
  const __nv_bfloat162 b =
      __hadd2_rn(__hsub2_rn(__floats2bfloat162_rn(d0, d1), e), alpha2);
  const __nv_bfloat162 c = __hadd2_rn(r, __hmul2_rn(e, rr));
  return __bfloat1622float2(__hmul2_rn(__hmul2_rn(a, b), c));
}

// 1 / bf16(E) of topics 4g .. 4g+3 of token i (1 in deterministic mode):
// the noise half of a draw, which no count move changes
template <int kMode>
__device__ __forceinline__ void noise4(const WalkArgs& a, const Hyper& h,
                                       long long i, int g, float inv_e[4]) {
  if (kMode == 2) {
    const uint4 b = lda::philox_group(
        static_cast<unsigned long long>(a.slot0 + i), g, h.key0, h.key1);
    inv_e[0] = approx_recip(-logf(lda::bits_to_uniform(b.x)));
    inv_e[1] = approx_recip(-logf(lda::bits_to_uniform(b.y)));
    inv_e[2] = approx_recip(-logf(lda::bits_to_uniform(b.z)));
    inv_e[3] = approx_recip(-logf(lda::bits_to_uniform(b.w)));
  } else if (kMode == 1) {
    const float* urow = a.uniforms + i * a.k_pad;
    float u[4];
    if (a.vec_noise) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(urow) + g);
      u[0] = v.x;
      u[1] = v.y;
      u[2] = v.z;
      u[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = __ldg(urow + 4 * g + j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) inv_e[j] = approx_recip(-logf(u[j]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) inv_e[j] = 1.0f;
  }
}

// Score topics 4g .. 4g+3 of a token (row entries w, doc counts d, the
// tile's nk reciprocals r4, noise inv_e, old topic zo) and fold them into
// (best, best_k): strict >, so a thread keeps the first maximum of the
// groups it scans in increasing order.
template <int kMode, int kChain>
__device__ __forceinline__ void score4(const WalkArgs& a, const Hyper& h,
                                       const float w[4], const float d[4],
                                       float4 r4, const float inv_e[4], int zo,
                                       int g, float& best, int& best_k) {
  const float r[4] = {r4.x, r4.y, r4.z, r4.w};
  float e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = (4 * g + j == zo) ? 1.0f : 0.0f;
  float s[4];
  if (kChain == kF32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float rr = r[j] * r[j];
      const float p = ((w[j] - e[j] + h.beta) * (d[j] - e[j] + h.alpha)) *
                      (r[j] + e[j] * rr);
      s[j] = (kMode == 0) ? p : p * inv_e[j];
    }
  } else {
    const __nv_bfloat162 alpha2 = __float2bfloat162_rn(h.alpha);
    const __nv_bfloat162 beta2 = __float2bfloat162_rn(h.beta);
#pragma unroll
    for (int h = 0; h < 4; h += 2) {
      const float2 p = bf16_chain_p2(w[h], w[h + 1], d[h], d[h + 1], e[h],
                                     e[h + 1], r[h], r[h + 1], alpha2, beta2);
      const float pj[2] = {p.x, p.y};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = h + q;
        if (kMode == 0)
          s[j] = pj[q];
        else if (kChain == kBf16)
          s[j] = bf16_round(__fmul_rn(pj[q], bf16_round(inv_e[j])));
        else
          s[j] = __fmul_rn(pj[q], inv_e[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * g + j;
    const float sj = k < a.k_real ? s[j] : -1.0f;
    if (sj > best) {
      best = sj;
      best_k = k;
    }
  }
}

// The argmax of a team of `team` threads (a multiple of 32): a warp shuffle,
// then the team's warps through shared memory; ties go to the lower topic,
// as jnp.argmax does.  Every thread of the CTA calls it; the result is valid
// in the team's first thread.  The caller separates two calls with a
// __syncthreads.
__device__ __forceinline__ void team_argmax(float& best, int& best_k, int team,
                                            float* s_best, int* s_k) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int ok = __shfl_down_sync(0xffffffffu, best_k, off);
    if (ov > best || (ov == best && ok < best_k)) {
      best = ov;
      best_k = ok;
    }
  }
  if ((tid & 31) == 0) {
    s_best[tid >> 5] = best;
    s_k[tid >> 5] = best_k;
  }
  __syncthreads();
  if ((tid & (team - 1)) == 0) {
    for (int w = (tid >> 5) + 1; w < (tid >> 5) + team / 32; ++w) {
      const float ov = s_best[w];
      const int ok = s_k[w];
      if (ov > best || (ov == best && ok < best_k)) {
        best = ov;
        best_k = ok;
      }
    }
  }
}

// A token's move (a leader keeps its own for the tiles after): -1 at
// (doc, zo), +1 at (doc, zn) in ndk
struct Move {
  int doc;
  int zo;
  int zn;
  bool real;
};

__device__ __forceinline__ void move_doc(int* ndk, int k_real, const Move& m) {
  if (!m.real || m.zo == m.zn) return;
  int* drow = ndk + static_cast<long long>(m.doc) * k_real;
  atomicSub(drow + m.zo, 1);
  atomicAdd(drow + m.zn, 1);
}

// the same, and in nk
__device__ __forceinline__ void move_counts(const WalkArgs& a, int doc, int zo,
                                            int zn) {
  if (zo == zn) return;
  move_doc(a.ndk, a.k_real, {doc, zo, zn, true});
  atomicSub(a.nk + zo, 1);
  atomicAdd(a.nk + zn, 1);
}

// The grid barrier, split: grid_arrive, then work that reads nothing another
// CTA writes before its arrival, then grid_wait.  CTA 0 adds 2^31 - (n - 1)
// and the others 1, so the counter's top bit flips once all n CTAs have
// arrived and its low bits return to 0 (the walk's counter starts at 0);
// `sense` is the top bit each barrier ends at.  The arrival is a release
// (after a __syncthreads: it publishes the CTA's writes), the poll an
// acquire (before a __syncthreads: the CTA then sees every CTA's writes).
// A wait of more than ~2^26 polls (tens of seconds) traps: the launch fails
// with an error instead of hanging.
__device__ __forceinline__ void grid_arrive(unsigned int* bar,
                                            unsigned int& sense) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                 :
                 : "l"(bar), "r"(add)
                 : "memory");
  }
  sense ^= 0x80000000u;
}

__device__ __forceinline__ void grid_wait(const unsigned int* bar,
                                          unsigned int sense) {
  if (threadIdx.x == 0) {
    unsigned int polls = 0, v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
      if (++polls > (1u << 26)) __trap();
    } while ((v & 0x80000000u) != sense);
  }
  __syncthreads();
}

// The tile's nk reciprocals, once per CTA (nk through L2: it moves during
// the walk)
__device__ __forceinline__ void hoist_recip(const WalkArgs& a, const Hyper& h,
                                            float* s_r) {
  for (int k = threadIdx.x; k < a.k_pad; k += kWalkThreads)
    s_r[k] = k < a.k_real
                 ? approx_recip(static_cast<float>(__ldcg(a.nk + k)) + h.vbeta)
                 : 0.0f;
}

// A team's token in a tile (live: the tile has one for the team; real: and
// it is not masked), as read from the walk's inputs
struct Token {
  long long i;
  int zo;
  int doc;
  int word;
  bool live;
  bool real;
};

__device__ __forceinline__ Token fetch_token(const WalkArgs& a, long long t0,
                                             long long team) {
  Token tk;
  tk.i = t0 + team;
  tk.live = t0 < a.n_tokens && team < a.row_tile && tk.i < a.n_tokens;
  tk.zo = tk.live ? __ldg(a.z_old + tk.i) : 0;
  tk.doc = tk.live ? __ldg(a.doc + tk.i) : 0;
  tk.word = tk.live ? __ldg(a.word + tk.i) : 0;
  tk.real = tk.live && __ldg(a.mask + tk.i) != 0;
  return tk;
}

// A record of walk_pipelined's ring: the token's doc, its old and new topic
// (equal where it kept its topic or is masked: no move) and its tile's tag
__device__ __forceinline__ unsigned long long pack_move(int doc, int zo, int zn,
                                                        unsigned int tag) {
  return (static_cast<unsigned long long>(static_cast<unsigned int>(doc)) << 32) |
         (tag << kTagShift) | (static_cast<unsigned int>(zn) << kTopicBits) |
         static_cast<unsigned int>(zo);
}

__device__ __forceinline__ unsigned int record_tag(unsigned long long r) {
  return static_cast<unsigned int>(r >> kTagShift) & kTagWrap;
}

__device__ __forceinline__ unsigned int next_tag(unsigned int tag) {
  return tag == kTagWrap ? 1u : tag + 1u;
}

__device__ __forceinline__ unsigned int prev_tag(unsigned int tag) {
  return tag == 1u ? kTagWrap : tag - 1u;
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :
               : "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned int* p, unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :
               : "l"(p), "r"(v)
               : "memory");
}

// walk_pipelined's shared memory
struct WalkShared {
  int* nk;   // [k_pad] topic totals, as the previous tile left them
  float* r;  // [k_pad] the tile's nk reciprocals
};

// A thread's records of a tile of n: tid, tid + kWalkThreads, ... (0 past
// n: no move)
__device__ __forceinline__ void load_records(const unsigned long long* rec,
                                             int n,
                                             unsigned long long r[kFoldBatch]) {
#pragma unroll
  for (int j = 0; j < kFoldBatch; ++j) {
    const int m = threadIdx.x + j * kWalkThreads;
    r[j] = m < n ? load_relaxed(rec + m) : 0ull;
  }
}

// Wait for a tile: thread i < busy polls CTA i's count of finished tiles
// with acquire loads until it reaches `tiles`, and every thread polls its
// records with relaxed loads, all of its polls of a round in flight at once,
// folding each record into the CTA's topic totals s_nk as soon as it carries
// `tag` (a record carries all of its move itself).  What CTA i did before
// its release is then seen by this CTA after its next __syncthreads.  More
// than ~2^26 rounds (tens of seconds) trap: the launch fails with an error
// instead of hanging.
__device__ __forceinline__ void wait_tile(const unsigned int* done, int busy,
                                          unsigned int tiles,
                                          const unsigned long long* rec, int n,
                                          unsigned long long r[kFoldBatch],
                                          unsigned int tag, int* s_nk) {
  const int tid = threadIdx.x;
  bool counted = tid >= busy;
  unsigned int pending = 0;  // bit j: record j not folded yet
#pragma unroll
  for (int j = 0; j < kFoldBatch; ++j)
    if (tid + j * kWalkThreads < n) pending |= 1u << j;
  unsigned int polls = 0;
  for (;;) {
#pragma unroll
    for (int j = 0; j < kFoldBatch; ++j) {
      if (!(pending >> j & 1u)) continue;
      if (record_tag(r[j]) == tag) {
        const int zo = static_cast<int>(r[j] & kTopicMask);
        const int zn = static_cast<int>((r[j] >> kTopicBits) & kTopicMask);
        if (zo != zn) {
          atomicSub(s_nk + zo, 1);
          atomicAdd(s_nk + zn, 1);
        }
        pending &= ~(1u << j);
      } else {
        r[j] = load_relaxed(rec + tid + j * kWalkThreads);
      }
    }
    if (!counted) counted = load_acquire(done + tid) >= tiles;
    if (pending == 0u && counted) return;
    if (++polls > (1u << 26)) __trap();
  }
}

// Thread i < busy waits, with acquire loads, until CTA i's count of
// finished tiles reaches `tiles` (what CTA i did before its release is then
// seen by this CTA after its next __syncthreads).  The same trap.
__device__ __forceinline__ void wait_counts(const unsigned int* done, int busy,
                                            unsigned int tiles) {
  if (static_cast<int>(threadIdx.x) >= busy) return;
  unsigned int polls = 0;
  while (load_acquire(done + threadIdx.x) < tiles)
    if (++polls > (1u << 26)) __trap();
}

// The walk where every tile is one pass (a team per token, a topic group per
// thread at most, a tile of at most kFoldBatch * kWalkThreads tokens; the
// launch sets a.pipelined), with no grid barrier.  ndk is double-buffered,
// X0 = a.ndk and X1 = a.ndk_copy (a copy of it at the start): tile t's
// draws read X[t % 2], which holds the counts after tile t - 1.  Per tile t,
// each CTA with a token in some tile (the busy CTAs):
// 1. loads the token of tile t + 2 and its share of tile t - 1's move
//    records; thread i < busy waits until CTA i has finished tile t - 1
//    (its count of finished tiles, released once a tile) while each thread
//    polls its records until each carries tile t - 1's tag; __syncthreads;
// 2. each thread loads its token's doc counts from X[t % 2] and, while they
//    come, folds its records into the CTA's shared nk; __syncthreads; the
//    nk reciprocals of its share of the topics; __syncthreads;
// 3. it draws its token; after the argmax each leader writes its token's
//    record (doc, zo, zn, tile t's tag) into the ring slot a.moves[t % 2]
//    and z_new, and adds its moves of tiles t - 1 and t to X[(t + 1) % 2];
//    __syncthreads; thread 0 releases the CTA's count of finished tiles,
//    t + 1, while every thread loads the next token's row entries and
//    computes its noise.
// Why the chain is walk_general's: the head of this file.  CTAs whose teams
// have no token in any tile leave at once.  Where X1 was the last buffer
// written, each leader adds its last move to X0 once every busy CTA has
// finished the last tile; CTA 0 waits for that too, folds the last tile's
// records and writes nk back.
template <int kMode, int kChain, typename RowT>
__device__ __forceinline__ void walk_pipelined(const WalkArgs& a, const Hyper& h,
                                               const WalkShared& s,
                                               float* s_best, int* s_k) {
  const int tid = threadIdx.x;
  const int per_cta = kWalkThreads / a.team;
  const long long teamed = (a.row_tile + per_cta - 1) / per_cta;
  const int busy = teamed < gridDim.x ? static_cast<int>(teamed)
                                      : static_cast<int>(gridDim.x);
  if (static_cast<int>(blockIdx.x) >= busy) return;
  const int slot = tid / a.team;
  const int tl = tid & (a.team - 1);
  const long long team = static_cast<long long>(blockIdx.x) * per_cta + slot;
  const bool mine_group = 4 * tl < a.k_pad;
  const RowT* rows = static_cast<const RowT*>(a.rows);
  unsigned int* done = reinterpret_cast<unsigned int*>(a.moves + 2 * a.row_tile);
  for (int k = tid; k < a.k_pad; k += kWalkThreads)
    s.nk[k] = k < a.k_real ? __ldcg(a.nk + k) : 0;
  // tile 0's token, its row entries and noise; tile 1's token
  Token cur = fetch_token(a, 0, team);
  Token nxt = fetch_token(a, a.row_tile, team);
  float w[4], inv_e[4];
  if (mine_group && cur.real) {
    load_row4(rows + static_cast<long long>(cur.word) * a.row_stride, tl,
              a.k_real, a.vec_rows, w);
    noise4<kMode>(a, h, cur.i, tl, inv_e);
  }
  Move prev = {0, 0, 0, false};  // this leader's move of tile t - 1
  unsigned int tag = 1;          // tile t's: t % 1023 + 1
  long long t = 0;
  for (long long t0 = 0; t0 < a.n_tokens; t0 += a.row_tile, ++t) {
    const Token nxt2 = fetch_token(a, t0 + 2 * a.row_tile, team);
    if (t > 0) {
      const unsigned long long* rec = a.moves + ((t - 1) & 1) * a.row_tile;
      unsigned long long r[kFoldBatch];
      load_records(rec, a.row_tile, r);
      wait_tile(done, busy, static_cast<unsigned int>(t), rec, a.row_tile, r,
                prev_tag(tag), s.nk);
    }
    __syncthreads();  // every busy CTA has finished tile t - 1
    int dc[4] = {0, 0, 0, 0};
    if (mine_group && cur.real)
      load_ndk4((t & 1 ? a.ndk_copy : a.ndk) +
                    static_cast<long long>(cur.doc) * a.k_real,
                tl, a.k_real, a.vec_ndk, dc);
    for (int k = tid; k < a.k_pad; k += kWalkThreads)
      s.r[k] = k < a.k_real ? approx_recip(static_cast<float>(s.nk[k]) + h.vbeta)
                            : 0.0f;
    __syncthreads();
    float best = -INFINITY;
    int best_k = a.k_pad;
    if (mine_group && cur.real) {
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = static_cast<float>(dc[j]);
      score4<kMode, kChain>(a, h, w, d, reinterpret_cast<const float4*>(s.r)[tl],
                            inv_e, cur.zo, tl, best, best_k);
    }
    team_argmax(best, best_k, a.team, s_best, s_k);
    const int zn = cur.real ? best_k : cur.zo;
    if (tl == 0) {
      const Move mv = {cur.doc, cur.zo, zn, cur.real};
      if (cur.live) {  // a masked token's record moves nothing
        store_relaxed(a.moves + (t & 1) * a.row_tile + team,
                      cur.real ? pack_move(cur.doc, cur.zo, zn, tag)
                               : pack_move(0, 0, 0, tag));
        a.z_new[cur.i] = zn;
      }
      int* const out = t & 1 ? a.ndk : a.ndk_copy;
      move_doc(out, a.k_real, prev);
      move_doc(out, a.k_real, mv);
      prev = mv;
    }
    __syncthreads();  // the CTA's records and moves of tile t are out
    if (tid == 0) store_release(done + blockIdx.x, static_cast<unsigned int>(t + 1));
    cur = nxt;
    nxt = nxt2;
    if (mine_group && cur.real) {  // the next tile's row entries and noise
      load_row4(rows + static_cast<long long>(cur.word) * a.row_stride, tl,
                a.k_real, a.vec_rows, w);
      // its doc counts into L2 (read after the next wait; moves land in L2)
      asm volatile("prefetch.global.L2 [%0];"
                   :
                   : "l"((t & 1 ? a.ndk : a.ndk_copy) +
                         static_cast<long long>(cur.doc) * a.k_real + 4 * tl));
      noise4<kMode>(a, h, cur.i, tl, inv_e);
    }
    tag = next_tag(tag);
  }
  // every busy CTA has finished the last tile: an odd number of tiles wrote
  // X1 last, and X0, read by the last tile, lacks its moves
  wait_counts(done, busy, static_cast<unsigned int>(t));
  __syncthreads();
  if (tl == 0 && (t & 1)) move_doc(a.ndk, a.k_real, prev);
  if (blockIdx.x == 0) {  // the last tile's moves into nk, then nk back
    const long long t_last = t - 1;
    const int n = static_cast<int>(a.n_tokens - t_last * a.row_tile);
    const unsigned long long* rec = a.moves + (t_last & 1) * a.row_tile;
    unsigned long long r[kFoldBatch];
    load_records(rec, n, r);
    wait_tile(done, busy, static_cast<unsigned int>(t), rec, n, r, prev_tag(tag),
              s.nk);
    __syncthreads();
    for (int k = tid; k < a.k_real; k += kWalkThreads) a.nk[k] = s.nk[k];
  }
}

// The walk at any shape: a team loops over the tokens of a tile it has
// (tile_tokens > teams) and a thread over its topic groups (groups > team).
template <int kMode, int kChain, typename RowT>
__device__ __forceinline__ void walk_general(const WalkArgs& a, const Hyper& h,
                                             float4* s_r4, float* s_best,
                                             int* s_k) {
  const int tid = threadIdx.x;
  const int per_cta = kWalkThreads / a.team;
  const long long teams = static_cast<long long>(gridDim.x) * per_cta;
  const long long team = static_cast<long long>(blockIdx.x) * per_cta + tid / a.team;
  const int tl = tid & (a.team - 1);
  const int ng = a.k_pad >> 2;
  const bool move = a.phases == 3;
  const RowT* rows = static_cast<const RowT*>(a.rows);
  unsigned int sense = 0;
  for (long long t0 = 0; t0 < a.n_tokens; t0 += a.row_tile) {
    const long long n =
        a.n_tokens - t0 < a.row_tile ? a.n_tokens - t0 : a.row_tile;
    if (t0 == 0 || move) {
      hoist_recip(a, h, reinterpret_cast<float*>(s_r4));
      __syncthreads();
    }
    for (long long j0 = 0; j0 < n; j0 += teams) {  // the same trip count in a CTA
      const long long j = j0 + team;
      const long long i = t0 + j;
      float best = -INFINITY;
      int best_k = a.k_pad;
      int zo = 0;
      bool real = false;
      if (j < n) {
        zo = __ldg(a.z_old + i);
        real = __ldg(a.mask + i) != 0;
        if (real) {
          const RowT* wrow =
              rows + static_cast<long long>(__ldg(a.word + i)) * a.row_stride;
          const int* drow =
              a.ndk + static_cast<long long>(__ldg(a.doc + i)) * a.k_real;
          for (int g = tl; g < ng; g += a.team) {
            float inv_e[4], w[4], d[4];
            int dc[4];
            noise4<kMode>(a, h, i, g, inv_e);
            load_row4(wrow, g, a.k_real, a.vec_rows, w);
            load_ndk4(drow, g, a.k_real, a.vec_ndk, dc);
#pragma unroll
            for (int j = 0; j < 4; ++j) d[j] = static_cast<float>(dc[j]);
            score4<kMode, kChain>(a, h, w, d, s_r4[g], inv_e, zo, g, best,
                                  best_k);
          }
        }
      }
      team_argmax(best, best_k, a.team, s_best, s_k);
      if (tl == 0 && j < n) a.z_new[i] = real ? best_k : zo;
      __syncthreads();
    }
    if (move) {
      grid_arrive(a.barrier, sense);  // every draw of the tile has read the counts
      grid_wait(a.barrier, sense);
      for (long long j0 = 0; j0 < n; j0 += teams) {
        const long long i = t0 + j0 + team;
        // the leader moves the token it drew (its own z_new store)
        if (tl == 0 && j0 + team < n && __ldg(a.mask + i) != 0)
          move_counts(a, __ldg(a.doc + i), __ldg(a.z_old + i), a.z_new[i]);
      }
      grid_arrive(a.barrier, sense);  // every move is in before the next draws
      grid_wait(a.barrier, sense);
    }
  }
}

template <int kMode, int kChain, typename RowT>
__global__ void __launch_bounds__(kWalkThreads, 1) gibbs_walk(const WalkArgs a) {
  // walk_general: [k_pad / 4] float4, the tile's nk reciprocals;
  // walk_pipelined: its WalkShared
  extern __shared__ float4 s_dyn[];
  __shared__ float s_best[kWalkWarps];
  __shared__ int s_k[kWalkWarps];
  // the launch's values, read once per CTA, then held in registers
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
  const Hyper h = s_h;
  if (a.pipelined) {
    WalkShared s;
    s.nk = reinterpret_cast<int*>(s_dyn + a.k_pad / 4);
    s.r = reinterpret_cast<float*>(s_dyn);
    walk_pipelined<kMode, kChain, RowT>(a, h, s, s_best, s_k);
  } else {
    walk_general<kMode, kChain, RowT>(a, h, s_dyn, s_best, s_k);
  }
}

struct MoveArgs {
  int* nwk;  // each table may be null: it is then not moved
  int* ndk;
  int* nk;
  int k_real;
  const int* word;
  const int* doc;
  const int* mask;
  const int* z_old;  // may be z_out itself
  const int* z_new;
  int* z_out;        // null: no write-back
  long long n;
  bool hist;         // nk through the shared histograms
};

// The count move of token blockIdx.x * kMoveThreads + threadIdx.x.  Every
// thread of a CTA reaches the cluster barriers (no early exit).
__global__ void __launch_bounds__(kMoveThreads) gibbs_tile_update(
    const MoveArgs a) {
  extern __shared__ int s_hist[];  // [k_real] where a.hist
  if (a.hist) {
    for (int k = threadIdx.x; k < a.k_real; k += blockDim.x) s_hist[k] = 0;
    // every histogram of the cluster is zeroed before any CTA adds to it
    cooperative_groups::this_cluster().sync();
  }
  const long long i =
      static_cast<long long>(blockIdx.x) * kMoveThreads + threadIdx.x;
  if (i < a.n) {
    // every id with the token's assignments, none behind the move test
    const int zo = a.z_old[i];
    const int zn = a.z_new[i];
    const int m = a.mask[i];
    const int w = a.nwk != nullptr ? __ldg(a.word + i) : 0;
    const int d = a.ndk != nullptr ? __ldg(a.doc + i) : 0;
    if (a.z_out != nullptr) a.z_out[i] = m != 0 ? zn : zo;
    if (m != 0 && zo != zn) {
      if (a.nwk != nullptr) {
        int* wrow = a.nwk + static_cast<long long>(w) * a.k_real;
        atomicSub(wrow + zo, 1);
        atomicAdd(wrow + zn, 1);
      }
      if (a.ndk != nullptr) {
        int* drow = a.ndk + static_cast<long long>(d) * a.k_real;
        atomicSub(drow + zo, 1);
        atomicAdd(drow + zn, 1);
      }
      if (a.nk != nullptr) {
        int* t = a.hist ? s_hist : a.nk;
        atomicSub(t + zo, 1);
        atomicAdd(t + zn, 1);
      }
    }
  }
  if (a.hist) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    __syncthreads();
    if (cl.block_rank() != 0) {
      int* root = cl.map_shared_rank(s_hist, 0);
      for (int k = threadIdx.x; k < a.k_real; k += blockDim.x) {
        const int v = s_hist[k];
        if (v != 0) atomicAdd(root + k, v);
      }
    }
    cl.sync();
    if (cl.block_rank() == 0) {
      for (int k = threadIdx.x; k < a.k_real; k += blockDim.x) {
        const int v = s_hist[k];
        if (v != 0) atomicAdd(a.nk + k, v);
      }
    }
  }
}

using WalkKernel = void (*)(WalkArgs);

template <int kChain, typename RowT>
WalkKernel walk_for_mode(int noise_mode) {
  if (noise_mode == 0) return gibbs_walk<0, kChain, RowT>;
  if (noise_mode == 1) return gibbs_walk<1, kChain, RowT>;
  return gibbs_walk<2, kChain, RowT>;
}

template <typename RowT>
WalkKernel walk_for_chain(int chain, int noise_mode) {
  if (chain == kBf16) return walk_for_mode<kBf16, RowT>(noise_mode);
  if (chain == kBf16p) return walk_for_mode<kBf16p, RowT>(noise_mode);
  return walk_for_mode<kF32, RowT>(noise_mode);
}

// the instantiation of a walk
WalkKernel walk_kernel(int rows_kind, int chain, int noise_mode) {
  if (rows_kind == kRowsInt32) return walk_for_mode<kF32, int>(noise_mode);
  if (rows_kind == kRowsF32) return walk_for_chain<float>(chain, noise_mode);
  return walk_for_chain<__nv_bfloat16>(chain, noise_mode);
}

// The launch configurations found so far, by (device, kernel, phases, k_pad,
// n_tokens, row_tile), and each (device, kernel)'s largest dynamic shared
// memory allowed so far.  A launch takes its configuration from here, so a
// launch inside a stream capture makes no attribute call and no occupancy
// query (a graph's warm-up sweep finds them first); the allowance only grows,
// so no later configuration takes shared memory from an earlier one.
std::mutex g_config_mu;
std::map<std::pair<int, uintptr_t>, size_t> g_smem_allowed;

uintptr_t kernel_id(WalkKernel kernel) {
  return reinterpret_cast<uintptr_t>(kernel);
}

// as many CTAs of `kernel` as the card holds at once, with `smem` bytes of
// dynamic shared memory each (called with g_config_mu held)
cudaError_t walk_grid(WalkKernel kernel, size_t smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t& allowed = g_smem_allowed[{dev, kernel_id(kernel)}];
  if (err == cudaSuccess && smem > 48 * 1024 && smem > allowed) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) allowed = smem;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), kWalkThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  return cudaSuccess;
}

// threads per token: the widest power of two (up to a CTA and to the topic
// groups) at which the grid still holds one tile's tokens at once
int walk_team(long long threads, long long tile_tokens, int groups) {
  int team = 32;
  while (team * 2 <= kWalkThreads && team * 2 <= groups &&
         threads / (team * 2) >= tile_tokens)
    team *= 2;
  return team;
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// How a walk launches: its grid, team, dynamic shared memory, and whether
// its shape allows walk_pipelined (a team per token of a tile, a topic group
// per thread at most, kFoldBatch records per thread at most, topics that fit
// a record's 11 bits, if its larger shared memory leaves the grid as it is);
// the caller then picks the form.
struct WalkConfig {
  int grid = 0;
  int team = 32;
  size_t smem = 0;
  bool pipelined = false;
};

cudaError_t walk_config(WalkKernel kernel, int phases, int k_pad,
                        long long n_tokens, int row_tile, WalkConfig* c) {
  c->smem = static_cast<size_t>(k_pad) * sizeof(float);
  cudaError_t err = walk_grid(kernel, c->smem, &c->grid);
  if (err != cudaSuccess) return err;
  const long long tile = n_tokens < row_tile ? n_tokens : row_tile;
  c->team = walk_team(static_cast<long long>(c->grid) * kWalkThreads, tile,
                      k_pad / 4);
  const int per_cta = kWalkThreads / c->team;
  if (phases != 3 || static_cast<long long>(c->grid) * per_cta < tile ||
      tile > kFoldBatch * kWalkThreads || k_pad / 4 > c->team ||
      k_pad > (1 << kTopicBits))
    return cudaSuccess;
  // WalkShared: the reciprocals and nk
  const size_t smem = 2 * static_cast<size_t>(k_pad) * sizeof(int);
  int grid = 0;
  err = walk_grid(kernel, smem, &grid);
  if (err == cudaSuccess && grid == c->grid) {
    c->smem = smem;
    c->pipelined = true;
  }
  return err;
}

std::map<std::tuple<int, uintptr_t, int, int, long long, int>, WalkConfig>
    g_configs;

// walk_config on the current device, found once per key
cudaError_t cached_walk_config(WalkKernel kernel, int phases, int k_pad,
                               long long n_tokens, int row_tile,
                               WalkConfig* c) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, kernel_id(kernel), phases, k_pad,
                                   n_tokens, row_tile);
  std::lock_guard<std::mutex> lock(g_config_mu);
  const auto it = g_configs.find(key);
  if (it != g_configs.end()) {
    *c = it->second;
    return cudaSuccess;
  }
  err = walk_config(kernel, phases, k_pad, n_tokens, row_tile, c);
  if (err == cudaSuccess) g_configs.emplace(key, *c);
  return err;
}

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch configuration lda_gibbs_tiles gives a walk (phases 3) of
// n_tokens in tiles of row_tile with k_pad topics, on the current device:
// CTAs (*grid) of *threads, *team threads per token, *pipelined 1 where the
// shape allows walk_pipelined (the caller takes it by passing ndk_copy).
extern "C" int lda_walk_config(int rows_kind, int chain, int noise_mode,
                               int k_pad, long long n_tokens, int row_tile,
                               int* grid, int* threads, int* team,
                               int* pipelined) {
  WalkConfig c;
  const cudaError_t err =
      cached_walk_config(walk_kernel(rows_kind, chain, noise_mode), 3, k_pad,
                         n_tokens, row_tile, &c);
  *grid = c.grid;
  *threads = kWalkThreads;
  *team = c.team;
  *pipelined = c.pipelined ? 1 : 0;
  return static_cast<int>(err);
}

// Walk the tiles of [0, n_tokens) in order, in one cooperative launch.
// rows_kind: 0 = bf16 snapshot, 1 = live int32 table (float32 chain only),
// 2 = float32 snapshot.  chain: 0 = float32, 1 = bfloat16, 2 = bf16p.
// scalars points to float32 alpha, beta, V*beta and key to the uint64
// Philox key (internal mode only), both on the device and read when the
// walk starts.  phases: 1 = draw only (every token against the given
// counts), 3 = draw and count move per tile (the sweep; needs `barrier`, one
// int32 that the caller zeroes).  Where lda_walk_config says pipelined, a
// walk given `ndk_copy`, two copies of ndk interleaved by doc ([M, 2, K])
// that the walk overwrites, takes walk_pipelined, and then `barrier` is
// instead its ring of move records, 2 * row_tile uint64 that the caller
// zeroes; without it, walk_general.  Returns the launch's CUDA error: a
// launch the card refuses (cooperative grid too large, too much shared
// memory, a stream capture that takes no cooperative launch) is reported,
// never split into smaller launches nor made a launch without the
// co-residency that both forms' waits need.  (The count move alone is
// lda_count_move.)
extern "C" int lda_gibbs_tiles(
    const void* rows, int rows_kind, long long row_stride, int k_pad,
    void* ndk, int k_real, void* nk, const void* z_old, void* z_new,
    const void* word, const void* doc, const void* mask, const void* uniforms,
    long long n_tokens, int row_tile, const void* scalars, const void* key,
    int noise_mode, int chain, long long slot0, int phases, void* barrier,
    void* ndk_copy, void* stream) {
  if (noise_mode < 0 || noise_mode > 2 || row_tile <= 0 ||
      scalars == nullptr || (noise_mode == 2 && key == nullptr) ||
      (phases != 1 && phases != 3) || (phases == 3 && barrier == nullptr) ||
      (k_pad & 3) || k_pad <= 0 || k_real > k_pad ||
      (rows_kind != kRowsBf16 && rows_kind != kRowsInt32 &&
       rows_kind != kRowsF32) ||
      chain < kF32 || chain > kBf16p ||
      (rows_kind == kRowsInt32 && chain != kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tokens <= 0) return static_cast<int>(cudaGetLastError());
  const WalkKernel kernel = walk_kernel(rows_kind, chain, noise_mode);
  WalkConfig c;  // the same as lda_walk_config's for phases 3
  cudaError_t err =
      cached_walk_config(kernel, phases, k_pad, n_tokens, row_tile, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool pipelined = c.pipelined && ndk_copy != nullptr;
  const size_t row_bytes = rows_kind == kRowsBf16 ? 2 : 4;
  WalkArgs a;
  a.rows = rows;
  a.row_stride = row_stride;
  a.k_pad = k_pad;
  a.ndk = static_cast<int*>(ndk);
  a.ndk_copy = static_cast<int*>(ndk_copy);
  a.k_real = k_real;
  a.nk = static_cast<int*>(nk);
  a.z_old = static_cast<const int*>(z_old);
  a.z_new = static_cast<int*>(z_new);
  a.word = static_cast<const int*>(word);
  a.doc = static_cast<const int*>(doc);
  a.mask = static_cast<const int*>(mask);
  a.uniforms = static_cast<const float*>(uniforms);
  a.n_tokens = n_tokens;
  a.row_tile = row_tile;
  a.scalars = static_cast<const float*>(scalars);
  a.key = static_cast<const unsigned long long*>(key);
  a.slot0 = slot0;
  a.phases = phases;
  a.team = c.team;
  a.vec_rows = row_stride % 4 == 0 && aligned(rows, 4 * row_bytes);
  a.vec_ndk = k_real % 4 == 0 && aligned(ndk, 16) && aligned(ndk_copy, 16);
  a.vec_noise = aligned(uniforms, 16);
  a.pipelined = pipelined;
  a.barrier = pipelined ? nullptr : static_cast<unsigned int*>(barrier);
  a.moves = pipelined ? static_cast<unsigned long long*>(barrier) : nullptr;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(c.grid), dim3(kWalkThreads),
      params, pipelined ? c.smem : static_cast<size_t>(k_pad) * sizeof(float),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One launch: move every unmasked token of [0, n_tokens) from z_old to z_new
// in each of nwk (by word), ndk (by doc) and nk that is not null, and where
// z_out is not null write z_out[i] = mask[i] ? z_new[i] : z_old[i] (z_out
// may be z_old).
extern "C" int lda_count_move(void* nwk, void* ndk, void* nk, int k_real,
                              const void* word, const void* doc,
                              const void* mask, const void* z_old,
                              const void* z_new, void* z_out,
                              long long n_tokens, void* stream) {
  if (k_real <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tokens <= 0) return static_cast<int>(cudaGetLastError());
  MoveArgs a;
  a.nwk = static_cast<int*>(nwk);
  a.ndk = static_cast<int*>(ndk);
  a.nk = static_cast<int*>(nk);
  a.k_real = k_real;
  a.word = static_cast<const int*>(word);
  a.doc = static_cast<const int*>(doc);
  a.mask = static_cast<const int*>(mask);
  a.z_old = static_cast<const int*>(z_old);
  a.z_new = static_cast<const int*>(z_new);
  a.z_out = static_cast<int*>(z_out);
  a.n = n_tokens;
  a.hist = a.nk != nullptr && k_real <= kMaxHistTopics;
  // clusters only where nk goes through the shared histograms
  const long long cluster = a.hist ? kMoveCluster : 1;
  const long long grid =
      (n_tokens + kMoveThreads * cluster - 1) / (kMoveThreads * cluster) *
      cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(grid));
  cfg.blockDim = dim3(kMoveThreads);
  cfg.dynamicSmemBytes = a.hist ? static_cast<size_t>(k_real) * sizeof(int) : 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.hist ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gibbs_tile_update, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
