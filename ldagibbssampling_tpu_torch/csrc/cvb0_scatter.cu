// CVB0's scatter of one block's rows into a count table, in a fixed order.
//
// Replaces no TPU kernel.  The reference's CVB0 sweep adds each block's
// deltas into its expected counts with `ndk.at[d].add(delta)` and
// `nwk.at[w].add(delta)` (ldagibbssampling_tpu/backends/cvb0.py:69-70),
// which XLA lowers to a scatter.  On the card a float32 scatter with atomics
// adds in an order that changes from run to run, and a sort-based one sorts
// the same ids again in every block of every sweep.  A block's ids never
// change during a run, so ops/cvb0_scatter.scatter_plan sorts them once,
// on the host, into a plan: per block, the block's positions stably sorted
// by id (`order`), the runs of equal ids in that order (`bounds`), each
// run's table row (`dest`), and the block's work units (`units`).
//
// The order of additions.  Each table cell gets
// dest + r_i1 + r_i2 + ... in ascending token order, one float32 add at a
// time, by one thread: the bits of the CPU's serial `index_add_` in token
// order (the plain version), and the same bits in every run.  No two
// threads write one cell, so the kernel takes no atomic.  Padding tokens
// stay in the plan and add their zero delta, as the eager scatter does.
//
// What bounds it on an H100: bytes (the block's rows, the plan and the
// touched table rows read once, those rows written once) where runs are
// short; a long run (a frequent word of a skewed corpus, thousands of a
// block's tokens) is a chain of dependent adds that no split may shorten,
// ~4 cycles an add; a small block (K = 15) is a few dependent round trips
// to memory.  The design:
//
//   work units   a unit is a span of whole runs of one block (`units`: first
//                and end run, first and end position in `order`), times one
//                slab of kSlabCols topic columns: one CTA each, unit-major,
//                so a long run's slabs run on different SMs and its bytes
//                spread over the card.  The plan packs runs of at most
//                SHORT_RUN (ops/cvb0_scatter.py) rows several to a unit of
//                fewer than kUnitRows rows; a longer run is a unit of its
//                own, and the plan puts the units with the longest runs
//                first.  A table of one slab (K <= kSlabCols) shares a
//                packed unit's runs out to kParts CTAs.
//   packed unit  the order entries, run bounds and table rows of the CTA's
//                runs go to shared memory; then, where every run has at
//                most kDirectRun rows (one slab only), each (run, column)'s
//                thread loads its table value and rows into registers at
//                once; else the rows' and table rows' slabs go to shared
//                memory with cp.async, all at once, and one thread per (run,
//                column) adds them from there.  Either way it adds in plan
//                order onto the table's value and stores the cell.
//   streamed     (one run of more than kUnitRows rows, or kUnitRows / 2 in
//   run          a table of several slabs) warp-specialised: kProducers
//                threads copy chunks of kChunk rows into a ring of kStages
//                stages with cp.async, the chunk's order entries a whole
//                ring ahead (so no copy waits on its index), and each
//                producer's copies arrive on the stage's `full` mbarrier as
//                they land; the last warp, one lane per column, waits on
//                `full`, adds the chunk from shared memory and frees the
//                stage (`empty`).  No CTA-wide barrier stops the chain.
//
// The copies move 16 bytes (cp.async.cg) where the topic count is a
// multiple of 4 and both tensors are 16-byte aligned (K = 500's 2,000-byte
// rows), else 4 bytes (cp.async.ca; K = 15's 60-byte rows): a path chosen
// by alignment, both bitwise the plain version.  (A TMA bulk copy per
// row's slab, issued by one warp, measured 2-4x slower on an H100 than
// these: PERF.md.)

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kProducers = 256;  // a streamed run's copying threads
constexpr int kThreads = kProducers + 32;  // and its adding warp
constexpr int kUnitRows = 256;  // a packed unit's rows at most
constexpr int kSlabCols = 32;   // topic columns per unit's CTA
constexpr int kChunk = 64;      // rows per stage of a streamed run
constexpr int kStages = 2 * kUnitRows / kChunk;  // the ring: both buffers
constexpr int kIdx = 2 * kStages * kChunk;       // ints of index space
constexpr int kBars = 2 * kStages;               // a stage's full and empty
constexpr int kParts = 8;      // a one-slab table's CTAs a packed unit
constexpr int kDirectRun = 8;  // a one-slab table's packed unit's runs all
                               // this short: no staging
static_assert(3 * kUnitRows + 1 <= kIdx, "a packed unit's indices fit");
static_assert(kStages >= 2, "the ring keeps a chunk in flight");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// this thread's cp.async copies so far arrive on `bar` as they land (the
// barrier's count includes the arrival: .noinc)
__device__ __forceinline__ void copy_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The least power of two at or above x (x >= 1), as its exponent: the lanes
// of a row, so that a row and a lane come from shifts and masks
__device__ __forceinline__ int lanes_log2(int x) { return 32 - __clz(x - 1); }

// Start copying `n` rows' slab [c0, c0 + w) to `dst` (a row every `ws`
// floats): row r from `src + id(r) * k`.
template <typename Offset, int kVec, int kStride, typename Id>
__device__ __forceinline__ void copy_slabs(float* dst, int ws,
                                           const float* src, int k, int c0,
                                           int w, int n, Id id) {
  const int per_row = w / kVec, shift = lanes_log2(per_row);
  const int mask = (1 << shift) - 1;
  for (int i = threadIdx.x; i < (n << shift); i += kStride) {
    const int r = i >> shift, v = (i & mask) * kVec;
    if (v < w)
      copy_async<4 * kVec>(dst + r * ws + v,
                           src + static_cast<Offset>(id(r)) * k + c0 + v);
  }
}

// acc + s[0] + s[stride] + ... + s[(n - 1) * stride], in that order, one
// float32 add at a time; the next kGroup loads issued while a group is
// added, so the chain waits on fadd and not on shared memory's latency
__device__ __forceinline__ float add_rows(float acc, const float* s,
                                          int stride, int n) {
  constexpr int kGroup = 8;
  int j = 0;
  if (n >= kGroup) {
    float cur[kGroup], next[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) cur[q] = s[q * stride];
    for (j = kGroup; j + kGroup <= n; j += kGroup) {
#pragma unroll
      for (int q = 0; q < kGroup; ++q) next[q] = s[(j + q) * stride];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) acc += cur[q];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) cur[q] = next[q];
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) acc += cur[q];
  }
  for (; j < n; ++j) acc += s[j * stride];
  return acc;
}

// A packed unit (at most kUnitRows rows), or this CTA's share of its runs.
template <typename Offset, int kVec>
__device__ __forceinline__ void packed_runs(
    float* __restrict__ table, const float* __restrict__ rows,
    const int* __restrict__ order, const int* __restrict__ bounds,
    const int* __restrict__ dest, int4 u, int k, int c0, int w, int ws,
    int part, int parts, int* idx, float* buf) {
  // this CTA's share of the unit's runs: part `part` of `parts`
  const int share = (u.y - u.x + parts - 1) / parts;
  const int r0 = u.x + part * share, runs = min(u.y - r0, share);
  if (runs <= 0) return;
  int* ord = idx;                  // the unit's rows' block-local positions
  int* dst = idx + kUnitRows;      // the share's table rows
  int* bnd = idx + 2 * kUnitRows;  // the share's runs' first rows in the unit
  float* rows_s = buf;
  float* table_s = buf + kUnitRows * ws;
  const int n = u.w - u.z;
  for (int i = threadIdx.x; i < n; i += kThreads) ord[i] = order[u.z + i];
  bool long_run = parts == 1;  // a table of several slabs stages its rows
  for (int i = threadIdx.x; i <= runs; i += kThreads) {
    bnd[i] = bounds[r0 + i] - u.z;
    if (i < runs) {
      dst[i] = dest[r0 + i];
      long_run |= bounds[r0 + i + 1] - bounds[r0 + i] > kDirectRun;
    }
  }
  const int shift = lanes_log2(w), mask = (1 << shift) - 1;
  if (!__syncthreads_or(long_run)) {
    // every run short: each (run, column)'s thread loads its table value and
    // its rows straight into registers, all at once, and adds them in order
    for (int i = threadIdx.x; i < (runs << shift); i += kThreads) {
      const int r = i >> shift, c = i & mask;
      if (c >= w) continue;
      const int j0 = bnd[r], len = bnd[r + 1] - j0;
      const Offset cell = static_cast<Offset>(dst[r]) * k + c0 + c;
      float v[kDirectRun];
#pragma unroll
      for (int q = 0; q < kDirectRun; ++q)
        if (q < len) v[q] = rows[static_cast<Offset>(ord[j0 + q]) * k + c0 + c];
      float acc = table[cell];
#pragma unroll
      for (int q = 0; q < kDirectRun; ++q)
        if (q < len) acc += v[q];
      table[cell] = acc;
    }
    return;
  }
  const int first = bnd[0];  // the share's rows: first .. bnd[runs]
  copy_slabs<Offset, kVec, kThreads>(
      rows_s + first * ws, ws, rows, k, c0, w, bnd[runs] - first,
      [ord, first](int r) { return ord[first + r]; });
  copy_slabs<Offset, kVec, kThreads>(table_s, ws, table, k, c0, w, runs,
                                     [dst](int r) { return dst[r]; });
  commit_copies();
  wait_copies<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < (runs << shift); i += kThreads) {
    const int r = i >> shift, c = i & mask;
    if (c >= w) continue;
    const int first = bnd[r];
    const float acc = add_rows(table_s[r * ws + c], rows_s + first * ws + c,
                               ws, bnd[r + 1] - first);
    table[static_cast<Offset>(dst[r]) * k + c0 + c] = acc;
  }
}

// A lone run of more than `stream_rows` rows through the ring,
// warp-specialised: kProducers threads copy, the last warp adds.  Producer
// iteration m copies chunk m + kStages's order entries (the same threads'
// cp.async groups, so they have landed kStages iterations later:
// cp.async.wait_group and a producers' named barrier) and chunk m's rows
// into stage m % kStages, once the adder has freed it (`empty`); each
// producer's copies then arrive on the stage's `full` barrier as they land.
// The adder waits on `full`, adds the chunk from shared memory and frees the
// stage: no CTA-wide barrier, so the chain runs on while the next
// kStages - 1 chunks load.
template <typename Offset, int kVec>
__device__ __forceinline__ void streamed_run(
    float* __restrict__ table, const float* __restrict__ rows,
    const int* __restrict__ order, const int* __restrict__ dest, int4 u,
    int k, int c0, int w, int ws, uint64_t* full, uint64_t* empty, int* idx,
    float* ring) {
  const int t = threadIdx.x, n = u.w - u.z;
  const int chunks = (n + kChunk - 1) / kChunk;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kProducers);
      mbar_init(empty + s, 1);
    }
  }
  if (t < kProducers) {  // the order entries of chunks 0 .. kStages - 1
    const int first = min(n, kStages * kChunk);
    for (int i = t; i < first; i += kProducers) idx[i] = order[u.z + i];
  }
  __syncthreads();
  if (t >= kProducers) {  // the adder: one lane per column of the slab
    const int c = t - kProducers;
    if (c >= w) return;
    const unsigned lanes = w == 32 ? 0xffffffffu : (1u << w) - 1;
    const Offset cell = static_cast<Offset>(dest[u.x]) * k + c0 + c;
    float acc = table[cell];
    for (int m = 0; m < chunks; ++m) {
      const int s = m % kStages;
      mbar_wait(full + s, (m / kStages) & 1);
      acc = add_rows(acc, ring + s * kChunk * ws + c, ws,
                     min(kChunk, n - m * kChunk));
      __syncwarp(lanes);
      if (c == 0) mbar_arrive(empty + s);
    }
    table[cell] = acc;
    return;
  }
  for (int m = 0; m < chunks; ++m) {
    const int s = m % kStages;
    if (m >= kStages) {
      wait_copies<kStages - 1>();  // chunk m's order entries have landed
      asm volatile("bar.sync 1, %0;\n" :: "n"(kProducers) : "memory");
      mbar_wait(empty + s, (m / kStages - 1) & 1);
    }
    const int* o = idx + (m % (2 * kStages)) * kChunk;
    copy_slabs<Offset, kVec, kProducers>(
        ring + s * kChunk * ws, ws, rows, k, c0, w, min(kChunk, n - m * kChunk),
        [o](int r) { return o[r]; });
    const int ahead = m + kStages;
    if (ahead < chunks) {
      int* oa = idx + (ahead % (2 * kStages)) * kChunk;
      const int len = min(kChunk, n - ahead * kChunk);
      for (int i = t; i < len; i += kProducers)
        copy_async<4>(oa + i, order + u.z + ahead * kChunk + i);
    }
    commit_copies();
    copy_arrive(full + s);
  }
  wait_copies<0>();
}

// Offset: int for a table and a block of fewer than 2^31 elements, else
// long long; kVec: floats per copy (4 or 1).  One CTA per (unit, slab,
// part), unit-major.
template <typename Offset, int kVec>
__global__ void __launch_bounds__(kThreads)
    cvb0_scatter(float* __restrict__ table, const float* __restrict__ rows,
                 const int* __restrict__ order, const int* __restrict__ bounds,
                 const int* __restrict__ dest, const int4* __restrict__ units,
                 int slabs, int parts, int stream_rows, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* bars = reinterpret_cast<uint64_t*>(smem);
  int* idx = reinterpret_cast<int*>(smem + kBars * sizeof(uint64_t));
  float* buf = reinterpret_cast<float*>(smem + kBars * sizeof(uint64_t) +
                                        kIdx * sizeof(int));
  const int ws = k < kSlabCols ? k : kSlabCols;
  const int per_unit = slabs * parts;
  const int unit = blockIdx.x / per_unit;
  const int slab = (blockIdx.x - unit * per_unit) / parts;
  const int part = blockIdx.x - unit * per_unit - slab * parts;
  const int c0 = slab * kSlabCols;
  const int w = min(kSlabCols, k - c0);
  const int4 u = units[unit];
  if (u.y - u.x == 1 && u.w - u.z > stream_rows) {
    if (part != 0) return;
    streamed_run<Offset, kVec>(table, rows, order, dest, u, k, c0, w, ws, bars,
                               bars + kStages, idx, buf);
  } else {
    packed_runs<Offset, kVec>(table, rows, order, bounds, dest, u, k, c0, w,
                              ws, part, parts, idx, buf);
  }
}

constexpr size_t kSmemFixed = kBars * sizeof(uint64_t) + kIdx * sizeof(int);
std::mutex g_smem_mu;
std::set<std::pair<int, const void*>> g_smem_set;  // (device, kernel)

// the kernel's allowance of dynamic shared memory, once per device
template <typename Offset, int kVec>
cudaError_t launch(float* table, const float* rows, const int* order,
                   const int* bounds, const int* dest, const int4* units,
                   int n_units, int k, cudaStream_t s) {
  auto kernel = cvb0_scatter<Offset, kVec>;
  const int ws = k < kSlabCols ? k : kSlabCols;
  const size_t smem = kSmemFixed + 2 * kUnitRows * ws * sizeof(float);
  const int slabs = (k + kSlabCols - 1) / kSlabCols;
  // a one-slab table (k <= kSlabCols) shares each packed unit's runs out to
  // kParts CTAs, and its lone runs of up to kUnitRows rows go at once; a
  // wider table's lone runs of more than kUnitRows / 2 rows stream (each
  // slab's CTA adds while it loads)
  const int parts = slabs == 1 ? kParts : 1;
  const int stream_rows = slabs == 1 ? kUnitRows : kUnitRows / 2;
  const long long grid = static_cast<long long>(n_units) * slabs * parts;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> hold(g_smem_mu);
    const auto key = std::make_pair(dev, reinterpret_cast<const void*>(kernel));
    if (!g_smem_set.count(key)) {
      err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemFixed +
                                                  2 * kUnitRows * kSlabCols *
                                                      sizeof(float)));
      if (err != cudaSuccess) return err;
      g_smem_set.insert(key);
    }
  }
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      table, rows, order, bounds, dest, units, slabs, parts, stream_rows, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table [R, k] float32; rows [B, k] float32, the block's; order, bounds and
// dest the plan's whole arrays; units the block's first unit (n_units of
// them, int32 x 4 each: first run, end run, first position, end position);
// unit_rows and slab_cols the plan's and the wrapper's geometry, which must
// be this library's; wide != 0: 64-bit offsets.
extern "C" int lda_cvb0_scatter(void* table, const void* rows,
                                const void* order, const void* bounds,
                                const void* dest, const void* units,
                                int n_units, int k, int unit_rows,
                                int slab_cols, int wide, void* stream) {
  if (n_units < 1 || k < 1 || unit_rows != kUnitRows ||
      slab_cols != kSlabCols || reinterpret_cast<uintptr_t>(units) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<float*>(table);
  auto* r = static_cast<const float*>(rows);
  auto* o = static_cast<const int*>(order);
  auto* b = static_cast<const int*>(bounds);
  auto* d = static_cast<const int*>(dest);
  auto* u = static_cast<const int4*>(units);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  cudaError_t err;
  if (wide) {
    err = vec ? launch<long long, 4>(t, r, o, b, d, u, n_units, k, s)
              : launch<long long, 1>(t, r, o, b, d, u, n_units, k, s);
  } else {
    err = vec ? launch<int, 4>(t, r, o, b, d, u, n_units, k, s)
              : launch<int, 1>(t, r, o, b, d, u, n_units, k, s);
  }
  return static_cast<int>(err);
}
