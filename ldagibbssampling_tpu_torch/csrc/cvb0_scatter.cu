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
// by id (`order`), the runs of equal ids in that order (`bounds`) and each
// run's table row (`dest`).
//
//   cvb0_scatter  one thread per (run, topic column), the columns fastest:
//                 acc = table[dest[r], k]; acc += rows[order[j], k] for j
//                 over the run in plan order; table[dest[r], k] = acc.
//
// Each table cell gets dest + r_i1 + r_i2 + ... in ascending token order,
// one float32 add at a time: the bits of the CPU's serial `index_add_` in
// token order (the plain version), and the same bits in every run.  No two
// threads write one cell, so the kernel takes no atomic.  What bounds it on
// an H100: bytes (the block's rows, the plan and the touched table rows read
// once, those rows written once), where runs are short; a long run (a
// frequent word of a skewed corpus, thousands of a block's tokens) is one
// thread's serial chain of dependent adds, as in a sort-based scatter, and
// then the run's length bounds it.  Padding tokens stay in the plan and add
// their zero delta, as the eager scatter does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Offset: int for a table and a block of fewer than 2^31 elements, else
// long long
template <typename Offset>
__global__ void __launch_bounds__(kThreads)
    cvb0_scatter(float* __restrict__ table, const float* __restrict__ rows,
                 const int* __restrict__ order, const int* __restrict__ bounds,
                 const int* __restrict__ dest, int n_runs, int k) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(n_runs) * k) return;
  const int run = static_cast<int>(t / k);
  const int col = static_cast<int>(t - static_cast<long long>(run) * k);
  float* cell = table + static_cast<Offset>(dest[run]) * k + col;
  const int end = bounds[run + 1];
  float acc = *cell;
  for (int j = bounds[run]; j < end; ++j)
    acc += rows[static_cast<Offset>(order[j]) * k + col];
  *cell = acc;
}

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table [R, k] float32; rows [B, k] float32, the block's; order the plan's
// block-local positions (the whole stream's array); bounds and dest the
// block's first run's entries (n_runs + 1 and n_runs of them); wide != 0:
// 64-bit offsets.
extern "C" int lda_cvb0_scatter(void* table, const void* rows,
                                const void* order, const void* bounds,
                                const void* dest, int n_runs, int k, int wide,
                                void* stream) {
  if (n_runs < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(n_runs) * k;
  const long long grid = (threads + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<float*>(table);
  auto* r = static_cast<const float*>(rows);
  auto* o = static_cast<const int*>(order);
  auto* b = static_cast<const int*>(bounds);
  auto* d = static_cast<const int*>(dest);
  if (wide) {
    cvb0_scatter<long long><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        t, r, o, b, d, n_runs, k);
  } else {
    cvb0_scatter<int><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        t, r, o, b, d, n_runs, k);
  }
  return static_cast<int>(cudaGetLastError());
}
