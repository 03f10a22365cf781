// K2 of the deferred collapsed-Gibbs sweep: rebuild the word-topic table.
//
// Replaces ldagibbssampling_tpu/ops/count_kernel.py::_count_kernel (lines
// 211-261) as build_nwk calls it with emit_mirror=True.  The TPU kernel
// builds nwk[v_pad, k_pad] as one-hot matrix products over word-sorted
// stripes of z (the matrix unit is its fastest adder); it emits the topic
// totals nk and the bf16 copy of the table (the next sweep's snapshot) in
// the same pass.
//
// Here two kernels do the same work:
//   rebuild_counts  zero nwk and nk, then +1 at (word, z) for every unmasked
//                   token with an integer atomicAdd; nk is first summed in a
//                   per-block shared-memory histogram.  Integer atomics make
//                   the result exact and independent of order.
//   cast_mirror     nwk (int32) -> bf16 with round-to-nearest-even, as the
//                   reference's f32 -> bf16 cast (count_kernel.py:261);
//                   exact int -> float first (cells stay below 2^24).
//
// What bounds them on an H100: bytes.  rebuild_counts reads 12 bytes per
// token and writes the whole [v_pad, k_pad] int32 table (the zeroing); the
// atomics land on few distinct cells under Zipf word statistics, so their
// contention, not DRAM, may cost most.  cast_mirror reads the int32 table and
// writes half as many bytes back.  The design streams both with grid-stride
// loops; no word-sorted layout is needed, so the plan's rebuild-stream arrays
// (row_gather_idx, w_local, tile_stripe) are not read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void rebuild_counts(const int* __restrict__ z,
                               const int* __restrict__ word,
                               const int* __restrict__ mask, long long n,
                               int* __restrict__ nwk, int k_pad,
                               int* __restrict__ nk) {
  extern __shared__ int hist[];
  for (int k = threadIdx.x; k < k_pad; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (mask[i] != 0) {
      const int zi = z[i];
      atomicAdd(nwk + static_cast<long long>(word[i]) * k_pad + zi, 1);
      atomicAdd(hist + zi, 1);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < k_pad; k += blockDim.x) {
    if (hist[k] != 0) atomicAdd(nk + k, hist[k]);
  }
}

__global__ void cast_mirror(const int* __restrict__ nwk,
                            __nv_bfloat16* __restrict__ mirror, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    mirror[i] = __float2bfloat16_rn(static_cast<float>(nwk[i]));
  }
}

int grid_for(long long n, int max_blocks) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > max_blocks ? max_blocks : b));
}

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// nwk [v_pad, k_pad] and nk [k_pad] are outputs (zeroed here).
extern "C" int lda_rebuild_counts(const void* z, const void* word,
                                  const void* mask, long long n, void* nwk,
                                  long long v_pad, int k_pad, void* nk,
                                  int max_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(nwk, 0, v_pad * k_pad * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(nk, 0, k_pad * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    rebuild_counts<<<grid_for(n, max_blocks), kThreads, k_pad * sizeof(int),
                     s>>>(static_cast<const int*>(z),
                          static_cast<const int*>(word),
                          static_cast<const int*>(mask), n,
                          static_cast<int*>(nwk), k_pad,
                          static_cast<int*>(nk));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lda_cast_mirror(const void* nwk, void* mirror, long long n,
                               int max_blocks, void* stream) {
  if (n > 0) {
    cast_mirror<<<grid_for(n, max_blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(nwk), static_cast<__nv_bfloat16*>(mirror), n);
  }
  return static_cast<int>(cudaGetLastError());
}
