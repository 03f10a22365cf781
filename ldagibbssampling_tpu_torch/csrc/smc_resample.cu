// The particle filter's resample, gated on a flag on the device.
//
// Replaces no TPU kernel.  The reference takes its resample branch with a
// lax.cond inside the scan over tokens (ldagibbssampling_tpu/backends/smc.py
// :112-122), and XLA gathers the tables by particle there.  These kernels
// are that branch for the port's captured absorb (backends/smc.py): the
// test ess < threshold stays on the device as a bool, so a CUDA graph can
// hold every token's step, and the tables move only when it is true.
//
//   resample_gather  if *flag: scratch_t[p] = table_t[idx[p]] for the four
//                    per-particle int32 tables (ndk [P, M, K], nwk [P, V, K],
//                    nk [P, K], z [P, T]), and *count += 1;
//   resample_write   if *flag: table_t[p] = scratch_t[p], so that every table
//                    keeps its address (a graph holds the addresses).
//
// Each CTA reads the flag (and the gather its idx) once, into shared memory,
// and returns at once when the flag is false: that is every token's cost,
// one launch each.  When it is true the two kernels stream the tables with
// grid-stride loops, 16 bytes a thread where a row is a multiple of four
// int32 and both tables are 16-byte aligned.  What bounds them on an H100:
// bytes.  A resample permutes 4 * P * (M*K + V*K + K + T) bytes, read once
// and written once; the gather and the write-back move twice that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParticles = 1024;

struct Tables {
  const int* src[4];
  int* dst[4];
  long long row[4];  // int32 elements of one particle's row
};

// dst[q][j] = src[from(q)][j] over the P rows of one table, this thread's
// share of them; rows of `row` elements of T
template <bool kGather, typename T>
__device__ void copy_rows(const T* __restrict__ src, T* __restrict__ dst,
                          long long row, int p, const int* s_idx) {
  const long long n = row * p;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    long long from = e;
    if (kGather) {
      const long long q = e / row;
      from = static_cast<long long>(s_idx[q]) * row + (e - q * row);
    }
    dst[e] = src[from];
  }
}

template <bool kGather>
__device__ void resample(const unsigned char* __restrict__ flag,
                         const long long* __restrict__ idx, int p, Tables t,
                         int vec_mask, long long* __restrict__ count) {
  __shared__ int s_flag;
  __shared__ int s_idx[kMaxParticles];
  if (threadIdx.x == 0) s_flag = flag[0];
  __syncthreads();
  if (!s_flag) return;
  if (kGather) {
    for (int i = threadIdx.x; i < p; i += blockDim.x)
      s_idx[i] = static_cast<int>(idx[i]);
    if (blockIdx.x == 0 && threadIdx.x == 0) *count += 1;
    __syncthreads();
  }
  for (int k = 0; k < 4; ++k) {
    if (vec_mask & (1 << k)) {
      copy_rows<kGather>(reinterpret_cast<const int4*>(t.src[k]),
                         reinterpret_cast<int4*>(t.dst[k]), t.row[k] / 4, p,
                         s_idx);
    } else {
      copy_rows<kGather>(t.src[k], t.dst[k], t.row[k], p, s_idx);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    resample_gather(const unsigned char* flag, const long long* idx, int p,
                    Tables t, int vec_mask, long long* count) {
  resample<true>(flag, idx, p, t, vec_mask, count);
}

__global__ void __launch_bounds__(kThreads)
    resample_write(const unsigned char* flag, int p, Tables t, int vec_mask) {
  resample<false>(flag, nullptr, p, t, vec_mask, nullptr);
}

bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// gather != 0: src are the tables, dst the scratch, idx [p] int64 and count
// an int64 counter; gather == 0: src the scratch, dst the tables.  flag is
// one bool byte.  rows[k]: int32 elements per particle of table k.
extern "C" int lda_smc_resample(int gather, const void* flag, const void* idx,
                                int p, const void* s0, const void* s1,
                                const void* s2, const void* s3, void* d0,
                                void* d1, void* d2, void* d3, long long r0,
                                long long r1, long long r2, long long r3,
                                void* count, int grid, void* stream) {
  if (p < 1 || p > kMaxParticles) return static_cast<int>(cudaErrorInvalidValue);
  Tables t{{static_cast<const int*>(s0), static_cast<const int*>(s1),
            static_cast<const int*>(s2), static_cast<const int*>(s3)},
           {static_cast<int*>(d0), static_cast<int*>(d1),
            static_cast<int*>(d2), static_cast<int*>(d3)},
           {r0, r1, r2, r3}};
  int vec_mask = 0;
  for (int k = 0; k < 4; ++k) {
    if (t.row[k] % 4 == 0 && aligned16(t.src[k]) && aligned16(t.dst[k]))
      vec_mask |= 1 << k;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gather) {
    resample_gather<<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(flag),
        static_cast<const long long*>(idx), p, t, vec_mask,
        static_cast<long long*>(count));
  } else {
    resample_write<<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(flag), p, t, vec_mask);
  }
  return static_cast<int>(cudaGetLastError());
}
