// K4: a probe of the card's float32 and packed-bf16 elementwise rates.
//
// Replaces scripts/vpu_dtype_probe.py::_kernel (lines 24-33), the TPU probe
// that measured the VPU's f32 against bf16 rate for K1's chain.  Per element
// of a [rows, 512] float32 pair (a, b), in float32 or in bf16:
//
//   x = a, y = b, e = (column == 3), acc = x
//   repeat reps times:  acc = (acc - e + 0.1) * (y - e + 0.5) + acc * e
//   out = float32(acc)
//
// The float32 variant uses __fsub_rn/__fadd_rn/__fmul_rn, so no FMA
// contraction changes a rounding: it equals PyTorch's op-by-op float32
// chain bitwise.  The bf16 variant runs two columns per instruction on
// __nv_bfloat162 with __hsub2_rn/__hadd2_rn/__hmul2_rn: native packed bf16,
// each op rounded once to nearest even and no fused multiply-add, because
// the probe measures the card's packed-bf16 rate.  PyTorch's bf16 ops
// compute in float32 and round to bf16; float32's 24-bit significand is at
// least 2*8+2 bits for bf16's 8 (Figueroa's double-rounding condition), so
// that gives the bits of one native bf16 add, subtract or multiply, and the
// two agree bitwise (on all 2^24 values of [32768, 512], H100).
//
// What bounds it on an H100: each element reads 8 bytes and writes 4, and
// does 7 operations per repeat (the reference counts 5).  At the reference's
// 8 repeats that is 56 operations per 12 bytes, under the card's float32
// balance of about 20 per byte (67 TFLOP/s over 3.35 TB/s): the probe is
// bound by bytes there, and only many more repeats expose the arithmetic
// rate.  Each thread takes 4 adjacent columns (one 16-byte load of each
// input), so neighbouring threads read neighbouring addresses.  The TPU's
// 512-row VMEM tile has no counterpart: the grid covers every element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWidth = 512;  // columns, as the reference's K

__global__ void dtype_probe_f32(const float4* __restrict__ a,
                                const float4* __restrict__ b,
                                float4* __restrict__ out, long long n4,
                                int reps) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n4) return;
  const int col0 = static_cast<int>((i * 4) % kWidth);
  const float4 x = a[i];
  const float4 y = b[i];
  float acc[4] = {x.x, x.y, x.z, x.w};
  const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float e = (col0 + j == 3) ? 1.0f : 0.0f;
    for (int r = 0; r < reps; ++r) {
      acc[j] = __fadd_rn(__fmul_rn(__fadd_rn(__fsub_rn(acc[j], e), 0.1f),
                                   __fadd_rn(__fsub_rn(yv[j], e), 0.5f)),
                         __fmul_rn(acc[j], e));
    }
  }
  out[i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__global__ void dtype_probe_bf16(const float4* __restrict__ a,
                                 const float4* __restrict__ b,
                                 float4* __restrict__ out, long long n4,
                                 int reps) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n4) return;
  const int col0 = static_cast<int>((i * 4) % kWidth);
  const float4 x = a[i];
  const float4 y = b[i];
  __nv_bfloat162 acc[2] = {__floats2bfloat162_rn(x.x, x.y),
                           __floats2bfloat162_rn(x.z, x.w)};
  const __nv_bfloat162 yv[2] = {__floats2bfloat162_rn(y.x, y.y),
                                __floats2bfloat162_rn(y.z, y.w)};
  const __nv_bfloat162 c01 = __float2bfloat162_rn(0.1f);
  const __nv_bfloat162 c05 = __float2bfloat162_rn(0.5f);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = col0 + 2 * j;
    const __nv_bfloat162 e = __floats2bfloat162_rn(c == 3 ? 1.0f : 0.0f,
                                                   c + 1 == 3 ? 1.0f : 0.0f);
    for (int r = 0; r < reps; ++r) {
      acc[j] = __hadd2_rn(
          __hmul2_rn(__hadd2_rn(__hsub2_rn(acc[j], e), c01),
                     __hadd2_rn(__hsub2_rn(yv[j], e), c05)),
          __hmul2_rn(acc[j], e));
    }
  }
  const float2 lo = __bfloat1622float2(acc[0]);
  const float2 hi = __bfloat1622float2(acc[1]);
  out[i] = make_float4(lo.x, lo.y, hi.x, hi.y);
}

}  // namespace

extern "C" const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One launch over [rows, 512] float32 inputs; bf16 != 0 runs the packed
// bf16 chain.  Returns cudaGetLastError.
extern "C" int lda_dtype_probe(const void* a, const void* b, void* out,
                               long long rows, int reps, int bf16,
                               void* stream) {
  if (rows <= 0 || reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = rows * kWidth / 4;
  const unsigned int grid =
      static_cast<unsigned int>((n4 + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a4 = static_cast<const float4*>(a);
  const auto* b4 = static_cast<const float4*>(b);
  auto* o4 = static_cast<float4*>(out);
  if (bf16)
    dtype_probe_bf16<<<grid, kThreads, 0, s>>>(a4, b4, o4, n4, reps);
  else
    dtype_probe_f32<<<grid, kThreads, 0, s>>>(a4, b4, o4, n4, reps);
  return static_cast<int>(cudaGetLastError());
}
