// Fused dequant + weighted FedAvg aggregation for Hopper (sm_90a).
//
// Replaces repro/kernels/aggregate.py:weighted_aggregate_pallas (the Pallas
// kernel _aggregate_kernel / _aggregate_block) on the batched FL engine's
// main path.  It computes, for every element n of a client-stacked (K, N)
// code matrix,
//
//     out[n] = sum_{k=0..K-1} codes[k, n] * coeff[k],
//     coeff[k] = scale_k * w_k / a_k           (computed by the wrapper)
//
// in float32, k in order 0..K-1 from zero, one fused multiply-add per
// client (__fmaf_rn): the Pallas kernel's `acc + codes * coeff` as XLA
// compiles it in the reference's jitted round, which contracts it.
//
// What bounds it on this card: memory.  It reads K * N * 4 bytes of codes
// and writes N * 4, (K + 1) * N * 4 in all: at K = 3 and the largest LeNet
// leaf (235,200 elements) that is 3.8 MB, about a microsecond at 3.35 TB/s,
// so at LeNet size a launch costs more than the work.  The design
// is the plain one that streams each byte once: one 1-D grid over N, each
// thread loads four contiguous elements per client as one 16-byte vector
// (when N % 4 == 0 and the rows are 16-byte aligned; otherwise one element
// per thread), sums over K in registers and stores once.  The TPU kernel's
// (256, 128) tile padding and its chunking exist for VMEM and are gone:
// nothing is padded and the ragged edge is masked.
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launch, which the wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int x) { return __int2float_rn(x); }

template <typename T>
struct Vec4;
template <>
struct Vec4<float> { using type = float4; };
template <>
struct Vec4<int> { using type = int4; };

// One element per thread: any N, any alignment.
template <typename T>
__global__ void aggregate_scalar(const T* __restrict__ codes,
                                 const float* __restrict__ coeff,
                                 float* __restrict__ out, int k, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.0f;
    for (int c = 0; c < k; ++c) {
      acc = __fmaf_rn(to_f32(codes[(int64_t)c * n + i]), __ldg(coeff + c),
                      acc);
    }
    out[i] = acc;
  }
}

// Four contiguous elements per thread as one 16-byte load per client row;
// requires N % 4 == 0 and 16-byte aligned codes and out.
template <typename T>
__global__ void aggregate_vec4(const T* __restrict__ codes,
                               const float* __restrict__ coeff,
                               float* __restrict__ out, int k, int64_t n) {
  using V = typename Vec4<T>::type;
  const int64_t nv = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += stride) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < k; ++c) {
      const V v = reinterpret_cast<const V*>(codes + (int64_t)c * n)[i];
      const float w = __ldg(coeff + c);
      acc.x = __fmaf_rn(to_f32(v.x), w, acc.x);
      acc.y = __fmaf_rn(to_f32(v.y), w, acc.y);
      acc.z = __fmaf_rn(to_f32(v.z), w, acc.z);
      acc.w = __fmaf_rn(to_f32(v.w), w, acc.w);
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // SMs x resident blocks; grid-stride beyond
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
int launch(const T* codes, const float* coeff, float* out, int k, int64_t n,
           int vectorized, cudaStream_t stream) {
  if (vectorized) {
    aggregate_vec4<T><<<grid_for(n / 4), kThreads, 0, stream>>>(
        codes, coeff, out, k, n);
  } else {
    aggregate_scalar<T><<<grid_for(n), kThreads, 0, stream>>>(
        codes, coeff, out, k, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int weighted_aggregate_f32(const void* codes, const void* coeff, void* out,
                           int k, int64_t n, int vectorized, void* stream) {
  return launch<float>(static_cast<const float*>(codes),
                       static_cast<const float*>(coeff),
                       static_cast<float*>(out), k, n, vectorized,
                       static_cast<cudaStream_t>(stream));
}

int weighted_aggregate_i32(const void* codes, const void* coeff, void* out,
                           int k, int64_t n, int vectorized, void* stream) {
  return launch<int>(static_cast<const int*>(codes),
                     static_cast<const float*>(coeff),
                     static_cast<float*>(out), k, n, vectorized,
                     static_cast<cudaStream_t>(stream));
}

const char* aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
