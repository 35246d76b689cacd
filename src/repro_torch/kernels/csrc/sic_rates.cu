// Weighted SIC sum-rate scorer for Hopper (sm_90a): the vertex scorer of
// the device-resident MWIS greedy (paper §III-A, Algorithm 2).
//
// Replaces repro/kernels/sic_rates.py:sic_weighted_rates_pallas (the Pallas
// kernel _sic_kernel).  For every candidate NOMA group r of a (V, K)
// batch (row-major powers p, gains g, weights w) it computes, in float32,
//
//     rx_i   = (p_i * g_i) * g_i          in the input type, then to float32
//     tail_i = sum_{j != i, j = 0..K-1} rx_j * [rx_j < rx_i
//                                             or (rx_j == rx_i and j > i)]
//     out[r] = sum_{i = 0..K-1} w_i * log2(1 + rx_i / (tail_i + noise))
//
// with every sum taken in that order and every operation rounded on its own
// (__fadd_rn / __fmul_rn / __fdiv_rn, no fused multiply-add), which is the
// Pallas kernel's arithmetic.  tail_i is the receive power decoded after
// user i under the descending-rx, ties-to-the-lower-index SIC order: the
// O(K^2) comparison matrix needs no sort, and K <= 8.
//
// What bounds it on this card: memory.  Per group it reads 3 * K values of
// the input type and writes one float32: 76 bytes at K = 3 in float64,
// against about 3 * K^2 + 4 * K float operations and K log2f calls, far
// below the card's 20 operations per byte.  The design is the plain one:
// one thread per group, K a template constant so the comparison matrix
// unrolls into registers, a grid-stride loop over V.  The TPU kernel's
// (K, V) transpose and its (8, 512) padding served the TPU's (8, 128)
// tiles and are gone: nothing is padded or transposed.
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launch, which the wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float rx_of(float p, float g) {
  return __fmul_rn(__fmul_rn(p, g), g);
}
__device__ __forceinline__ float rx_of(double p, double g) {
  return __double2float_rn(__dmul_rn(__dmul_rn(p, g), g));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) {
  return __double2float_rn(x);
}

template <typename T, int K>
__global__ void sic_kernel(const T* __restrict__ p, const T* __restrict__ g,
                           const T* __restrict__ w, float noise,
                           float* __restrict__ out, int64_t v) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < v;
       r += stride) {
    const int64_t base = r * K;
    float rx[K];
    float wf[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      rx[c] = rx_of(p[base + c], g[base + c]);
      wf[c] = to_f32(w[base + c]);
    }
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float tail = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j == i) continue;
        const bool after = rx[j] < rx[i] || (rx[j] == rx[i] && j > i);
        if (after) tail = __fadd_rn(tail, rx[j]);
      }
      const float sinr = __fdiv_rn(rx[i], __fadd_rn(tail, noise));
      acc = __fadd_rn(acc, __fmul_rn(wf[i], log2f(__fadd_rn(1.0f, sinr))));
    }
    out[r] = acc;
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // SMs x resident blocks; grid-stride beyond
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
int launch(const T* p, const T* g, const T* w, float noise, float* out,
           int k, int64_t v, cudaStream_t stream) {
  const int grid = grid_for(v);
  switch (k) {
#define SIC_CASE(K)                                                       \
  case K:                                                                 \
    sic_kernel<T, K><<<grid, kThreads, 0, stream>>>(p, g, w, noise, out,  \
                                                     v);                  \
    break;
    SIC_CASE(1)
    SIC_CASE(2)
    SIC_CASE(3)
    SIC_CASE(4)
    SIC_CASE(5)
    SIC_CASE(6)
    SIC_CASE(7)
    SIC_CASE(8)
#undef SIC_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sic_weighted_rates_f32(const void* p, const void* g, const void* w,
                           float noise, void* out, int k, int64_t v,
                           void* stream) {
  return launch<float>(static_cast<const float*>(p),
                       static_cast<const float*>(g),
                       static_cast<const float*>(w), noise,
                       static_cast<float*>(out), k, v,
                       static_cast<cudaStream_t>(stream));
}

int sic_weighted_rates_f64(const void* p, const void* g, const void* w,
                           float noise, void* out, int k, int64_t v,
                           void* stream) {
  return launch<double>(static_cast<const double*>(p),
                        static_cast<const double*>(g),
                        static_cast<const double*>(w), noise,
                        static_cast<float*>(out), k, v,
                        static_cast<cudaStream_t>(stream));
}

const char* sic_rates_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
