// Over-the-air receiver reduction for Hopper (sm_90a).
//
// Replaces repro/kernels/aggregate.py:ota_aggregate_pallas (the Pallas
// kernel _ota_kernel / _ota_block) on the OTA uplink's path
// (core/ota.py:superpose_flat).  For every element n of a client-stacked
// (K, N) matrix of raw updates it computes
//
//     out[n] = noise[n] + sum_{k=0..K-1} x[k, n] * coeff[k]
//
// in float32: the accumulator starts at the (already scaled) receiver
// noise, then adds the clients k = 0..K-1 in order, each as one fused
// multiply-add (__fmaf_rn, a single rounding).  That is the Pallas
// kernel's order, and XLA contracts its `acc + x * coeff` into a fused
// multiply-add, so the kernel, its plain version and the Pallas kernel (in
// interpret mode on the CPU) agree to the bit.
//
// What bounds it on this card: memory.  It reads K * N * 4 bytes of
// updates and N * 4 of noise and writes N * 4, (K + 2) * N * 4 in all: at
// K = 3 and LeNet-300-100's 266,610 parameters that is 5.3 MB, 1.6 us at
// 3.35 TB/s.  The design streams each byte once: a 1-D grid over N, each
// thread takes four contiguous elements, loads them as one 16-byte vector
// per row, sums over K in registers and stores once; the last, partial
// quad (N % 4 elements) is read and written one element at a time.  The
// vector loads need every row to start on a 16-byte boundary, so the rows
// are read with a row stride `ld` (a multiple of 4 elements, >= N):
// core/ota.py:superpose_tree builds the OTA payload in that layout
// (kernels/ota_aggregate.py:row_buffer), so the path always takes the
// vector kernel.  A caller's matrix whose rows are not so aligned (a
// contiguous (K, N) with N % 4 != 0) is read one element per thread
// instead.  The TPU kernel's (256, 128) tile padding and its chunking
// above 2,097,152 elements exist for VMEM and are gone.
//
// C interface (loaded with ctypes): the entry point returns
// cudaGetLastError() after its launch, which the wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One element per thread: any row stride, any alignment.
__global__ void ota_scalar(const float* __restrict__ x, int64_t ld,
                           const float* __restrict__ coeff,
                           const float* __restrict__ noise,
                           float* __restrict__ out, int k, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = noise[i];
    for (int c = 0; c < k; ++c) {
      acc = __fmaf_rn(x[(int64_t)c * ld + i], __ldg(coeff + c), acc);
    }
    out[i] = acc;
  }
}

// Four contiguous elements per thread as one 16-byte load per row, the
// ragged last quad element by element; requires ld % 4 == 0 and 16-byte
// aligned x, noise and out.
__global__ void ota_vec4(const float* __restrict__ x, int64_t ld,
                         const float* __restrict__ coeff,
                         const float* __restrict__ noise,
                         float* __restrict__ out, int k, int64_t n) {
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       q < quads; q += stride) {
    const int64_t i = 4 * q;
    if (i + 4 <= n) {
      float4 acc = reinterpret_cast<const float4*>(noise + i)[0];
      for (int c = 0; c < k; ++c) {
        const float4 v =
            reinterpret_cast<const float4*>(x + (int64_t)c * ld + i)[0];
        const float w = __ldg(coeff + c);
        acc.x = __fmaf_rn(v.x, w, acc.x);
        acc.y = __fmaf_rn(v.y, w, acc.y);
        acc.z = __fmaf_rn(v.z, w, acc.z);
        acc.w = __fmaf_rn(v.w, w, acc.w);
      }
      reinterpret_cast<float4*>(out + i)[0] = acc;
    } else {
      for (int64_t j = i; j < n; ++j) {
        float acc = noise[j];
        for (int c = 0; c < k; ++c) {
          acc = __fmaf_rn(x[(int64_t)c * ld + j], __ldg(coeff + c), acc);
        }
        out[j] = acc;
      }
    }
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // SMs x resident blocks; grid-stride beyond
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

int ota_aggregate_f32(const void* x, int64_t ld, const void* coeff,
                      const void* noise, void* out, int k, int64_t n,
                      int vectorized, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(coeff);
  const float* nf = static_cast<const float*>(noise);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vectorized) {
    ota_vec4<<<grid_for((n + 3) / 4), kThreads, 0, s>>>(xf, ld, cf, nf, of,
                                                        k, n);
  } else {
    ota_scalar<<<grid_for(n), kThreads, 0, s>>>(xf, ld, cf, nf, of, k, n);
  }
  return (int)cudaGetLastError();
}

const char* ota_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
