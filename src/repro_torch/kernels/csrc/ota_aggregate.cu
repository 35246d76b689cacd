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
// Two entries share one kernel template (Keyed):
//   - the strip entry (ota_aggregate_f32) reads noise[n] from a float32
//     strip, as the TPU kernel takes it: the counterpart of
//     ota_aggregate_pallas;
//   - the keyed entry (ota_aggregate_keyed_f32), which the OTA path runs,
//     forms noise[n] = scale * z[n] in the registers of the thread that
//     adds it, z[n] the reference's normal of the round key at flat index
//     n (threefry.cuh's normal_f32, the same code as the draw kernel's)
//     and scale a float32 on the card read once per thread (__ldg, so the
//     host never syncs to hand it over), in one rounding (__fmul_rn), as
//     torch's `scale * z` gives it.  n is the element's index in the
//     payload, not in the strided rows.  So the round draws no strip: the
//     draw, the `scale * z` multiply and the strip kernel (three launches,
//     2.1 MB of traffic written and read back) become one launch, with the
//     same bits.
//
// What bounds it on this card: the strip entry, memory.  It reads
// K * N * 4 bytes of updates and N * 4 of noise and writes N * 4: at K = 3
// and LeNet-300-100's 266,610 parameters that is 5.3 MB, 1.6 us at 3.35
// TB/s.  The keyed entry reads (K + 1) * N * 4 bytes in all, 4.3 MB, 1.27
// us, but hashes each counter and forms its normal: the hash's 41
// ALU-only operations and 27 adds and erf_inv's ~45 float32 operations
// per element take at least 0.96 us at that size at Hopper's issue rate
// (chip_smoke.py:threefry_work and keyed_bound count them).
// The design streams each byte once: a 1-D grid over N, each thread takes
// four contiguous elements, loads them as one 16-byte vector per row
// (the first kRowsAhead rows all issued before the noise is formed, so
// their latency hides behind the hash's integer work), sums over K in
// registers and stores once; the last, partial quad (N % 4 elements) is
// read and written one element at a time.  The vector loads need every
// row to start on a 16-byte boundary, so the rows are read with a row
// stride `ld` (a multiple of 4 elements, >= N): core/ota.py:superpose_tree
// builds the OTA payload in that layout
// (kernels/ota_aggregate.py:row_buffer), so the path always takes the
// vector kernel.  A caller's matrix whose rows are not so aligned (a
// contiguous (K, N) with N % 4 != 0) is read one element per thread
// instead, with the same arithmetic.  kQuadsPerThread sizes the grid.
// The TPU kernel's (256, 128) tile padding and its chunking above
// 2,097,152 elements exist for VMEM and are gone.
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launch, which the wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
// quads (four elements) per thread in the vector kernel's grid
constexpr int kQuadsPerThread = 1;
// rows whose 16-byte loads are issued before the noise is formed
constexpr int kRowsAhead = 4;

// Where an element's noise comes from: the strip, or the round key.
struct Noise {
  const float* strip;   // strip entry: n scaled noise values
  const float* scale;   // keyed entry: the noise scale, one float32
  uint32_t k0, k1;      // keyed entry: the round key
  float lo, span;       // keyed entry: the uniform's bounds (threefry.py)
};

// The noise of element i; `scale` is *nz.scale, read once by the caller.
template <bool Keyed>
__device__ __forceinline__ float noise_at(const Noise& nz, float scale,
                                          int64_t i) {
  if constexpr (Keyed) {
    return __fmul_rn(scale, normal_f32(nz.k0, nz.k1, i, nz.lo, nz.span));
  } else {
    return nz.strip[i];
  }
}

template <bool Keyed>
__device__ __forceinline__ float noise_scale(const Noise& nz) {
  return Keyed ? __ldg(nz.scale) : 0.0f;
}

// One element: the noise, then one fused multiply-add per client.
template <bool Keyed>
__device__ __forceinline__ float element(const float* __restrict__ x,
                                         int64_t ld,
                                         const float* __restrict__ coeff,
                                         const Noise& nz, float scale, int k,
                                         int64_t i) {
  float acc = noise_at<Keyed>(nz, scale, i);
  for (int c = 0; c < k; ++c) {
    acc = __fmaf_rn(x[(int64_t)c * ld + i], __ldg(coeff + c), acc);
  }
  return acc;
}

__device__ __forceinline__ void fma4(float4& acc, const float4& v, float w) {
  acc.x = __fmaf_rn(v.x, w, acc.x);
  acc.y = __fmaf_rn(v.y, w, acc.y);
  acc.z = __fmaf_rn(v.z, w, acc.z);
  acc.w = __fmaf_rn(v.w, w, acc.w);
}

// One element per thread: any row stride, any alignment.
template <bool Keyed>
__global__ void ota_scalar(const float* __restrict__ x, int64_t ld,
                           const float* __restrict__ coeff, Noise nz,
                           float* __restrict__ out, int k, int64_t n) {
  const float scale = noise_scale<Keyed>(nz);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = element<Keyed>(x, ld, coeff, nz, scale, k, i);
  }
}

// Four contiguous elements per thread as one 16-byte load per row, the
// ragged last quad element by element; requires ld % 4 == 0 and 16-byte
// aligned x, out and (strip entry) noise.
template <bool Keyed>
__global__ void ota_vec4(const float* __restrict__ x, int64_t ld,
                         const float* __restrict__ coeff, Noise nz,
                         float* __restrict__ out, int k, int64_t n) {
  const float scale = noise_scale<Keyed>(nz);
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       q < quads; q += stride) {
    const int64_t i = 4 * q;
    if (i + 4 > n) {
      for (int64_t j = i; j < n; ++j) {
        out[j] = element<Keyed>(x, ld, coeff, nz, scale, k, j);
      }
      continue;
    }
    float4 v[kRowsAhead];
#pragma unroll
    for (int c = 0; c < kRowsAhead; ++c) {
      if (c < k) v[c] = reinterpret_cast<const float4*>(x + c * ld + i)[0];
    }
    float4 acc;
    if constexpr (Keyed) {
      acc = make_float4(noise_at<true>(nz, scale, i),
                        noise_at<true>(nz, scale, i + 1),
                        noise_at<true>(nz, scale, i + 2),
                        noise_at<true>(nz, scale, i + 3));
    } else {
      acc = reinterpret_cast<const float4*>(nz.strip + i)[0];
    }
#pragma unroll
    for (int c = 0; c < kRowsAhead; ++c) {
      if (c < k) fma4(acc, v[c], __ldg(coeff + c));
    }
    for (int c = kRowsAhead; c < k; ++c) {
      fma4(acc, reinterpret_cast<const float4*>(x + (int64_t)c * ld + i)[0],
           __ldg(coeff + c));
    }
    reinterpret_cast<float4*>(out + i)[0] = acc;
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // SMs x resident blocks; grid-stride beyond
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <bool Keyed>
int launch(const void* x, int64_t ld, const void* coeff, const Noise& nz,
           void* out, int k, int64_t n, int vectorized, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(coeff);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vectorized) {
    const int64_t quads = (n + 3) / 4;
    ota_vec4<Keyed><<<grid_for((quads + kQuadsPerThread - 1) /
                               kQuadsPerThread),
                      kThreads, 0, s>>>(xf, ld, cf, nz, of, k, n);
  } else {
    ota_scalar<Keyed><<<grid_for(n), kThreads, 0, s>>>(xf, ld, cf, nz, of, k,
                                                       n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: K rows of n float32, `ld` elements apart; coeff: K float32; noise:
// n float32.  vectorized: take ota_vec4 (the caller checked its layout).
int ota_aggregate_f32(const void* x, int64_t ld, const void* coeff,
                      const void* noise, void* out, int k, int64_t n,
                      int vectorized, void* stream) {
  const Noise nz = {static_cast<const float*>(noise), nullptr, 0, 0, 0.0f,
                    0.0f};
  return launch<false>(x, ld, coeff, nz, out, k, n, vectorized, stream);
}

// The same with the noise formed from the round key (k0, k1), the
// uniform's bounds (lo, span) and the scale (one float32 on the card).
int ota_aggregate_keyed_f32(const void* x, int64_t ld, const void* coeff,
                            uint32_t k0, uint32_t k1, float lo, float span,
                            const void* scale, void* out, int k, int64_t n,
                            int vectorized, void* stream) {
  const Noise nz = {nullptr, static_cast<const float*>(scale), k0, k1, lo,
                    span};
  return launch<true>(x, ld, coeff, nz, out, k, n, vectorized, stream);
}

// out[0..5]: registers per thread, static shared bytes, dynamic shared
// bytes, local (spill) bytes per thread, threads per CTA, CTAs per SM of
// the keyed vector kernel, the one the OTA path runs.
int ota_aggregate_keyed_attributes(int* out) {
  const void* fn = reinterpret_cast<const void*>(ota_vec4<true>);
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                           kThreads, 0);
  if (err != 0) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = 0;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kThreads;
  out[5] = blocks;
  return 0;
}

const char* ota_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
