// Threefry-2x32 draws for Hopper (sm_90a): uniforms, normals and truncated
// normals of jax.random's streams, bit for bit, in one launch.
//
// The plain version is core/prng.py, which recomputes every step in
// integer and float64 tensor ops (about 1,300 launches for one normal
// draw); this kernel takes one.  For the flat index i < n it hashes the
// counter pair (i >> 32, i & 0xFFFFFFFF) under the key (k0, k1) with
// Threefry-2x32 (20 rounds, as jax_threefry_partitionable=True draws
// bits), keeps x0 ^ x1, puts its top 23 bits under the exponent of 1.0
// and forms the uniform max(lo, fma(f - 1, span, lo)).  In normal mode it
// returns sqrt(2) * erf_inv(u), clamped to [clip_lo, clip_hi] where NaN
// stays NaN, as torch.clamp does (truncated_normal's bounds; +-inf for a
// plain normal).
//
// The draw's arithmetic (the hash, XLA's float32 erf_inv over its own
// log1p, the uniform and the normal) lives once, in threefry.cuh, which
// ota_aggregate.cu's keyed reduction includes too: see there for how it
// equals jax.random's bits.
//
// The bf16 mode (threefry_normal_bf16) writes jax.random's bfloat16
// normals, 2 bytes a value: see normal_bf16_value in threefry.cuh.
//
// What bounds it: operations.  It reads nothing and writes 4 bytes per
// value; each value takes about 190 integer and float32 operations.  One
// thread per value, a grid-stride loop.
//
// C interface (loaded with ctypes): the entry point returns
// cudaGetLastError() after its launch, which the wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void threefry_draw(uint32_t k0, uint32_t k1, int64_t n,
                              int normal, float lo, float span,
                              float clip_lo, float clip_hi,
                              float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!normal) {
      out[i] = uniform_f32(k0, k1, i, lo, span);
      continue;
    }
    float z = normal_f32(k0, k1, i, lo, span);
    if (z < clip_lo) z = clip_lo;
    if (z > clip_hi) z = clip_hi;
    out[i] = z;
  }
}

__global__ void threefry_normal_bf16_kernel(uint32_t k0, uint32_t k1,
                                            int64_t n,
                                            __nv_bfloat16* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = __float2bfloat16_rn(normal_bf16_value(k0, k1, i));
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;  // SMs x resident blocks; grid-stride beyond
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

int threefry_draw_f32(uint32_t k0, uint32_t k1, int64_t n, int normal,
                      float lo, float span, float clip_lo, float clip_hi,
                      void* out, void* stream) {
  threefry_draw<<<grid_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n, normal, lo, span, clip_lo, clip_hi, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

int threefry_normal_bf16(uint32_t k0, uint32_t k1, int64_t n, void* out,
                         void* stream) {
  threefry_normal_bf16_kernel<<<grid_for(n), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

const char* threefry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
