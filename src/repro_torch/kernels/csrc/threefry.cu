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
// normals, 2 bytes a value.  Such a normal is one of 128 values, chosen by
// bits 1-7 of the hash: each block tabulates them once in shared memory
// from the header's own bf16_normal_of_k (erf_inv_f32, the bf16 rounding,
// the product by 1.4140625), so a value is a hash, one lookup and its
// share of a store.
//
// What bounds it: operations.  It reads nothing and writes 4 (or 2) bytes
// a value, but the hash's 20 rotates and 21 xors run only on the ALU pipe
// (64 lanes per SM per clock, half the float32 lanes) and its 27 adds
// there or on the FMA pipe; a normal's erf_inv adds about 40 float32
// operations (chip_smoke.py:threefry_work counts them, threefry_bound_ms
// turns them into the least time: the ALU pipe bounds the bf16 draw and
// the uniform, the issue rate the normals).  The design spends as few
// instructions beyond them as it can: the header issues the hash's adds
// as IMAD on the FMA pipe; where the draw fills the card's resident
// threads, each thread draws groups of kF32PerThread (kBf16PerThread)
// consecutive values, which share the counter's high word, so the 64-bit
// index arithmetic is done once a group, and stores a group as one
// 16-byte vector; a smaller draw takes one value a thread, since one
// wave of more, shorter threads hides the hash's latency better.  The
// grid is at most the resident threads, each walking groups a grid
// apart; the ragged last group (n not a multiple of the group) is drawn
// whole and stored value by value below n.
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launch, which the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
// consecutive values a thread draws and stores together where the draw
// fills the card's resident threads with groups: 4 float32 or 8 bf16
// values make one 16-byte store (each a power of two, so a group never
// straddles a change of the counter's high word); a smaller draw takes
// one value a thread (one wave of more, shorter threads runs faster)
constexpr int kF32PerThread = 4;
constexpr int kBf16PerThread = 8;

// An aligned vector of Bytes bytes, stored in one instruction.
template <int Bytes> struct Chunk;
template <> struct Chunk<2> { using type = unsigned short; };
template <> struct Chunk<4> { using type = unsigned int; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<16> { using type = uint4; };

// Count values of type T, stored as one vector of their bytes.
template <typename T, int Count>
union Group {
  typename Chunk<sizeof(T) * Count>::type chunk;
  T v[Count];
};

// Draws n values into out, G a group: each thread's groups a grid apart,
// each stored as one vector, but for the ragged last group (n % G
// values), stored value by value below n.  draw(i0) gives the group from
// flat index i0, a multiple of G.
template <typename T, int G, typename Draw>
__device__ __forceinline__ void draw_all(int64_t n, T* __restrict__ out,
                                         Draw draw) {
  using V = typename Chunk<sizeof(T) * G>::type;
  const int64_t groups = (n + G - 1) / G;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i0 = g * G;
    const Group<T, G> vals = draw(i0);
    if (i0 + G <= n) {
      reinterpret_cast<V*>(out + i0)[0] = vals.chunk;
      continue;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (i0 + j < n) out[i0 + j] = vals.v[j];
    }
  }
}

template <bool Normal, int G>
__global__ void threefry_draw(uint32_t k0, uint32_t k1, int64_t n, float lo,
                              float span, float clip_lo, float clip_hi,
                              float* __restrict__ out) {
  draw_all<float, G>(n, out, [&](int64_t i0) {
    const uint32_t hi = (uint32_t)(i0 >> 32), base = (uint32_t)i0;
    Group<float, G> vals;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float u = uniform_of_bits(threefry_bits(k0, k1, hi, base + j),
                                      lo, span);
      if constexpr (Normal) {
        float z = normal_of_uniform(u);
        if (z < clip_lo) z = clip_lo;
        if (z > clip_hi) z = clip_hi;
        vals.v[j] = z;
      } else {
        vals.v[j] = u;
      }
    }
    return vals;
  });
}

// The table holds each value as the float32 of its bf16, whose high half
// is the bf16's bits: 128 words, one a bank four times over (bf16 bits two
// to a word issue fewer instructions but measured 1% slower).  Needs
// kThreads >= 128: the block's first 128 threads fill it.
template <int G>
__global__ void threefry_normal_bf16_kernel(uint32_t k0, uint32_t k1,
                                            int64_t n,
                                            unsigned short* __restrict__ out) {
  __shared__ float table[128];
  if (threadIdx.x < 128) {
    table[threadIdx.x] = __bfloat162float(
        __float2bfloat16_rn(bf16_normal_of_k(threadIdx.x)));
  }
  __syncthreads();
  draw_all<unsigned short, G>(n, out, [&](int64_t i0) {
    const uint32_t hi = (uint32_t)(i0 >> 32), base = (uint32_t)i0;
    Group<unsigned short, G> vals;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const uint32_t bits = threefry_bits(k0, k1, hi, base + j);
      vals.v[j] = __float_as_uint(table[(bits & 0xFFu) >> 1]) >> 16;
    }
    return vals;
  });
}

static_assert(kThreads >= 128, "the bf16 table takes 128 threads to fill");

// The card's resident threads: SMs x threads an SM.
int64_t resident_threads() {
  int dev = 0, sms = 132, per_sm = 2048;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                           dev);
  }
  return (int64_t)sms * per_sm;
}

// The values a thread draws as one group in a draw of n in `mode`: a
// group of kF32PerThread (kBf16PerThread) where the card's `resident`
// threads would each draw at least one, else 1.
int group_for(int mode, int64_t n, int64_t resident) {
  if (n <= resident) return 1;
  return mode == 2 ? kBf16PerThread : kF32PerThread;
}

// Blocks for n values G a thread: a thread a group, at most the card's
// resident threads; beyond, threads walk the groups a grid apart.
int grid_for(int64_t n, int g, int64_t resident) {
  int64_t blocks = ((n + g - 1) / g + kThreads - 1) / kThreads;
  if (blocks > resident / kThreads) blocks = resident / kThreads;
  return blocks < 1 ? 1 : (int)blocks;
}

// The kernel of `mode` (0 uniform, 1 normal, 2 bf16 normal) at group g.
const void* kernel_of(int mode, int g) {
  if (mode == 2) {
    return g == 1 ? reinterpret_cast<const void*>(
                        threefry_normal_bf16_kernel<1>)
                  : reinterpret_cast<const void*>(
                        threefry_normal_bf16_kernel<kBf16PerThread>);
  }
  if (g == 1) {
    return mode ? reinterpret_cast<const void*>(threefry_draw<true, 1>)
                : reinterpret_cast<const void*>(threefry_draw<false, 1>);
  }
  return mode ? reinterpret_cast<const void*>(
                    threefry_draw<true, kF32PerThread>)
              : reinterpret_cast<const void*>(
                    threefry_draw<false, kF32PerThread>);
}

// Launches the kernel of `mode` on n values with `args`.
int launch(int mode, int64_t n, void** args, void* stream) {
  const int64_t resident = resident_threads();
  const int g = group_for(mode, n, resident);
  const cudaError_t launched = cudaLaunchKernel(
      kernel_of(mode, g), dim3(grid_for(n, g, resident)), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

}  // namespace

extern "C" {

// The values a thread draws as one group in a draw of n in `mode`.
int threefry_group(int mode, int64_t n) {
  return group_for(mode, n, resident_threads());
}

int threefry_draw_f32(uint32_t k0, uint32_t k1, int64_t n, int normal,
                      float lo, float span, float clip_lo, float clip_hi,
                      void* out, void* stream) {
  void* args[] = {&k0, &k1, &n, &lo, &span, &clip_lo, &clip_hi, &out};
  return launch(normal ? 1 : 0, n, args, stream);
}

int threefry_normal_bf16(uint32_t k0, uint32_t k1, int64_t n, void* out,
                         void* stream) {
  void* args[] = {&k0, &k1, &n, &out};
  return launch(2, n, args, stream);
}

// out[0..5]: registers per thread, static shared bytes, dynamic shared
// bytes, local (spill) bytes per thread, threads per CTA, CTAs per SM of
// the kernel that draws n values in `mode`.
int threefry_attributes(int mode, int64_t n, int* out) {
  const void* fn = kernel_of(mode, threefry_group(mode, n));
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

const char* threefry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
