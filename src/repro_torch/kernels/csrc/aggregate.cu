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
// What bounds it on this card: memory, and at LeNet size the launch.  It
// reads K * N * 4 bytes of codes and writes N * 4, (K + 1) * N * 4 in all:
// at K = 3 and LeNet's six leaves (266,610 elements) that is 4.3 MB, 1.3 us
// at 3.35 TB/s, while one launch and its ramp cost about 2 us.  One launch
// per leaf made six per round, four of them for leaves of 10 to 1,000
// elements.  So the kernel is grouped: one launch reduces every matrix of a
// round.  Its parameter struct carries, by value, a table of up to
// kMaxSegments segments (codes, coeff and out pointers, N, K, and whether
// the segment takes 16-byte vectors) and the prefix sum of their block
// counts; there is no host-to-device copy of the table (a pageable copy
// would synchronise the host).  Blocks are laid out segment after segment,
// and a block finds its segment by scanning the short prefix array, then
// runs a grid-stride loop over that segment alone.  A segment with N % 4 ==
// 0 and 16-byte aligned rows and out reads four contiguous elements per
// client as one 16-byte vector; any other takes one element per thread.
// Either way each byte streams once, the sum over K stays in registers and
// each output is stored once.  The TPU kernel's (256, 128) tile padding and
// its chunking exist for VMEM and are gone: nothing is padded and the
// ragged edge is masked.
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launch, which the wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 16;

// One (K, N) matrix of a group: codes row-major, coeff (K,), out (N,).
struct Segment {
  const void* codes;
  const float* coeff;
  float* out;
  int64_t n;
  int k;
  int vectorized;  // N % 4 == 0, codes and out 16-byte aligned
};

struct Group {
  Segment seg[kMaxSegments];
  int first_block[kMaxSegments + 1];  // filled by the launcher
  int count;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int x) { return __int2float_rn(x); }

template <typename T>
struct Vec4;
template <>
struct Vec4<float> { using type = float4; };
template <>
struct Vec4<int> { using type = int4; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
    aggregate_group_kernel(const __grid_constant__ Group g) {
  int s = 0;
  while (s + 1 < g.count && (int)blockIdx.x >= g.first_block[s + 1]) ++s;
  const Segment& seg = g.seg[s];
  const T* __restrict__ codes = static_cast<const T*>(seg.codes);
  const float* __restrict__ coeff = seg.coeff;
  float* __restrict__ out = seg.out;
  const int k = seg.k;
  const int64_t n = seg.n;
  const int64_t tid =
      (int64_t)(blockIdx.x - g.first_block[s]) * blockDim.x + threadIdx.x;
  const int64_t stride =
      (int64_t)(g.first_block[s + 1] - g.first_block[s]) * blockDim.x;
  if (seg.vectorized) {
    using V = typename Vec4<T>::type;
    for (int64_t i = tid; i < n / 4; i += stride) {
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
  } else {
    for (int64_t i = tid; i < n; i += stride) {
      float acc = 0.0f;
      for (int c = 0; c < k; ++c) {
        acc = __fmaf_rn(to_f32(codes[(int64_t)c * n + i]), __ldg(coeff + c),
                        acc);
      }
      out[i] = acc;
    }
  }
}

int blocks_for(const Segment& seg) {
  const int64_t work = seg.vectorized ? seg.n / 4 : seg.n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // SMs x resident blocks; grid-stride beyond
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

const void* kernel_of(int int32_codes) {
  return int32_codes ? reinterpret_cast<const void*>(aggregate_group_kernel<int>)
                     : reinterpret_cast<const void*>(aggregate_group_kernel<float>);
}

}  // namespace

extern "C" {

// The table's capacity and the struct's size, which the wrapper's ctypes
// mirror must match.
int aggregate_max_segments() { return kMaxSegments; }
int aggregate_group_bytes() { return (int)sizeof(Group); }

// One launch over group->count (1..kMaxSegments) non-empty segments, codes
// float32 (int32_codes = 0) or int32 (1); fills group->first_block.  The
// table comes as void*: Group has internal linkage, and a C entry point
// taking it would have too.
int weighted_aggregate_group(void* table, int int32_codes, void* stream) {
  Group* group = static_cast<Group*>(table);
  if (group->count < 1 || group->count > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  group->first_block[0] = 0;
  for (int s = 0; s < group->count; ++s)
    group->first_block[s + 1] =
        group->first_block[s] + blocks_for(group->seg[s]);
  const int grid = group->first_block[group->count];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int32_codes) {
    aggregate_group_kernel<int><<<grid, kThreads, 0, st>>>(*group);
  } else {
    aggregate_group_kernel<float><<<grid, kThreads, 0, st>>>(*group);
  }
  return (int)cudaGetLastError();
}

// out[0..5]: registers per thread, static shared bytes, dynamic shared
// bytes, local (spill) bytes per thread, threads per CTA, CTAs per SM of
// the grouped kernel for float32 (int32_codes = 0) or int32 codes.
int aggregate_attributes(int int32_codes, int* out) {
  const void* fn = kernel_of(int32_codes);
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

const char* aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
