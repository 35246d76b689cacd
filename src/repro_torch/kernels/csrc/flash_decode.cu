// One-token grouped-query decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_decode.py:flash_decode_pallas (the Pallas
// kernel _kernel) on the path kernels/ops.py:flash_decode.  For every
// batch row b and kv-head h, the G query heads that share h attend over the
// cache positions s < valid_len:
//
//     out[b, h, g, :] = sum_s softmax_s(q[b,h,g,:] . k[b,s,h,:] / sqrt(D))
//                       * v[b, s, h, :]
//
// with q (B, H, G, D) and k, v (B, S, H, D), all float32 or all bfloat16,
// computed in float32 and stored in q's type.  As in the Pallas kernel, the
// softmax is an online one (a running max m, denominator l and weighted sum
// acc in float32), positions at or past valid_len weigh nothing, and the
// denominator is floored at 1e-30, so valid_len = 0 gives zeros.  The
// kernel does not copy the Pallas block order: it visits the positions in
// another order and takes the exponentials in base 2 (the scale
// log2(e) / sqrt(D) folded into q), so it agrees with the Pallas kernel
// within the reference's tolerance (tests/test_kernels.py: 1e-5 in
// float32), not to the bit.
//
// What bounds it on this card: memory.  Each cache position below
// valid_len is read once, 2 * D elements of k and v; at decode_32k
// (B = 128, S = 32,768) with Qwen2-0.5B's H = 2, G = 7, D = 64 that is
// 2.15 GB in bfloat16, 0.64 ms at 3.35 TB/s, against 15 GFLOP of float32
// multiply-adds (0.22 ms on the CUDA cores).  The design streams the cache
// once and keeps every intermediate on chip:
//
//   * one CTA of 256 threads per (b, h); valid_len is read from device
//     memory inside the kernel (no host sync), and only the tiles that hold
//     positions below it are loaded;
//   * k and v arrive in tiles of 16 KB each through a three-stage cp.async
//     ring in shared memory, so two tiles are in flight while one is used;
//     positions past valid_len in the last tile are zero-filled, not read;
//   * a group of D / 8 lanes owns one position at a time, each lane eight
//     of its D dimensions (one or two 16-byte shared-memory loads, which
//     each quarter-warp takes from 128 contiguous bytes: no bank conflict);
//     the group sums its partial dot products with xor shuffles, so every
//     lane holds the G scores of its position;
//   * each group keeps its own m, l and acc (its dimensions of acc) in
//     registers over all the positions it visits, rescaling once per tile;
//   * at the end the 256 / (D / 8) groups' states are merged through shared
//     memory (the flash-decoding merge), and each (g, d) output is written
//     once.
//
// Splitting S across CTAs (for small B * H), TMA and wgmma are left for
// later.  Supported: D in {64, 128}, 1 <= G <= 8.
//
// C interface (loaded with ctypes): the entry point returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a
// shape it does not take, which the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kTileBytes = 16384;          // one k or one v tile
constexpr int kSmemBytes = kStages * 2 * kTileBytes;
constexpr float kNegInf = -1e30f;          // the Pallas kernel's NEG_INF
constexpr int kDimsPerLane = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 16 : 0;     // 0: write 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes -> 4 floats (float32) or 8 floats (bfloat16)
__device__ __forceinline__ void unpack16(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack16(const uint4& r, float* f,
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ valid_len, int S, int H,
                        float qscale, T* __restrict__ out) {
  constexpr int kVec = 16 / sizeof(T);             // elements per 16 bytes
  constexpr int kChunks = kDimsPerLane / kVec;     // 16-byte loads per row
  constexpr int kLanes = D / kDimsPerLane;         // lanes per position
  constexpr int kGroups = kThreads / kLanes;       // positions at a time
  constexpr int kRowBytes = D * sizeof(T);
  constexpr int kRowChunks = kRowBytes / 16;
  constexpr int kTile = kTileBytes / kRowBytes;    // positions per tile
  constexpr int kPerGroup = kTile / kGroups;       // per group per tile
  constexpr int kTileChunks = kTile * kRowChunks;
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "a group within a warp");
  static_assert(kTile % kGroups == 0, "whole tiles per group");
  static_assert(kGroups * G * (D + 2) * 4 <= kSmemBytes, "merge fits");

  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int grp = tid / kLanes;

  int n = *valid_len;
  n = n < 0 ? 0 : (n > S ? S : n);
  const int n_tiles = (n + kTile - 1) / kTile;

  const int64_t pos_stride = (int64_t)H * D;       // elements per position
  const unsigned char* kbase = reinterpret_cast<const unsigned char*>(
      k + ((int64_t)b * S * H + h) * D);
  const unsigned char* vbase = reinterpret_cast<const unsigned char*>(
      v + ((int64_t)b * S * H + h) * D);

  auto load_tile = [&](int tile, int stage) {
    unsigned char* ks = smem + stage * 2 * kTileBytes;
    unsigned char* vs = ks + kTileBytes;
    const int s0 = tile * kTile;
    for (int c = tid; c < kTileChunks; c += kThreads) {
      const int row = c / kRowChunks;
      const int col = c % kRowChunks;
      const bool fill = s0 + row < n;
      const int64_t off =
          (fill ? (int64_t)(s0 + row) : 0) * pos_stride * sizeof(T) + col * 16;
      cp_async16(ks + row * kRowBytes + col * 16, kbase + off, fill);
      cp_async16(vs + row * kRowBytes + col * 16, vbase + off, fill);
    }
  };

  // this lane's dimensions: chunk j covers (lane + kLanes * j) * kVec + e
  float qr[G][kDimsPerLane];
  float acc[G][kDimsPerLane];
  float m[G], l[G];
  const T* qbh = q + (int64_t)bh * G * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = (lane + kLanes * j) * kVec + e;
        qr[g][j * kVec + e] = to_float(qbh[g * D + d]) * qscale;
        acc[g][j * kVec + e] = 0.0f;
      }
    }
    m[g] = kNegInf;
    l[g] = 0.0f;
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();      // tile t landed; tile t - 1's stage is free
    if (t + kStages - 1 < n_tiles)
      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();

    const unsigned char* ks = smem + (t % kStages) * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;
    float sc[kPerGroup][G];
#pragma unroll
    for (int u = 0; u < kPerGroup; ++u) {
      const int row = grp + kGroups * u;
      float kf[kDimsPerLane];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const uint4 r = *reinterpret_cast<const uint4*>(
            ks + row * kRowBytes + (lane + kLanes * j) * 16);
        unpack16(r, kf + j * kVec, T());
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) dot = fmaf(qr[g][e], kf[e], dot);
        sc[u][g] = dot;
      }
    }
#pragma unroll
    for (int u = 0; u < kPerGroup; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);
      }
    }
    // online softmax in base 2 over this group's positions of the tile
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < kPerGroup; ++u) {
        if (t * kTile + grp + kGroups * u < n) m_new = fmaxf(m_new, sc[u][g]);
      }
      const float corr = exp2f(m[g] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < kPerGroup; ++u) {
        const bool ok = t * kTile + grp + kGroups * u < n;
        const float p = ok ? exp2f(sc[u][g] - m_new) : 0.0f;
        sc[u][g] = p;
        psum += p;
      }
      m[g] = m_new;
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kPerGroup; ++u) {
      const int row = grp + kGroups * u;
      float vf[kDimsPerLane];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const uint4 r = *reinterpret_cast<const uint4*>(
            vs + row * kRowBytes + (lane + kLanes * j) * 16);
        unpack16(r, vf + j * kVec, T());
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e)
          acc[g][e] = fmaf(sc[u][g], vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();        // the ring is free: reuse it for the merge

  // merge the groups' states: ms[grp][g], ls[grp][g], as[grp][g][d]
  float* ms = reinterpret_cast<float*>(smem);
  float* ls = ms + kGroups * G;
  float* as = ls + kGroups * G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      ms[grp * G + g] = m[g];
      ls[grp * G + g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = (lane + kLanes * j) * kVec + e;
        as[(grp * G + g) * D + d] = acc[g][j * kVec + e];
      }
    }
  }
  __syncthreads();
  T* obh = out + (int64_t)bh * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
    for (int r = 0; r < kGroups; ++r) mx = fmaxf(mx, ms[r * G + g]);
    float den = 0.0f, num = 0.0f;
    for (int r = 0; r < kGroups; ++r) {
      const float w = exp2f(ms[r * G + g] - mx);
      den = fmaf(ls[r * G + g], w, den);
      num = fmaf(as[(r * G + g) * D + d], w, num);
    }
    store(obh + g * D + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* valid_len,
           int n_bh, int S, int H, float qscale, void* out,
           cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T, D, G>;
  static bool configured = false;         // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  kernel<<<n_bh, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid_len), S, H,
      qscale, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(int G, const void* q, const void* k, const void* v,
             const void* vl, int n_bh, int S, int H, float qscale, void* out,
             cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, vl, n_bh, S, H, qscale, out, st);
    case 2: return launch<T, D, 2>(q, k, v, vl, n_bh, S, H, qscale, out, st);
    case 3: return launch<T, D, 3>(q, k, v, vl, n_bh, S, H, qscale, out, st);
    case 4: return launch<T, D, 4>(q, k, v, vl, n_bh, S, H, qscale, out, st);
    case 5: return launch<T, D, 5>(q, k, v, vl, n_bh, S, H, qscale, out, st);
    case 6: return launch<T, D, 6>(q, k, v, vl, n_bh, S, H, qscale, out, st);
    case 7: return launch<T, D, 7>(q, k, v, vl, n_bh, S, H, qscale, out, st);
    case 8: return launch<T, D, 8>(q, k, v, vl, n_bh, S, H, qscale, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_d(int D, int G, const void* q, const void* k, const void* v,
             const void* vl, int n_bh, int S, int H, float qscale, void* out,
             cudaStream_t st) {
  if (D == 64) return launch_g<T, 64>(G, q, k, v, vl, n_bh, S, H, qscale, out, st);
  if (D == 128) return launch_g<T, 128>(G, q, k, v, vl, n_bh, S, H, qscale, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: (B, H, G, D); k, v: (B, S, H, D); out: (B, H, G, D), all dense, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1), 16-byte aligned.
// valid_len: one int32 on the card.  qscale = log2(e) / sqrt(D) in float32.
int flash_decode(const void* q, const void* k, const void* v,
                 const void* valid_len, int bf16, int B, int S, int H, int G,
                 int D, float qscale, void* out, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(D, G, q, k, v, valid_len, B * H, S, H,
                                   qscale, out, st);
  return launch_d<float>(D, G, q, k, v, valid_len, B * H, S, H, qscale, out,
                         st);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
