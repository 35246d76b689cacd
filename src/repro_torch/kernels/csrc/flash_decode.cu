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
// kernels do not copy the Pallas block order: they visit the positions in
// another order and take the exponentials in base 2 (scores scaled by
// log2(e) / sqrt(D)), so they agree with the Pallas kernel within the
// reference's tolerance (tests/test_kernels.py: 1e-5 in float32; in
// bfloat16 within one rounding of the output), not to the bit.
//
// What bounds them on this card: memory.  Each cache position below
// valid_len is read once, 2 * D elements of k and v; at decode_32k
// (B = 128, S = 32,768) with Qwen2-0.5B's H = 2, G = 7, D = 64 that is
// 2.15 GB in bfloat16 (0.64 ms at 3.35 TB/s) against 15 GFLOP.  Both
// kernels stream the cache once and keep every intermediate on chip: one
// CTA per (b, h), valid_len read from device memory inside the kernel (no
// host sync), only positions below it loaded (through a cp.async ring; the
// tail past valid_len is zero-filled, not read), and the per-part softmax
// states merged through shared memory at the end (the flash-decoding
// merge), each (g, d) output written once.
//
// bfloat16: tensor cores (flash_decode_bf16_kernel).  On the CUDA cores
// the bf16 kernel was bound by its instruction stream, not its bytes: each
// group of D/8 lanes took G*8 FMAs per position for q.k and again for p.v,
// three shuffles per (position, head), and every lane of a group repeated
// the same G exponentials.  Now both products are mma.sync.m16n8k16 (bf16
// in, float32 accumulate) in FlashAttention-2's register layout:
//   * two warps, each with its own run of positions (16 at a time,
//     warp w taking the 16-position chunks c = w mod 2) and its own
//     four-stage cp.async ring of k and v rows (three steps in flight),
//     synchronised with __syncwarp only.  A CTA takes 32 KB of shared
//     memory at D = 64 and 64 KB at D = 128, so decode_32k's 256 CTAs run
//     in one wave.  More warps or deeper rings, with more bytes in flight
//     per SM, were slower (tools/kernel_variants.py times the ring depths
//     and warp counts in turns);
//   * scores S = Q K^T: A is q, the G heads padded with zero rows to 16 x D,
//     loaded once as bf16 *unscaled* (scaling q and rounding it back to bf16
//     would add an error of its own); the float32 scores are scaled after
//     the product.  B is k through ldmatrix (rows are positions, so the
//     non-transposed load gives the .col operand);
//   * the online softmax runs on the score fragment: each lane takes its
//     own elements, so each exponential is taken once; the row max reduces
//     over the quad (two shuffles), the row sum is kept per lane and
//     reduced once at the end.  Positions at or past valid_len are masked
//     explicitly (the zero-filled tail scores 0, not -inf);
//   * O = P V: the score fragment becomes the A operand with no trip
//     through shared memory, B is v through ldmatrix.trans.  P is split
//     into three bf16 parts, hi = bf16(p), mid = bf16(p - hi) and lo =
//     bf16(p - hi - mid), whose sum is the float32 p exactly, so every
//     product p * v is exact and only the float32 sums differ from the
//     plain version.  The contract (atol 1e-6, rtol 2^-7 against the
//     float32 plain version) needs that: one rounding of p to bf16
//     (relative error 2^-9 per weight) moves a bf16 output by more than one
//     rounding on long caches, and hi + lo (about 2^-17) still does where
//     a few positions' products cancel to an output near zero (D = 128,
//     G = 8, valid_len = 8 in tests/test_torch_cuda.py).  Since G <= 8,
//     rows 8..15 of the A operand are padding: mid goes there, so one mma
//     yields the hi product in accumulator rows 0..7 and the mid product in
//     rows 8..15; a second mma on the same v fragment adds lo into rows
//     0..7.  The rows are summed in float32 at the end;
//   * shared memory rows are D * 2 bytes; the 16-byte chunk c of row r is
//     stored at chunk c ^ (r % 8), on the cp.async side and the ldmatrix
//     side, so the 8 rows of one ldmatrix phase hit 8 different bank
//     groups.
//
// float32: CUDA cores (flash_decode_f32_kernel).  It runs at about 1.05x
// its byte bound already, and TF32 tensor cores (10-bit mantissa products)
// would break the float32 contract of 1e-5.  One CTA of 256 threads per
// (b, h); k and v tiles of 16 KB through a three-stage cp.async ring; a
// group of D / 8 lanes owns one position at a time, each lane eight of its
// dimensions, the group summing partial dot products with xor shuffles;
// each group keeps its own m, l and acc over the positions it visits.
//
// Splitting S across CTAs (for small B * H), TMA and wgmma are left for
// later.  Supported: D in {64, 128}, 1 <= G <= 8.
//
// C interface (loaded with ctypes): the entry point returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a
// shape it does not take, which the wrapper checks.  flash_decode_attributes
// reports a kernel's registers, shared and local memory and occupancy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;          // the Pallas kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// float32 kernel
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kTileBytes = 16384;          // one k or one v tile
constexpr int kSmemBytes = kStages * 2 * kTileBytes;
constexpr int kDimsPerLane = 8;

// bfloat16 kernel
constexpr int kWarps = 2;
constexpr int kBf16Threads = kWarps * 32;
constexpr int kRows = 16;                  // positions per warp step
constexpr int kBf16Stages = 4;            // each warp's cp.async ring

// the bf16 kernel's rings: 32 KB at D = 64, 64 KB at D = 128
template <int D>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return kBf16Stages * kWarps * 2 * kRows * D * 2;
}

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

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Merge the online-softmax states of kStates parts: state r of head g is
// ms[r * R + g], ls[r * R + g] and as[(r * R + g) * D + d].
template <int D, int G, int kStates, int R, typename T>
__device__ __forceinline__ void merge_states(const float* ms, const float* ls,
                                             const float* as, T* obh) {
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
    for (int r = 0; r < kStates; ++r) mx = fmaxf(mx, ms[r * R + g]);
    float den = 0.0f, num = 0.0f;
    for (int r = 0; r < kStates; ++r) {
      const float w = exp2f(ms[r * R + g] - mx);
      den = fmaf(ls[r * R + g], w, den);
      num = fmaf(as[(r * R + g) * D + d], w, num);
    }
    store(obh + g * D + d, num / fmaxf(den, 1e-30f));
  }
}

__device__ __forceinline__ int clamped_len(const int* valid_len, int S) {
  const int n = *valid_len;
  return n < 0 ? 0 : (n > S ? S : n);
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
    flash_decode_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ valid_len, int S, int H,
                            float qscale, float* __restrict__ out) {
  constexpr int kVec = 4;                          // floats per 16 bytes
  constexpr int kChunks = kDimsPerLane / kVec;     // 16-byte loads per row
  constexpr int kLanes = D / kDimsPerLane;         // lanes per position
  constexpr int kGroups = kThreads / kLanes;       // positions at a time
  constexpr int kRowBytes = D * 4;
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

  const int n = clamped_len(valid_len, S);
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
          (fill ? (int64_t)(s0 + row) : 0) * pos_stride * 4 + col * 16;
      cp_async16(ks + row * kRowBytes + col * 16, kbase + off, fill);
      cp_async16(vs + row * kRowBytes + col * 16, vbase + off, fill);
    }
  };

  // this lane's dimensions: chunk j covers (lane + kLanes * j) * kVec + e
  float qr[G][kDimsPerLane];
  float acc[G][kDimsPerLane];
  float m[G], l[G];
  const float* qbh = q + (int64_t)bh * G * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = (lane + kLanes * j) * kVec + e;
        qr[g][j * kVec + e] = qbh[g * D + d] * qscale;
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
        const float4 r = *reinterpret_cast<const float4*>(
            ks + row * kRowBytes + (lane + kLanes * j) * 16);
        kf[j * kVec] = r.x;
        kf[j * kVec + 1] = r.y;
        kf[j * kVec + 2] = r.z;
        kf[j * kVec + 3] = r.w;
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
          sc[u][g] += __shfl_xor_sync(kFull, sc[u][g], off);
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
        const float4 r = *reinterpret_cast<const float4*>(
            vs + row * kRowBytes + (lane + kLanes * j) * 16);
        vf[j * kVec] = r.x;
        vf[j * kVec + 1] = r.y;
        vf[j * kVec + 2] = r.z;
        vf[j * kVec + 3] = r.w;
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

  // the groups' states: ms[grp][g], ls[grp][g], as[grp][g][d]
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
  merge_states<D, G, kGroups, G>(ms, ls, as, out + (int64_t)bh * G * D);
}

template <int D, int G>
__global__ void __launch_bounds__(kBf16Threads, 2)
    flash_decode_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const int* __restrict__ valid_len, int S, int H,
                             float qscale, __nv_bfloat16* __restrict__ out) {
  constexpr int kRowBytes = D * 2;
  constexpr int kRowChunks = kRowBytes / 16;       // 16-byte chunks per row
  constexpr int kStepBytes = kRows * kRowBytes;    // k (or v) of one step
  constexpr int kStageBytes = 2 * kStepBytes;
  constexpr int kStages = kBf16Stages;
  constexpr int kKSteps = D / 16;                  // mma depth steps
  constexpr int kDimTiles = D / 8;                 // n8 tiles of the output
  constexpr int kLoads = kRows * kRowChunks / 32;  // cp.async per lane
  static_assert(kLoads * 32 == kRows * kRowChunks, "whole loads per lane");
  static_assert(kWarps * 8 * (D + 2) * 4 <= bf16_smem_bytes<D>(),
                "merge fits");
  static_assert(G <= 8, "the mid part of P takes rows 8..15");

  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;        // the mma fragment's row
                                                   // and column pair

  const int n = clamped_len(valid_len, S);
  const int n_chunks = (n + kRows - 1) / kRows;
  const int n_steps =
      n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;

  const int64_t pos_bytes = (int64_t)H * D * 2;    // bytes per position
  const unsigned char* kbase = reinterpret_cast<const unsigned char*>(
      k + ((int64_t)b * S * H + h) * D);
  const unsigned char* vbase = reinterpret_cast<const unsigned char*>(
      v + ((int64_t)b * S * H + h) * D);
  unsigned char* ring = smem + warp * kStages * kStageBytes;
  const unsigned ring_s =
      static_cast<unsigned>(__cvta_generic_to_shared(ring));

  // step j covers positions (j * kWarps + warp) * kRows + [0, kRows)
  auto load_step = [&](int j, int stage) {
    const int s0 = (j * kWarps + warp) * kRows;
    unsigned char* ks = ring + stage * kStageBytes;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = lane + 32 * i;
      const int row = c / kRowChunks, col = c % kRowChunks;
      const bool fill = s0 + row < n;
      const int64_t off =
          (fill ? (int64_t)(s0 + row) : 0) * pos_bytes + col * 16;
      const int dst = row * kRowBytes + ((col ^ (row & 7)) << 4);
      cp_async16(ks + dst, kbase + off, fill);
      cp_async16(ks + kStepBytes + dst, vbase + off, fill);
    }
  };

  // A operand of the scores: q row gid (zero past G), unscaled bf16;
  // qa[kk] = {k 2tig..2tig+1, k 2tig+8..2tig+9} of depth step kk
  uint32_t qa[kKSteps][2];
  {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + ((int64_t)bh * G + (gid < G ? gid : 0)) * D);
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      qa[kk][0] = gid < G ? qrow[8 * kk + tig] : 0u;
      qa[kk][1] = gid < G ? qrow[8 * kk + 4 + tig] : 0u;
    }
  }

  // ldmatrix row addresses, relative to a stage: for the scores lane L
  // gives position row nt * 8 + L % 8 at chunk 4 * kp + L / 8 (two depth
  // steps of one n8 tile); for P V position row (L / 8 % 2) * 8 + L % 8 at
  // chunk 2 * dp + L / 16 (two n8 tiles of the output)
  const int r8 = lane & 7;
  const unsigned k_row = r8 * kRowBytes;
  const unsigned v_row = kStepBytes + (((lane >> 3) & 1) * 8 + r8) * kRowBytes;

  float acc[kDimTiles][4];   // rows gid (hi, lo) and gid + 8 (mid) of O
#pragma unroll
  for (int t = 0; t < kDimTiles; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
  float m = kNegInf;         // the same in the 4 lanes of a quad
  float l = 0.0f;            // this lane's positions only

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load_step(st, st);
    cp_async_commit();
  }

  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait<kStages - 2>();
    __syncwarp();         // step j landed; step j - 1's stage is free
    if (j + kStages - 1 < n_steps)
      load_step(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned st = ring_s + (j % kStages) * kStageBytes;

    // scores of head gid at positions 2tig, 2tig + 1 of each n8 tile
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < kKSteps / 2; ++kp) {
        uint32_t bk[4];
        const unsigned chunk = (4 * kp + (lane >> 3)) ^ r8;
        ldmatrix_x4(st + nt * 8 * kRowBytes + k_row + (chunk << 4), bk);
        mma_bf16(s[nt], qa[2 * kp][0], 0u, qa[2 * kp][1], 0u, bk[0], bk[1]);
        mma_bf16(s[nt], qa[2 * kp + 1][0], 0u, qa[2 * kp + 1][1], 0u, bk[2],
                 bk[3]);
      }
    }

    // online softmax in base 2 over the step's 16 positions
    const int p0 = (j * kWarps + warp) * kRows + 2 * tig;
    float x[2][2];
    float mx = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[nt][e] = __fmul_rn(s[nt][e], qscale);
        if (p0 + nt * 8 + e < n) mx = fmaxf(mx, x[nt][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = exp2f(m - m_new);
    m = m_new;
    // A operands of P V, p = hi + mid + lo exactly: pa = {hi k 0..7,
    // mid k 0..7, hi k 8..15, mid k 8..15}, pl = {lo k 0..7, lo k 8..15}
    uint32_t pa[4], pl[2];
    float psum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float pa0 = p0 + nt * 8 < n ? exp2f(x[nt][0] - m_new) : 0.0f;
      const float pa1 = p0 + nt * 8 + 1 < n ? exp2f(x[nt][1] - m_new) : 0.0f;
      psum += pa0 + pa1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(pa0, pa1);
      const float2 hf = __bfloat1622float2(hi);
      const float r0 = pa0 - hf.x, r1 = pa1 - hf.y;      // exact
      const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
      const float2 mf = __bfloat1622float2(mid);
      pa[2 * nt] = bits(hi);
      pa[2 * nt + 1] = bits(mid);
      pl[nt] = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
    }
    l = l * corr + psum;
#pragma unroll
    for (int t = 0; t < kDimTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] *= corr;
    }
#pragma unroll
    for (int dp = 0; dp < kDimTiles / 2; ++dp) {
      uint32_t bv[4];
      const unsigned chunk = (2 * dp + (lane >> 4)) ^ r8;
      ldmatrix_x4_trans(st + v_row + (chunk << 4), bv);
      mma_bf16(acc[2 * dp], pa[0], pa[1], pa[2], pa[3], bv[0], bv[1]);
      mma_bf16(acc[2 * dp], pl[0], 0u, pl[1], 0u, bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], pa[0], pa[1], pa[2], pa[3], bv[2], bv[3]);
      mma_bf16(acc[2 * dp + 1], pl[0], 0u, pl[1], 0u, bv[2], bv[3]);
    }
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  __syncthreads();        // every ring is free: reuse it for the merge

  // the warps' states: ms[warp][row], ls[warp][row], as[warp][row][d]
  float* ms = reinterpret_cast<float*>(smem);
  float* ls = ms + kWarps * 8;
  float* as = ls + kWarps * 8;
  const int r = warp * 8 + gid;
  if (tig == 0) {
    ms[r] = m;
    ls[r] = l;
  }
#pragma unroll
  for (int t = 0; t < kDimTiles; ++t) {
    as[r * D + t * 8 + 2 * tig] = acc[t][0] + acc[t][2];
    as[r * D + t * 8 + 2 * tig + 1] = acc[t][1] + acc[t][3];
  }
  __syncthreads();
  merge_states<D, G, kWarps, 8>(ms, ls, as, out + (int64_t)bh * G * D);
}

// A kernel of one instantiation with its launch shape.
struct Config {
  const void* fn;
  int threads;
  int smem;
};

template <int D, int G>
Config config_of(bool bf16) {
  if (bf16)
    return {reinterpret_cast<const void*>(flash_decode_bf16_kernel<D, G>),
            kBf16Threads, bf16_smem_bytes<D>()};
  return {reinterpret_cast<const void*>(flash_decode_f32_kernel<D, G>),
          kThreads, kSmemBytes};
}

template <int D>
Config config_g(bool bf16, int G) {
  switch (G) {
    case 1: return config_of<D, 1>(bf16);
    case 2: return config_of<D, 2>(bf16);
    case 3: return config_of<D, 3>(bf16);
    case 4: return config_of<D, 4>(bf16);
    case 5: return config_of<D, 5>(bf16);
    case 6: return config_of<D, 6>(bf16);
    case 7: return config_of<D, 7>(bf16);
    case 8: return config_of<D, 8>(bf16);
    default: return {nullptr, 0, 0};
  }
}

// The instantiation for (bf16, D, G), its dynamic shared memory allowed
// once; fn is null for a shape it does not take.
int configured(int bf16, int D, int G, Config* out) {
  static bool done[2][2][9] = {};
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  *out = D == 64 ? config_g<64>(bf16 != 0, G) : config_g<128>(bf16 != 0, G);
  if (out->fn == nullptr) return (int)cudaErrorInvalidValue;
  bool& flag = done[bf16 != 0][D == 128][G];
  if (!flag) {
    cudaError_t err = cudaFuncSetAttribute(
        out->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, out->smem);
    // the bf16 kernel's CTAs per SM need the largest shared carveout
    if (err == cudaSuccess && bf16)
      err = cudaFuncSetAttribute(
          out->fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    flag = true;
  }
  return 0;
}

}  // namespace

extern "C" {

// q: (B, H, G, D); k, v: (B, S, H, D); out: (B, H, G, D), all dense, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1), 16-byte aligned.
// valid_len: one int32 on the card.  qscale = log2(e) / sqrt(D) in float32.
int flash_decode(const void* q, const void* k, const void* v,
                 const void* valid_len, int bf16, int B, int S, int H, int G,
                 int D, float qscale, void* out, void* stream) {
  Config cfg;
  const int err = configured(bf16, D, G, &cfg);
  if (err != 0) return err;
  if (B <= 0 || H <= 0) return 0;
  void* args[] = {&q, &k, &v, &valid_len, &S, &H, &qscale, &out};
  const cudaError_t launch = cudaLaunchKernel(
      cfg.fn, dim3(B * H), dim3(cfg.threads), args, cfg.smem,
      static_cast<cudaStream_t>(stream));
  if (launch != cudaSuccess) return (int)launch;
  return (int)cudaGetLastError();
}

// out[0..5]: registers per thread, static shared bytes, dynamic shared
// bytes, local (spill) bytes per thread, threads per CTA, CTAs per SM.
int flash_decode_attributes(int bf16, int D, int G, int* out) {
  Config cfg;
  int err = configured(bf16, D, G, &cfg);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, cfg.fn);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, cfg.fn, cfg.threads, cfg.smem);
  if (err != 0) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = cfg.smem;
  out[3] = (int)attr.localSizeBytes;
  out[4] = cfg.threads;
  out[5] = blocks;
  return 0;
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
