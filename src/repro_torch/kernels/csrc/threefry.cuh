// Threefry-2x32 draws of jax.random's streams, as device functions.
//
// The one copy of the draw's arithmetic: threefry.cu's draw kernels and
// the keyed OTA reduction of ota_aggregate.cu (which forms the receiver
// noise in the registers of the thread that adds it) both include this
// header, so the two cannot drift apart.  cuda_build.py hashes every
// csrc/*.cuh into each library's name, so an edit here rebuilds both.
//
// For the flat index i the draw hashes the counter pair (i >> 32,
// i & 0xFFFFFFFF) under the key (k0, k1) with Threefry-2x32 (20 rounds, as
// jax_threefry_partitionable=True draws bits), keeps x0 ^ x1, puts its top
// 23 bits under the exponent of 1.0 and forms the uniform
// max(lo, fma(f - 1, span, lo)); a normal is sqrt(2) * erf_inv(u).
//
// erf_inv is XLA's float32 ErfInv as XLA compiles it for the CPU (the
// reference's numbers): Giles' single-precision polynomial with the branch
// at w = 5, over XLA's own log1p (a rational approximation below |t| =
// 0.4142, a Cephes-style log above).  Where the compiled code has a fused
// multiply-add this code takes __fmaf_rn, and every other step is one
// correctly rounded float32 operation written as an intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never contracts: so the kernels, core/prng.py's plain version and
// jax.random agree to the bit.
//
// Cost per value, counted from this source (chip_smoke.py:threefry_work
// holds the count): the hash 20 rotates (one funnel shift each) and 21
// xors, which only the ALU pipe runs, and 27 adds, which the ALU or the
// FMA pipe (as IMAD) runs; the uniform 1 shift and 3 float32 operations;
// erf_inv about 40 float32 operations on the path a value takes.  The
// w >= 5 side of erf_inv (about 0.34% of uniforms) is a branch, so a warp
// whose lanes all stay below pays neither its square root nor its
// coefficient selects.  A bfloat16 normal takes the same hash and one of
// 128 values (bf16_normal_of_k), which threefry.cu tabulates once a
// block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage, as every other device function of csrc/: each library
// includes this header once.
namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// x + y as IMAD x * 1 + y, for the hash's adds: ptxas, left to choose,
// puts about 10 of a value's 27 adds on the ALU pipe (IADD3) beside the
// rotates and xors, which only that pipe runs; as IMAD all issue to the
// FMA pipe, which the hash leaves idle.  The 1 is blockDim.z, a value
// ptxas cannot fold: every kernel that includes this header launches
// 1-D blocks.
__device__ __forceinline__ uint32_t imad_add(uint32_t x, uint32_t y) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(blockDim.z),
      "r"(y));
  return d;
}

// Threefry-2x32, 20 rounds, of the counter pair (x0, x1); returns x0 ^ x1.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 = imad_add(x0, ks[0]);
  x1 = imad_add(x1, ks[1]);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 = imad_add(x0, x1);
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 = imad_add(x0, ks[(i + 1) % 3]);
    x1 = imad_add(x1, ks[(i + 2) % 3] + (uint32_t)(i + 1));
  }
  return x0 ^ x1;
}

// XLA's float32 log (Cephes logf) as compiled on the CPU.
__device__ float log_f32(float a) {
  const float ac = a < 0x1p-126f ? 0x1p-126f : a;   // NaN stays NaN
  const int bits = __float_as_int(ac);
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);  // [0.5, 1)
  const bool low = m < 0x1.6a09e6p-1f;
  const float x = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  if (low) e = __fsub_rn(e, 1.0f);
  const float z = __fmul_rn(x, x);
  const float zx = __fmul_rn(z, x);
  const float p1 = __fmaf_rn(__fmaf_rn(x, 0x1.204376p-4f, -0x1.d7a37p-4f), x,
                             0x1.de4a34p-4f);
  const float p2 = __fmaf_rn(__fmaf_rn(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x,
                             -0x1.555ca0p-3f);
  const float r1 = __fmaf_rn(p1, zx, p2);
  const float p3 = __fmaf_rn(__fmaf_rn(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x,
                             0x1.555554p-2f);
  const float r2 = __fmaf_rn(r1, zx, p3);
  const float y = __fmaf_rn(r2, zx, __fmul_rn(e, -0x1.bd0106p-13f));
  const float h = __fsub_rn(x, __fmul_rn(z, 0.5f));
  float out = __fmaf_rn(e, 0x1.63p-1f, __fadd_rn(h, y));
  if (a <= 0.0f) out = __int_as_float(0x7FC00000);
  if (a == 0.0f) out = -INFINITY;
  if (a == INFINITY) out = INFINITY;
  return out;
}

// XLA's float32 log1p as compiled on the CPU.
__device__ float log1p_f32(float t) {
  if (!(fabsf(t) < 0x1.a8279ap-2f)) return log_f32(__fadd_rn(t, 1.0f));
  const float t2 = __fmul_rn(t, t);
  const float den_c[6] = {0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
                          0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};
  const float num_c[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f,
                          0x1.de9738p+4f,  0x1.e798ecp+5f, 0x1.c8e75ap+5f,
                          0x1.40a202p+4f};
  float den = 1.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) den = __fmaf_rn(den, t, den_c[i]);
  float num = num_c[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) num = __fmaf_rn(num, t, num_c[i]);
  const float d = __fsub_rn(__fmul_rn(__fmul_rn(t, t2), __fdiv_rn(num, den)),
                            __fmul_rn(t2, 0.5f));
  return __fadd_rn(t, d);
}

// Giles' polynomial in w, from its two leading coefficients on.
template <int N>
__device__ __forceinline__ float erf_inv_poly(float w, const float (&c)[N]) {
  float p = __fmaf_rn(w, c[0], c[1]);
#pragma unroll
  for (int i = 2; i < N; ++i) p = __fmaf_rn(w, p, c[i]);
  return p;
}

// XLA's float32 ErfInv as compiled on the CPU.  XLA selects between the
// two sides of w = 5 after computing both; a side's value does not depend
// on the other, so taking only the chosen one gives the same bits.
__device__ float erf_inv_f32(float x) {
  const float lt5_c[9] = {
      0x1.e2cb1p-26f,  0x1.70966cp-22f, -0x1.d8e6aep-19f,
      -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
      -0x1.11c9dep-8f, 0x1.f91ec6p-3f,  0x1.805c5ep+0f};
  const float ge5_c[9] = {
      -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
      -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
      0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
  const float lp = log1p_f32(__fmul_rn(x, -x));      // -w
  float p;
  if (__builtin_expect(lp > -5.0f, 1)) {
    p = erf_inv_poly(__fsub_rn(-2.5f, lp), lt5_c);
  } else {   // w >= 5, or a NaN
    p = erf_inv_poly(__fadd_rn(__fsqrt_rn(-lp), -3.0f), ge5_c);
  }
  if (fabsf(x) == 1.0f) p = INFINITY;
  return __fmul_rn(x, p);
}

// The uniform of the hash `bits`: max(lo, fma(f, span, lo)), f in [0, 1)
// from its top 23 bits; a NaN would stay NaN (never drawn).
__device__ __forceinline__ float uniform_of_bits(uint32_t bits, float lo,
                                                 float span) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = __fmaf_rn(f, span, lo);
  return u < lo ? lo : u;
}

// sqrt(2) * erf_inv(u), unclamped.
__device__ __forceinline__ float normal_of_uniform(float u) {
  return __fmul_rn(erf_inv_f32(u), 0x1.6a09e6p+0f);
}

// The uniform of flat index i.
__device__ __forceinline__ float uniform_f32(uint32_t k0, uint32_t k1,
                                             int64_t i, float lo,
                                             float span) {
  return uniform_of_bits(threefry_bits(k0, k1, (uint32_t)(i >> 32),
                                       (uint32_t)(i & 0xFFFFFFFF)),
                         lo, span);
}

// The normal of flat index i: sqrt(2) * erf_inv(u), unclamped.
__device__ __forceinline__ float normal_f32(uint32_t k0, uint32_t k1,
                                            int64_t i, float lo, float span) {
  return normal_of_uniform(uniform_f32(k0, k1, i, lo, span));
}

// jax.random's bfloat16 normal of the 7-bit k, as the float32 value of a
// bf16: bf16 has 7 mantissa bits, so the draw takes the low byte of the
// hash and k = byte >> 1 makes the exact uniform u = k / 64 - 255 / 256
// (the bf16 span 1 - lo rounds to 2); the normal is
// bf16(bf16(erf_inv(u)) * 1.4140625), sqrt(2) rounded to bf16.
__device__ __forceinline__ float bf16_normal_of_k(uint32_t k) {
  const float lo = -0x1.fep-1f;                     // -255 / 256
  const float u = fmaxf(__fmaf_rn((float)k, 0x1p-6f, lo), lo);   // exact
  const float e = __bfloat162float(__float2bfloat16_rn(erf_inv_f32(u)));
  return __fmul_rn(e, 0x1.6ap+0f);   // exact: two 8-bit significands
}

}  // namespace
