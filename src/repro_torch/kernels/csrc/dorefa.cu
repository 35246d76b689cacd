// DoReFa uplink quantizer kernels for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of repro/kernels/dorefa.py:
//
//   quantize_codes      <- quantize_codes_pallas      (_quantize_kernel)
//       code[i] = int32(rint(a * clip(x[i] / max(s, 1e-12), -1, 1)))
//   dequantize_codes    <- dequantize_codes_pallas    (_dequantize_kernel)
//       out[i]  = f32(code[i]) * (s * inv_a)
//   quantize_dequantize <- quantize_dequantize_pallas (_qdq_kernel)
//       out[i]  = rint(a * clip(x[i] / s', -1, 1)) * (s' * inv_a),
//       s' = max(s, 1e-12), stored in the input's type
//     and its float32 mode with the error-feedback residual,
//       res[i]  = fma(c[i], -(s' * inv_a), x[i]),  c[i] the rounded level,
//     the one rounding XLA's CPU contracts the reference's adj - q to
//
// with a = 2^b - 1 rounded to float32 and inv_a = 1 / a rounded to float32,
// both computed by the wrapper on the host.  These are the roundings the
// Pallas kernels get as XLA compiles them: with a static bit width, `a` is
// a constant and XLA rewrites `x / a` as `x * fl(1/a)` and reassociates the
// scalar product `(r * fl(1/a)) * s` into `r * (s * fl(1/a))`; the division
// by the traced scale stays a true division.  Every step below is one
// explicitly rounded operation (no fused multiply-add but the residual's,
// no approximate division), so the three kernels equal their plain PyTorch
// versions, and the Pallas kernels in interpret mode, to the bit.
//
// float -> int32 is __float2int_rn: round half to even, like jnp.round,
// and saturating like XLA's convert (b = 31 and 32 give +-2^31 codes
// clamped to 2147483647 / -2147483648); a NaN gives code 0, as XLA's
// convert gives it.  The scale is read from device memory, so a caller
// never syncs to hand it over.
//
// Non-finite values go through as in the reference, whose max and clip
// propagate NaN: the scale floor and the clamp are comparisons that leave
// a NaN as it is (fmaxf / fminf would drop it), so a NaN element or scale
// gives a NaN output (and code 0), never a finite value that hides it.
//
// What bounds them on this card: memory.  Each element is read once (4 B,
// or 2 B for bf16) and written once (4 B): 8 B per float32 element, 2.50 us
// for 2^20 elements at 3.35 TB/s; the arithmetic (a divide, three
// multiplies, a clamp and a rounding) is far below the float32 peak.  The
// TPU kernels' (256, 128) tiles exist for VMEM and are gone: quantize_codes
// writes the zero codes of the reference's tile padding itself (elements
// n .. n_out - 1), so no padded copy of x exists.
//
// All three move whole 16-byte vectors: each thread takes 4 float32, 8
// bf16 or 4 int32 code elements per vector, two vectors in flight per
// iteration of a grid-stride loop (kVectorsPerThread sizes the grid: two
// vectors per thread beat one and four in a sweep of each kernel), and
// stores its outputs as 16-byte vectors too: int4 codes, the fused values
// in x's own type, or float4 dequantized values; the zero codes past n
// are int4 stores as well.  With one 4-byte element per thread they ran
// at 2.3-2.5x their byte bound.  The input may be a view at any element
// offset, so it need not start on a 16-byte boundary: the elements before
// its first boundary (the head) and after its last whole vector (the
// tail) take the scalar path inside the kernel, and where that shift
// leaves a vector's outputs off their own 16-byte boundary they are stored
// one by one.  The input is never copied and no offset is refused.  The
// arithmetic per element is the same on every path, so an output does not
// depend on which path took its element.
//
// C interface (loaded with ctypes): every entry point returns
// cudaGetLastError() after its launch, which the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 16-byte vectors of x per thread in the grid of the two vector kernels
constexpr int kVectorsPerThread = 2;

__device__ __forceinline__ float load_f32(const float* x, int64_t i) {
  return x[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* x, int64_t i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ void store(float* out, int64_t i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* out, int64_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// max(s, 1e-12) keeping a NaN scale.
__device__ __forceinline__ float floored(float s) {
  return s < 1e-12f ? 1e-12f : s;
}

// a * clip(x / s, -1, 1), each step rounded once; a NaN stays NaN.
__device__ __forceinline__ float scaled(float x, float s, float a) {
  float xn = __fdiv_rn(x, s);
  xn = xn < -1.0f ? -1.0f : (xn > 1.0f ? 1.0f : xn);
  return __fmul_rn(a, xn);
}

// XLA's float -> int32 convert: round half to even, saturating, NaN -> 0.
__device__ __forceinline__ int to_code(float r) {
  return r != r ? 0 : __float2int_rn(r);
}

// DoReFa code of one element.
__device__ __forceinline__ int code_of(float x, float s, float a) {
  return to_code(scaled(x, s, a));
}

// The codes of one 16-byte vector of x: 4 float32 or 8 bf16 elements.
__device__ __forceinline__ void vector_codes(const uint4& r, float s, float a,
                                             int (&c)[4], float) {
  c[0] = code_of(__uint_as_float(r.x), s, a);
  c[1] = code_of(__uint_as_float(r.y), s, a);
  c[2] = code_of(__uint_as_float(r.z), s, a);
  c[3] = code_of(__uint_as_float(r.w), s, a);
}

__device__ __forceinline__ void vector_codes(const uint4& r, float s, float a,
                                             int (&c)[8], __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    c[2 * i] = code_of(f.x, s, a);
    c[2 * i + 1] = code_of(f.y, s, a);
  }
}

// Quantize -> dequantize of one element, in float32.
__device__ __forceinline__ float qdq_of(float x, float s, float a,
                                        float step) {
  return __fmul_rn(rintf(scaled(x, s, a)), step);
}

// Quantize -> dequantize of one float32 element and its residual
// x - c * step as one fused multiply-add.
__device__ __forceinline__ float2 qdq_residual_of(float x, float s, float a,
                                                  float step) {
  const float c = rintf(scaled(x, s, a));
  return make_float2(__fmul_rn(c, step), __fmaf_rn(c, -step, x));
}

// The fused outputs and residuals of one 16-byte vector of float32 x.
__device__ __forceinline__ void vector_qdq_residual(const uint4& r, float s,
                                                    float a, float step,
                                                    uint4& q, uint4& res) {
  const float2 e0 = qdq_residual_of(__uint_as_float(r.x), s, a, step);
  const float2 e1 = qdq_residual_of(__uint_as_float(r.y), s, a, step);
  const float2 e2 = qdq_residual_of(__uint_as_float(r.z), s, a, step);
  const float2 e3 = qdq_residual_of(__uint_as_float(r.w), s, a, step);
  q = make_uint4(__float_as_uint(e0.x), __float_as_uint(e1.x),
                 __float_as_uint(e2.x), __float_as_uint(e3.x));
  res = make_uint4(__float_as_uint(e0.y), __float_as_uint(e1.y),
                   __float_as_uint(e2.y), __float_as_uint(e3.y));
}

// The fused outputs of one 16-byte vector of x, in x's type.
__device__ __forceinline__ uint4 vector_qdq(const uint4& r, float s, float a,
                                            float step, float) {
  return make_uint4(__float_as_uint(qdq_of(__uint_as_float(r.x), s, a, step)),
                    __float_as_uint(qdq_of(__uint_as_float(r.y), s, a, step)),
                    __float_as_uint(qdq_of(__uint_as_float(r.z), s, a, step)),
                    __float_as_uint(qdq_of(__uint_as_float(r.w), s, a, step)));
}

__device__ __forceinline__ uint4 vector_qdq(const uint4& r, float s, float a,
                                            float step, __nv_bfloat16) {
  uint4 o;
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
  __nv_bfloat162* g = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    g[i] = __floats2bfloat162_rn(qdq_of(f.x, s, a, step),
                                 qdq_of(f.y, s, a, step));
  }
  return o;
}

// Dequantized values of one int4 vector of codes, as float bits.
__device__ __forceinline__ uint4 vector_dequant(const int4& c, float step) {
  return make_uint4(__float_as_uint(__fmul_rn(__int2float_rn(c.x), step)),
                    __float_as_uint(__fmul_rn(__int2float_rn(c.y), step)),
                    __float_as_uint(__fmul_rn(__int2float_rn(c.z), step)),
                    __float_as_uint(__fmul_rn(__int2float_rn(c.w), step)));
}

// Store one 16-byte vector of T at dst: one 16-byte store when dst is
// 16-byte aligned, else element by element.
template <typename T>
__device__ __forceinline__ void store_vector(T* dst, const uint4& v,
                                             bool aligned) {
  if (aligned) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = e[i];
  }
}

// Store kVec codes at dst: int4 stores when dst is 16-byte aligned.
template <int kVec>
__device__ __forceinline__ void store_codes(int* dst, const int (&c)[kVec],
                                            bool aligned) {
  if (aligned) {
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      *reinterpret_cast<int4*>(dst + i) =
          make_int4(c[i], c[i + 1], c[i + 2], c[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = c[i];
  }
}

// Elements before p's first 16-byte boundary (p element-aligned).
template <typename T>
__device__ __forceinline__ int64_t to_boundary(const T* p) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(p) % 16);
  return mis ? (16 - mis) / (int)sizeof(T) : 0;
}

template <typename T>
__global__ void quantize_codes_kernel(const T* __restrict__ x, int64_t n,
                                      int64_t n_out,
                                      const float* __restrict__ scale,
                                      float a, int* __restrict__ codes) {
  constexpr int kVec = 16 / sizeof(T);
  const float s = floored(__ldg(scale));
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  // x[head, body_end) in whole 16-byte vectors, two in flight per thread
  const int64_t lead = to_boundary(x);
  const int64_t head = lead < n ? lead : n;
  const int64_t n_vec = (n - head) / kVec;
  const int64_t body_end = head + n_vec * kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  int* cv = codes + head;
  const bool aligned = to_boundary(cv) == 0;
  for (int64_t i = tid; i < n_vec; i += 2 * stride) {
    const bool two = i + stride < n_vec;
    const uint4 r0 = xv[i];
    uint4 r1 = make_uint4(0, 0, 0, 0);
    if (two) r1 = xv[i + stride];
    int c[kVec];
    vector_codes(r0, s, a, c, T());
    store_codes<kVec>(cv + i * kVec, c, aligned);
    if (two) {
      vector_codes(r1, s, a, c, T());
      store_codes<kVec>(cv + (i + stride) * kVec, c, aligned);
    }
  }
  // the head [0, head) and the tail [body_end, n), one element each
  const int64_t n_edge = head + (n - body_end);
  for (int64_t i = tid; i < n_edge; i += stride) {
    const int64_t e = i < head ? i : body_end + (i - head);
    codes[e] = code_of(load_f32(x, e), s, a);
  }
  // zero codes of [n, n_out): int4 over [z0, z1), one by one around it
  const int64_t z_start = n + to_boundary(codes + n);
  const int64_t z0 = z_start < n_out ? z_start : n_out;
  const int64_t z1 = z0 + (n_out - z0) / 4 * 4;
  int4* zv = reinterpret_cast<int4*>(codes + z0);
  for (int64_t i = tid; i < (z1 - z0) / 4; i += stride)
    zv[i] = make_int4(0, 0, 0, 0);
  const int64_t n_zedge = (z0 - n) + (n_out - z1);
  for (int64_t i = tid; i < n_zedge; i += stride)
    codes[i < z0 - n ? n + i : z1 + (i - (z0 - n))] = 0;
}

__global__ void dequantize_codes_kernel(const int* __restrict__ codes,
                                        int64_t n,
                                        const float* __restrict__ scale,
                                        float inv_a, float* __restrict__ out) {
  const float step = __fmul_rn(__ldg(scale), inv_a);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  // codes[head, body_end) in whole int4 vectors, two in flight per thread
  const int64_t lead = to_boundary(codes);
  const int64_t head = lead < n ? lead : n;
  const int64_t n_vec = (n - head) / 4;
  const int64_t body_end = head + n_vec * 4;
  const int4* cv = reinterpret_cast<const int4*>(codes + head);
  float* ov = out + head;
  const bool aligned = to_boundary(ov) == 0;
  for (int64_t i = tid; i < n_vec; i += 2 * stride) {
    const bool two = i + stride < n_vec;
    const int4 r0 = cv[i];
    int4 r1 = make_int4(0, 0, 0, 0);
    if (two) r1 = cv[i + stride];
    store_vector(ov + i * 4, vector_dequant(r0, step), aligned);
    if (two) {
      store_vector(ov + (i + stride) * 4, vector_dequant(r1, step), aligned);
    }
  }
  // the head [0, head) and the tail [body_end, n), one element each
  const int64_t n_edge = head + (n - body_end);
  for (int64_t i = tid; i < n_edge; i += stride) {
    const int64_t e = i < head ? i : body_end + (i - head);
    out[e] = __fmul_rn(__int2float_rn(codes[e]), step);
  }
}

template <typename T>
__global__ void quantize_dequantize_kernel(const T* __restrict__ x, int64_t n,
                                           const float* __restrict__ scale,
                                           float a, float inv_a,
                                           T* __restrict__ out) {
  constexpr int kVec = 16 / sizeof(T);
  const float s = floored(__ldg(scale));
  const float step = __fmul_rn(s, inv_a);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  // x[head, body_end) in whole 16-byte vectors, two in flight per thread
  const int64_t lead = to_boundary(x);
  const int64_t head = lead < n ? lead : n;
  const int64_t n_vec = (n - head) / kVec;
  const int64_t body_end = head + n_vec * kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  T* ov = out + head;
  const bool aligned = to_boundary(ov) == 0;
  for (int64_t i = tid; i < n_vec; i += 2 * stride) {
    const bool two = i + stride < n_vec;
    const uint4 r0 = xv[i];
    uint4 r1 = make_uint4(0, 0, 0, 0);
    if (two) r1 = xv[i + stride];
    store_vector(ov + i * kVec, vector_qdq(r0, s, a, step, T()), aligned);
    if (two) {
      store_vector(ov + (i + stride) * kVec, vector_qdq(r1, s, a, step, T()),
                   aligned);
    }
  }
  // the head [0, head) and the tail [body_end, n), one element each
  const int64_t n_edge = head + (n - body_end);
  for (int64_t i = tid; i < n_edge; i += stride) {
    const int64_t e = i < head ? i : body_end + (i - head);
    store(out, e, qdq_of(load_f32(x, e), s, a, step));
  }
}

// quantize_dequantize_kernel<float> that also writes each element's
// residual: one read of x, two writes.
__global__ void quantize_dequantize_residual_kernel(
    const float* __restrict__ x, int64_t n, const float* __restrict__ scale,
    float a, float inv_a, float* __restrict__ out, float* __restrict__ res) {
  const float s = floored(__ldg(scale));
  const float step = __fmul_rn(s, inv_a);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  const int64_t lead = to_boundary(x);
  const int64_t head = lead < n ? lead : n;
  const int64_t n_vec = (n - head) / 4;
  const int64_t body_end = head + n_vec * 4;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  float* ov = out + head;
  float* rv = res + head;
  const bool o_aligned = to_boundary(ov) == 0;
  const bool r_aligned = to_boundary(rv) == 0;
  for (int64_t i = tid; i < n_vec; i += 2 * stride) {
    const bool two = i + stride < n_vec;
    const uint4 r0 = xv[i];
    uint4 r1 = make_uint4(0, 0, 0, 0);
    if (two) r1 = xv[i + stride];
    uint4 q, e;
    vector_qdq_residual(r0, s, a, step, q, e);
    store_vector(ov + i * 4, q, o_aligned);
    store_vector(rv + i * 4, e, r_aligned);
    if (two) {
      vector_qdq_residual(r1, s, a, step, q, e);
      store_vector(ov + (i + stride) * 4, q, o_aligned);
      store_vector(rv + (i + stride) * 4, e, r_aligned);
    }
  }
  const int64_t n_edge = head + (n - body_end);
  for (int64_t i = tid; i < n_edge; i += stride) {
    const int64_t e = i < head ? i : body_end + (i - head);
    const float2 v = qdq_residual_of(x[e], s, a, step);
    out[e] = v.x;
    res[e] = v.y;
  }
}

// Threads the vector kernels want for n elements of x.
int64_t vector_work(int64_t n, int bf16) {
  return n / (kVectorsPerThread * (bf16 ? 8 : 4)) + 1;
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // SMs x resident blocks; grid-stride beyond
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

// out[0..5]: registers per thread, static shared bytes, dynamic shared
// bytes, local (spill) bytes per thread, threads per CTA, CTAs per SM of
// the kernel fn.
int read_attributes(const void* fn, int* out) {
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

}  // namespace

extern "C" {

// x: n float32 (bf16 = 0) or bfloat16 (bf16 = 1) values; codes: n_out int32.
int dorefa_quantize_codes(const void* x, int bf16, int64_t n, int64_t n_out,
                          const void* scale, float a, void* codes,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  int* c = static_cast<int*>(codes);
  // a thread per kVectorsPerThread vectors of x or one int4 of zero codes
  const int64_t work = vector_work(n, bf16);
  const int grid = grid_for(work > (n_out - n) / 4 ? work : (n_out - n) / 4);
  if (bf16) {
    quantize_codes_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, n_out, s, a, c);
  } else {
    quantize_codes_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, n_out, s, a, c);
  }
  return (int)cudaGetLastError();
}

// The attributes (read_attributes) of the quantize_codes kernel for
// float32 (bf16 = 0) or bfloat16 input.
int dorefa_quantize_codes_attributes(int bf16, int* out) {
  return read_attributes(
      bf16 ? reinterpret_cast<const void*>(quantize_codes_kernel<__nv_bfloat16>)
           : reinterpret_cast<const void*>(quantize_codes_kernel<float>),
      out);
}

// The same for the dequantize_codes kernel (int32 codes only).
int dorefa_dequantize_codes_attributes(int* out) {
  return read_attributes(
      reinterpret_cast<const void*>(dequantize_codes_kernel), out);
}

// The same for the quantize_dequantize kernel.
int dorefa_quantize_dequantize_attributes(int bf16, int* out) {
  return read_attributes(
      bf16 ? reinterpret_cast<const void*>(
                 quantize_dequantize_kernel<__nv_bfloat16>)
           : reinterpret_cast<const void*>(quantize_dequantize_kernel<float>),
      out);
}

// The same for the residual mode of the quantize_dequantize kernel.
int dorefa_quantize_dequantize_residual_attributes(int* out) {
  return read_attributes(
      reinterpret_cast<const void*>(quantize_dequantize_residual_kernel), out);
}

// codes: n int32; out: n float32.
int dorefa_dequantize_codes(const void* codes, int64_t n, const void* scale,
                            float inv_a, void* out, void* stream) {
  // int4 codes are 16 bytes of 4-byte elements, as float32 x's vectors
  dequantize_codes_kernel<<<grid_for(vector_work(n, 0)), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), n, static_cast<const float*>(scale),
      inv_a, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// x and out: n values of one type, float32 (bf16 = 0) or bfloat16 (bf16 = 1).
int dorefa_quantize_dequantize(const void* x, int bf16, int64_t n,
                               const void* scale, float a, float inv_a,
                               void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const int grid = grid_for(vector_work(n, bf16));
  if (bf16) {
    quantize_dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, s, a, inv_a,
        static_cast<__nv_bfloat16*>(out));
  } else {
    quantize_dequantize_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, s, a, inv_a,
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// x, out and res: n float32 values.
int dorefa_quantize_dequantize_residual(const void* x, int64_t n,
                                        const void* scale, float a,
                                        float inv_a, void* out, void* res,
                                        void* stream) {
  quantize_dequantize_residual_kernel<<<grid_for(vector_work(n, 0)), kThreads,
                                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const float*>(scale), a,
      inv_a, static_cast<float*>(out), static_cast<float*>(res));
  return (int)cudaGetLastError();
}

const char* dorefa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
