// Pieces shared by the slot-ELL kernels (ell_aggregate.cu, gat_aggregate.cu,
// gat_backward.cu): row offsets from the sorted slot rows, per-lane vectors
// of 1 or 4 floats (or 1 or 8 bfloat16 or float16 values, widened to f32), and the
// predicated gathers and streaming stores of the
// kernels that keep several row gathers in flight per lane.  Each kernel source compiles on its own into its
// own library; this header is part of every one of them.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// ptr[r] = first slot whose (clamped) row is >= r, for r in [0, num_rows].
// Rows >= num_rows (padding, or the backward's ride-over dustbin) clamp to
// num_rows, so their slots fall outside every row's range and are dropped.
__global__ void row_offsets_kernel(const int* __restrict__ row, int64_t S,
                                   int64_t num_rows, int* __restrict__ ptr) {
  int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (s > S) return;
  int64_t prev = (s == 0) ? -1 : min64(row[s - 1], num_rows);
  int64_t cur = (s == S) ? num_rows : min64(row[s], num_rows);
  for (int64_t r = prev + 1; r <= cur; ++r) ptr[r] = (int)s;
}

inline void launch_row_offsets(const int* row, int64_t S, int64_t num_rows, int* ptr,
                               cudaStream_t st) {
  row_offsets_kernel<<<(unsigned)((S + 1 + 255) / 256), 256, 0, st>>>(row, S, num_rows, ptr);
}

// ptr[i] clamped to [0, S], so no row reads past the ELL arrays
__device__ __forceinline__ int64_t slot_at(const int* ptr, int64_t i, int64_t S) {
  const int64_t s = __ldg(ptr + i);
  return s < 0 ? 0 : (s > S ? S : s);
}

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  // read-only global memory
  __device__ static T load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  // read-only global memory read once: L2 evicts it first
  __device__ static T load_once(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  // any memory the kernel also writes (shared memory)
  __device__ static T ld(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void fma(T& acc, float v, const T& t) {
    acc.x += v * t.x;
    acc.y += v * t.y;
    acc.z += v * t.z;
    acc.w += v * t.w;
  }
  __device__ static float dot(const T& a, const T& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  __device__ static void store(float* p, const T& t) { *reinterpret_cast<float4*>(p) = t; }
};

template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static T load_once(const float* p) { return __ldcs(p); }
  __device__ static T ld(const float* p) { return *p; }
  __device__ static void fma(T& acc, float v, const T& t) { acc += v * t; }
  __device__ static float dot(const T& a, const T& b) { return a * b; }
  __device__ static void store(float* p, const T& t) { *p = t; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A predicated load of a read-only row in volatile asm: issued where it
// stands, so the compiler neither sinks it into a branch nor merges it with
// its use, and several stay in flight.  When `on` is false, t keeps its value.
__device__ __forceinline__ void gather(float4& t, const float* p, bool on) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " @q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "+f"(t.x), "+f"(t.y), "+f"(t.z), "+f"(t.w)
      : "l"(p), "r"((int)on));
}
__device__ __forceinline__ void gather(float& t, const float* p, bool on) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q ld.global.nc.f32 %0, [%1];\n}\n"
      : "+f"(t)
      : "l"(p), "r"((int)on));
}

// output stores that L2 evicts first
__device__ __forceinline__ void store_streaming(float* p, float4 t) {
  __stcs(reinterpret_cast<float4*>(p), t);
}
__device__ __forceinline__ void store_streaming(float* p, float t) { __stcs(p, t); }

// ---- 16-bit rows (compute_dtype='bfloat16' or 'float16'): kernels 1, 4
// and 5 gather rows of bfloat16 or float16 values and sum them in f32.  A
// value travels as its 16 bits and becomes an f32 in registers, which is
// exact for both (bf16 by a shift, f16 by cuda_fp16.h's conversions);
// accumulators and outputs stay f32.

typedef unsigned short bf16_t;  // the bits of one bfloat16 value
// the bits of one IEEE float16 value: a type of its own, so that a kernel
// template tells the two 16-bit formats apart
enum class f16_t : unsigned short {};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t v) { return __uint_as_float((unsigned)v << 16); }
__device__ __forceinline__ float widen(f16_t v) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(v)));
}

// the two 16-bit values of a 32-bit word, widened: the lower address in the
// low half
template <typename E>
__device__ __forceinline__ float2 widen2(unsigned w);
template <>
__device__ __forceinline__ float2 widen2<bf16_t>(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
template <>
__device__ __forceinline__ float2 widen2<f16_t>(unsigned w) {
  return __half22float2(__halves2half2(__ushort_as_half((unsigned short)(w & 0xffffu)),
                                       __ushort_as_half((unsigned short)(w >> 16))));
}

// eight f32 values: a lane's share of a 16-bit row taken 16 bytes at a time
struct float8 {
  float4 lo, hi;
};

// Row<E, VEC>: a lane's VEC values of a row of E, as gathered (R) and as the
// f32 values they stand for (T, also the type of their accumulators).  For
// f32 rows both are Vec<VEC>'s; for 16-bit rows R is the raw bits: 8 values
// in one 16-byte load, or 1 where C is not a multiple of 8.
template <typename E, int VEC>
struct Row;

template <int VEC>
struct Row<float, VEC> : Vec<VEC> {
  using R = typename Vec<VEC>::T;
  __device__ static R rzero() { return Vec<VEC>::zero(); }
};

// 8 values of a 16-bit type E (bf16_t or f16_t) a lane
template <typename E>
struct Row16x8 {
  using T = float8;
  using R = uint4;
  __device__ static T zero() { return {Vec<4>::zero(), Vec<4>::zero()}; }
  __device__ static R rzero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static T wide(const R& t) {
    const float2 a = widen2<E>(t.x), b = widen2<E>(t.y), c = widen2<E>(t.z),
                 d = widen2<E>(t.w);
    return {make_float4(a.x, a.y, b.x, b.y), make_float4(c.x, c.y, d.x, d.y)};
  }
  // read-only global memory read once: L2 evicts it first
  __device__ static T load_once(const E* p) {
    return wide(__ldcs(reinterpret_cast<const uint4*>(p)));
  }
  // f32 memory the kernel also writes (its own output row)
  __device__ static T ld(const float* p) { return {Vec<4>::ld(p), Vec<4>::ld(p + 4)}; }
  __device__ static void fma(T& acc, float v, const R& t) {
    const T w = wide(t);
    Vec<4>::fma(acc.lo, v, w.lo);
    Vec<4>::fma(acc.hi, v, w.hi);
  }
  __device__ static float dot(const R& t, const T& x) {
    const T w = wide(t);
    return Vec<4>::dot(w.lo, x.lo) + Vec<4>::dot(w.hi, x.hi);
  }
  __device__ static void store(float* p, const T& t) {
    Vec<4>::store(p, t.lo);
    Vec<4>::store(p + 4, t.hi);
  }
};

// one value of a 16-bit type E a lane
template <typename E>
struct Row16x1 {
  using T = float;
  using R = E;
  __device__ static T zero() { return 0.f; }
  __device__ static R rzero() { return R{}; }
  __device__ static T load_once(const E* p) {
    return widen(static_cast<E>(__ldcs(reinterpret_cast<const unsigned short*>(p))));
  }
  __device__ static T ld(const float* p) { return *p; }
  __device__ static void fma(T& acc, float v, R t) { acc += v * widen(t); }
  __device__ static float dot(R t, T x) { return widen(t) * x; }
  __device__ static void store(float* p, T t) { *p = t; }
};

template <>
struct Row<bf16_t, 8> : Row16x8<bf16_t> {};
template <>
struct Row<f16_t, 8> : Row16x8<f16_t> {};
template <>
struct Row<bf16_t, 1> : Row16x1<bf16_t> {};
template <>
struct Row<f16_t, 1> : Row16x1<f16_t> {};

// predicated gathers of 16-bit rows, as gather() above: 8 values, or 1
__device__ __forceinline__ void gather(uint4& t, const bf16_t* p, bool on) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " @q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "+r"(t.x), "+r"(t.y), "+r"(t.z), "+r"(t.w)
      : "l"(p), "r"((int)on));
}
__device__ __forceinline__ void gather(bf16_t& t, const bf16_t* p, bool on) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q ld.global.nc.u16 %0, [%1];\n}\n"
      : "+h"(t)
      : "l"(p), "r"((int)on));
}
// float16 rows: the same loads of the same bits
__device__ __forceinline__ void gather(uint4& t, const f16_t* p, bool on) {
  gather(t, reinterpret_cast<const bf16_t*>(p), on);
}
__device__ __forceinline__ void gather(f16_t& t, const f16_t* p, bool on) {
  bf16_t b = static_cast<bf16_t>(t);
  gather(b, reinterpret_cast<const bf16_t*>(p), on);
  t = static_cast<f16_t>(b);
}

__device__ __forceinline__ void store_streaming(float* p, const float8& t) {
  store_streaming(p, t.lo);
  store_streaming(p + 4, t.hi);
}

// the type of the rows a kernel is handed, as its wrapper passes it
enum RowType { kRowF32 = 0, kRowBf16 = 1, kRowF16 = 2 };

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
