// Pieces shared by the slot-ELL kernels (ell_aggregate.cu, gat_aggregate.cu,
// gat_backward.cu): row offsets from the sorted slot rows, per-lane vectors
// of 1 or 4 floats, and the predicated gathers and streaming stores of the
// kernels that keep several row gathers in flight per lane.  Each kernel source compiles on its own into its
// own library; this header is part of every one of them.
#pragma once

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

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
