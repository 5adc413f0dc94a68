// Sorted segment sum for Hopper (sm_90a):
//
//   out[r, :] = sum over slots s with seg[s] == r of part[s, :]   (f32)
//   out_s[r]  = sum over the same slots of scal[s]                 (optional)
//
// seg is ascending; slots whose seg is >= num_rows (padding) are dropped and
// rows that own no slot come out 0.  Either channel may be absent.
//
// Replaces the TPU kernel vq_gnn_tpu/ops/pallas_segsum.py:_make_kernel
// (segment_sum_sorted).  That kernel's 8-aligned windows, one-hot MXU
// reduce, overlap refill and boundary carry work around Mosaic's tiling and
// its sequential grid; none of it is needed here.  Because seg is sorted,
// row r owns the contiguous slot range [lower_bound(r), lower_bound(r + 1)).
//
// What bounds it on the H100: device-memory bytes.  One add per input value:
// the least traffic is part, seg and (if given) scal read once and out
// written once, far below any arithmetic limit.
//
// Design:
// - a group of G threads per output row (G = 32 for C = 128, 8 for C = 32:
//   each thread owns VEC consecutive channels, float4 loads where C % 4 == 0
//   and the pointers are 16-byte aligned), so a slot's partial row is read
//   by one coalesced group access;
// - each thread finds its row's slot range by two binary searches over seg
//   (log2(S) cached loads), then adds the partials in slot order and writes
//   the row once: no atomics, the same result on every run;
// - the scalar channel is summed by the first thread of each group over the
//   same range.

#include "ell_common.cuh"

namespace {

__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ seg, int64_t S,
                                               int64_t r) {
  int64_t lo = 0, hi = S;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(seg + mid) < r) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int VEC>
__global__ void segment_sum_kernel(const float* __restrict__ part, int C,
                                   const float* __restrict__ scal,
                                   const int* __restrict__ seg, int64_t S, int64_t num_rows,
                                   int G, float* __restrict__ out, float* __restrict__ out_s) {
  using V = Vec<VEC>;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t r = t / G;
  const int g = (int)(t % G);
  if (r >= num_rows) return;
  const int64_t s0 = lower_bound(seg, S, r);
  const int64_t s1 = lower_bound(seg, S, r + 1);

  for (int c = g * VEC; c < C; c += G * VEC) {
    typename V::T acc = V::zero();
    int64_t s = s0;
    for (; s + 4 <= s1; s += 4) {  // four slots in flight
      typename V::T p0 = V::load(part + s * C + c);
      typename V::T p1 = V::load(part + (s + 1) * C + c);
      typename V::T p2 = V::load(part + (s + 2) * C + c);
      typename V::T p3 = V::load(part + (s + 3) * C + c);
      V::fma(acc, 1.f, p0);
      V::fma(acc, 1.f, p1);
      V::fma(acc, 1.f, p2);
      V::fma(acc, 1.f, p3);
    }
    for (; s < s1; ++s) V::fma(acc, 1.f, V::load(part + s * C + c));
    V::store(out + r * (int64_t)C + c, acc);
  }
  if (scal != nullptr && g == 0) {
    float acc = 0.f;
    for (int64_t s = s0; s < s1; ++s) acc += __ldg(scal + s);
    out_s[r] = acc;
  }
}

int group_size(int lanes) {
  int g = 1;
  while (g < lanes && g < 32) g *= 2;
  return g;
}

}  // namespace

// part may be null (C = 0, scalar channel only); scal may be null.
extern "C" int vq_segment_sum(const float* part, int C, const float* scal, const int* seg,
                              int64_t S, int64_t num_rows, float* out, float* out_s,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0) return (int)cudaGetLastError();
  const bool vec4 = part != nullptr && C % 4 == 0 && aligned16(part) && aligned16(out);
  const int VEC = vec4 ? 4 : 1;
  const int G = part == nullptr ? 1 : group_size((C + VEC - 1) / VEC);
  const int threads = 256;
  const unsigned blocks = (unsigned)((num_rows * G + threads - 1) / threads);
  if (part == nullptr) C = 0;
  if (vec4) {
    segment_sum_kernel<4><<<blocks, threads, 0, st>>>(part, C, scal, seg, S, num_rows, G, out,
                                                      out_s);
  } else {
    segment_sum_kernel<1><<<blocks, threads, 0, st>>>(part, C, scal, seg, S, num_rows, G, out,
                                                      out_s);
  }
  return (int)cudaGetLastError();
}
